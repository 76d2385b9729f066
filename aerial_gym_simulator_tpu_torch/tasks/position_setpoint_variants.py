"""Position-setpoint task variants: sim2real, acceleration, end-to-end, px4,
reconfigurable, morphy.

Counterpart of ``aerial_gym_simulator_tpu/tasks/position_setpoint_variants.py``:

  position_setpoint_task_sim2real          lmf2 + velocity controller, noisy
                                           17-d obs, progress and yaw rewards
  position_setpoint_task_acceleration_sim2real
                                           lmf2 + acceleration controller,
                                           vehicle-frame action penalties
  position_setpoint_task_sim2real_end_to_end
                                           tinyprop, motor thrust commands,
                                           15-d rot6d obs, progress reward
  position_setpoint_task_sim2real_px4      x500, motor thrust commands
  position_setpoint_task_reconfigurable    snakey6, motor thrusts + joint
                                           velocity targets, joint-state obs
  position_setpoint_task_morphy            morphy, motor thrusts, passive
                                           arm joint-state obs and penalties

``variant_task_step`` composes the whole RL step (action scaling, sim,
reward, masked reset, noisy observation) from tensor code on the sim's
device and reads nothing back to the host. The observation noise is four
standard-normal (N, 3) draws per step from the carry's own generator
(``sample_variant_draws``); a caller may pass its own ``VariantDraws``.
The reconfigurable and morphy observations are exact and draw nothing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch

from ..control.controllers import compute_robot_obs
from ..sim import dynamics
from ..sim.sim_builder import SimBuilder
from ..sim.structs import SimParams, SimState, replace
from ..utils.env_rng import env_randn, set_shard
from ..utils.math import (
    exp_func,
    exp_penalty_func,
    get_euler_xyz_tensor,
    interpolate_ratio,
    quat_apply_inverse,
    quat_axis,
    quat_from_euler_xyz_tensor,
    quat_rotate,
    quat_to_rotation_matrix,
    safe_norm,
    ssa,
)
from .base_task import BaseTask

VARIANTS = ("sim2real", "acceleration_sim2real", "end_to_end", "px4", "reconfigurable",
            "morphy")


def abs_exp_func(x, gain, exp):
    """gain * e^(-exp * |x|)."""
    return gain * torch.exp(-exp * torch.abs(x))


def abs_exp_penalty_func(x, gain, exp):
    return gain * (torch.exp(-exp * torch.abs(x)) - 1.0)


def matrix_to_rotation_6d(m):
    """The first two rows of R, flattened (the end-to-end and px4 tasks'
    orientation encoding)."""
    return m[..., :2, :].reshape(m.shape[:-2] + (6,))


@dataclass
class VariantTaskConfig:
    variant: str = "sim2real"
    seed: int = 1
    sim_name: str = "base_sim"
    env_name: str = "empty_env"
    robot_name: str = "lmf2"
    controller_name: str = "lmf2_velocity_control"
    args: dict = field(default_factory=dict)
    num_envs: int = 16
    use_warp: bool = False
    headless: bool = True
    device: Optional[str] = None          # None: CUDA; "cpu" must be asked for
    observation_space_dim: int = 17
    privileged_observation_space_dim: int = 0
    action_space_dim: int = 4
    episode_len_steps: int = 800
    return_state_before_reset: bool = False
    crash_dist: float = 10.0
    # per-action limits (motor-command variants); empty: the action is
    # used as it is. The end-to-end and px4 variants map the policy's
    # [-1, 1] onto them, the reconfigurable and morphy variants a [0, 1]
    # ratio
    action_limit_min: Tuple[float, ...] = ()
    action_limit_max: Tuple[float, ...] = ()
    num_motors: int = 4
    num_joints: int = 0


def Sim2RealConfig() -> VariantTaskConfig:
    return VariantTaskConfig(
        variant="sim2real", robot_name="lmf2",
        controller_name="lmf2_velocity_control", num_envs=16,
        observation_space_dim=17, action_space_dim=4, episode_len_steps=800,
        crash_dist=10.0)


def AccelerationSim2RealConfig() -> VariantTaskConfig:
    return VariantTaskConfig(
        variant="acceleration_sim2real", robot_name="lmf2",
        controller_name="lmf2_acceleration_control", num_envs=16,
        observation_space_dim=17, action_space_dim=4, episode_len_steps=800,
        crash_dist=10.0)


def EndToEndConfig() -> VariantTaskConfig:
    # seed 56: the source's training config for this task
    return VariantTaskConfig(
        variant="end_to_end", seed=56, robot_name="tinyprop",
        controller_name="no_control", num_envs=4096,
        observation_space_dim=15, action_space_dim=4, episode_len_steps=600,
        crash_dist=1.5,
        action_limit_min=(0.2,) * 4, action_limit_max=(1.2,) * 4)


def Px4Config() -> VariantTaskConfig:
    return VariantTaskConfig(
        variant="px4", seed=56, robot_name="x500", controller_name="no_control",
        num_envs=24, observation_space_dim=15, action_space_dim=4,
        episode_len_steps=500, crash_dist=6.5,
        action_limit_min=(0.0,) * 4, action_limit_max=(8.0,) * 4)


def ReconfigurableConfig() -> VariantTaskConfig:
    # the joint range's limits run from +1 down to -1: a ratio of 0 is a
    # +1 rad/s target (the source's order, kept)
    nm, nj = 6, 10
    return VariantTaskConfig(
        variant="reconfigurable", sim_name="base_sim_2ms",
        env_name="empty_env_2ms", robot_name="snakey6",
        controller_name="no_control", num_envs=1024,
        observation_space_dim=13 + (nm + nj) + 2 * nj,
        action_space_dim=nm + nj, episode_len_steps=500, crash_dist=3.0,
        action_limit_min=tuple([0.0] * nm + [1.0] * nj),
        action_limit_max=tuple([15.0] * nm + [-1.0] * nj),
        num_motors=nm, num_joints=nj)


def MorphyConfig() -> VariantTaskConfig:
    # morphy at the 2 ms sim dt, 5 substeps per env step
    return VariantTaskConfig(
        variant="morphy", sim_name="base_sim_2ms", env_name="empty_env_2ms",
        robot_name="morphy", controller_name="no_control",
        num_envs=1024, observation_space_dim=13 + 4 + 16, action_space_dim=4,
        episode_len_steps=500, crash_dist=3.0,
        action_limit_min=(0.0,) * 4, action_limit_max=(2.0,) * 4,
        num_motors=4, num_joints=8)


# ---------------------------------------------------------------------------
# rewards
# ---------------------------------------------------------------------------


def _sim2real_reward(pos_error, prev_dist, yaw_error, linvel_b, angvel_b,
                     crashes, action, prev_action):
    dist = safe_norm(pos_error, dim=-1)
    pos_reward = (exp_func(dist, 2.0, 1.0) + exp_func(dist, 3.0, 10.0)
                  + abs_exp_func(dist, 3.0, 50.0))
    speed_reward = exp_func(safe_norm(linvel_b, dim=-1), 1.0, 3.0)
    dist_reward = (20.0 - dist) / 40.0
    action_penalty = torch.sum(abs_exp_penalty_func(action, 0.2, 4.0), dim=-1)
    action_difference_penalty = torch.sum(
        abs_exp_penalty_func(action - prev_action, 0.3, 6.0), dim=-1)
    closer_reward = 400.0 * (prev_dist - dist)
    yaw_error_reward = abs_exp_func(yaw_error, 2.0, 3.0)
    total = ((pos_reward + dist_reward
              + pos_reward * (speed_reward + action_penalty + closer_reward / 10.0))
             + action_penalty + action_difference_penalty + closer_reward
             + yaw_error_reward)
    crashes = torch.where(dist > 10.0, torch.ones_like(crashes), crashes)
    total = torch.where(crashes > 0.0, torch.full_like(total, -50.0), total)
    return total, crashes


def _acceleration_reward(pos_error, prev_dist, yaw_error, linvel_b, angvel_b,
                         crashes, action_vf, prev_action_vf):
    dist = safe_norm(pos_error, dim=-1)
    pos_reward = (exp_func(dist, 2.0, 1.0) + exp_func(dist, 3.0, 10.0)
                  + abs_exp_func(dist, 3.0, 50.0))
    close_pos_reward = exp_func(dist, 2.0, 1.0)
    speed_reward = exp_func(safe_norm(linvel_b, dim=-1), 2.0, 2.5)
    action_penalty = torch.sum(abs_exp_penalty_func(action_vf, 0.3, 4.0), dim=-1)
    action_difference_penalty = torch.sum(
        abs_exp_penalty_func(action_vf - prev_action_vf, 0.4, 6.0), dim=-1)
    closer_reward = torch.where(dist < prev_dist, 400.0 * (prev_dist - dist),
                                1200.0 * (prev_dist - dist))
    yaw_error_reward = abs_exp_func(yaw_error, 3.0, 5.0)
    total = ((pos_reward
              + pos_reward * (closer_reward / 9.0 + action_penalty / 3.0
                              + speed_reward / 1.5))
             + action_penalty + action_difference_penalty + closer_reward
             + yaw_error_reward + close_pos_reward + speed_reward * 0.2)
    crashes = torch.where(dist > 10.0, torch.ones_like(crashes), crashes)
    total = torch.where(crashes > 0.0, torch.full_like(total, -50.0), total)
    return total, crashes


def _motor_command_reward(pos_error, prev_pos_error, quat, linvel, angvel_b,
                          crashes, action, prev_action, *, z_scale,
                          hover_thrust, closer_gains, upright2, align_gains,
                          angvel_gain, act_diff, crash_dist):
    """The end-to-end and px4 rewards, which differ only in constants."""
    target_dist = safe_norm(pos_error, dim=-1)
    prev_target_dist = safe_norm(prev_pos_error, dim=-1)
    pe = torch.cat([pos_error[..., :2], pos_error[..., 2:3] * z_scale], dim=-1)
    pos_reward = (torch.sum(exp_func(pe, 10.0, 10.0), dim=-1)
                  + torch.sum(exp_func(pe, 2.0, 2.0), dim=-1))
    ups = quat_axis(quat, 2)
    tiltage = 1.0 - ups[..., 2]
    upright_reward = exp_func(tiltage, 2.5, 5.0)
    if upright2:
        upright_reward = upright_reward + exp_func(tiltage, 2.5, 2.0)
    forw = quat_axis(quat, 0)
    alignment = 1.0 - forw[..., 0]
    alignment_reward = exp_func(alignment, align_gains[0], 5.0)
    if align_gains[1] > 0.0:
        alignment_reward = alignment_reward + exp_func(alignment, align_gains[1], 2.0)
    angvel_reward = torch.sum(exp_func(angvel_b, angvel_gain, 10.0), dim=-1)
    vel_reward = torch.sum(exp_func(linvel, 1.0, 5.0), dim=-1)
    action_cost = torch.sum(exp_penalty_func(action - hover_thrust, 0.01, 10.0), dim=-1)
    closer_by = prev_target_dist - target_dist
    towards_goal = torch.where(closer_by >= 0, closer_gains[0] * closer_by,
                               closer_gains[1] * closer_by)
    action_difference_penalty = torch.sum(
        exp_penalty_func(action - prev_action, act_diff[0], act_diff[1]), dim=-1)
    reward = towards_goal + (
        pos_reward * (alignment_reward + vel_reward + angvel_reward
                      + action_difference_penalty)
        + (angvel_reward + vel_reward + upright_reward + pos_reward
           + action_cost)) / 100.0
    crashes = torch.where(target_dist > crash_dist, torch.ones_like(crashes), crashes)
    return reward, crashes


def _reconfigurable_reward(pos_error, quat, angvel_b, crashes):
    dist = safe_norm(pos_error, dim=-1)
    pos_reward = exp_func(dist, 3.0, 8.0) + exp_func(dist, 0.5, 1.0)
    dist_reward = (20.0 - dist) / 40.0
    euler = ssa(get_euler_xyz_tensor(quat))
    roll, pitch = euler[..., 0], euler[..., 1]
    up_reward = exp_func(roll, 3.0, 5.0) + exp_func(pitch, 3.0, 5.0)
    spinnage = safe_norm(angvel_b, dim=-1)
    ang_vel_reward = exp_func(spinnage, 3.0, 10.5)
    yaw_rate_special = exp_func(torch.abs(angvel_b[..., 2]), 5.0, 20.5)
    total = (pos_reward + dist_reward + yaw_rate_special
             + pos_reward * (up_reward + ang_vel_reward + yaw_rate_special))
    return _upset_crashes(total, crashes, dist, roll, pitch)


def _morphy_reward(pos_error, quat, angvel_b, joint_vels, crashes, action, prev_action):
    dist = safe_norm(pos_error, dim=-1)
    pos_reward = exp_func(dist, 4.0, 12.0) + exp_func(dist, 1.0, 3.0)
    dist_reward = (20.0 - dist) / 40.0
    ups = quat_axis(quat, 2)
    tiltage = torch.abs(1.0 - ups[..., 2])
    euler = ssa(get_euler_xyz_tensor(quat))
    roll, pitch = euler[..., 0], euler[..., 1]
    up_reward = exp_func(tiltage, 5.0, 25.0)
    spinnage = safe_norm(angvel_b, dim=-1)
    ang_vel_reward = exp_func(spinnage, 3.0, 10.5)
    action_difference = prev_action - action
    absolute_action_reward = -0.15 * torch.sum((action[..., :4] - 0.711225) ** 2, dim=-1)
    action_difference_reward = torch.sum(exp_penalty_func(action_difference, 0.2, 5.0), dim=-1)
    joint_vel_reward = torch.sum(exp_penalty_func(joint_vels, 0.30, 30.0), dim=-1)
    total = ((pos_reward + dist_reward + pos_reward * (up_reward + ang_vel_reward))
             + action_difference_reward + action_difference_reward * pos_reward
             + absolute_action_reward + joint_vel_reward)
    return _upset_crashes(total, crashes, dist, roll, pitch)


def _upset_crashes(total, crashes, dist, roll, pitch):
    """The articulated variants' crash rule (beyond 3 m, or rolled or
    pitched past 1 rad) and its -20 reward."""
    crashes = torch.where((dist > 3.0) | (torch.abs(roll) > 1.0) | (torch.abs(pitch) > 1.0),
                          torch.ones_like(crashes), crashes)
    total = torch.where(crashes > 0.0, torch.full_like(total, -20.0), total)
    return total, crashes


# per-variant constants of _motor_command_reward
_MOTOR_REWARD = {
    "end_to_end": dict(z_scale=11.0, hover_thrust=9.81 * 0.372 / 4.0,
                       closer_gains=(10.0, 15.0), upright2=False, align_gains=(6.0, 0.0),
                       angvel_gain=0.3, act_diff=(1.3, 6.0)),
    "px4": dict(z_scale=13.0, hover_thrust=9.81 * 1.6559999883174896 / 4.0,
                closer_gains=(50.0, 100.0), upright2=True, align_gains=(4.0, 2.0),
                angvel_gain=0.75, act_diff=(0.5, 6.0)),
}


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


@dataclass
class VariantCarry:
    sim: SimState
    prev_action: torch.Tensor            # (N, A) scaled action of the previous step
    rng: torch.Generator                 # draws the observation noise


@dataclass
class VariantDraws:
    """The standard-normal draws one observation packing consumes, (N, 3)
    each: noise on the Euler angles, the position error, the linear and the
    angular velocity."""
    euler: torch.Tensor
    pos: torch.Tensor
    linvel: torch.Tensor
    angvel: torch.Tensor


def sample_variant_draws(gen: torch.Generator, num_envs: int, device) -> VariantDraws:
    z = env_randn(gen, (4, num_envs, 3), dim=1, device=device)
    return VariantDraws(euler=z[0], pos=z[1], linvel=z[2], angvel=z[3])


def _check_variant(variant: str):
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")


def _scale_actions(cfg: VariantTaskConfig, raw):
    """Motor-command variants: the policy's [-1, 1] range mapped onto the
    motor limits, action 0 at mid-range (end-to-end, px4), or a [0, 1]
    ratio interpolated between the limits (reconfigurable, morphy); the
    others use the action as it is."""
    if not cfg.action_limit_min:
        return raw
    lo = torch.as_tensor(cfg.action_limit_min, dtype=torch.float32, device=raw.device)
    hi = torch.as_tensor(cfg.action_limit_max, dtype=torch.float32, device=raw.device)
    if cfg.variant in ("reconfigurable", "morphy"):
        return interpolate_ratio(lo, hi, torch.clamp(raw, 0.0, 1.0))
    a = torch.clamp(raw, -1.0, 1.0)
    return a * (hi - lo) / 2.0 + (hi + lo) / 2.0


def _vf_action(vehicle_quat, action):
    """[vehicle-frame rotation of a[0:3], a[3]]."""
    return torch.cat([quat_rotate(vehicle_quat, action[..., 0:3]), action[..., 3:4]], dim=-1)


def variant_task_step(params: SimParams, cfg: VariantTaskConfig, carry: VariantCarry,
                      raw_actions: torch.Tensor, target_position: torch.Tensor,
                      n_substeps: Optional[int] = None,
                      draws: Optional[VariantDraws] = None):
    """One RL step of a variant -> (carry, obs, reward, crashes, truncations).
    ``n_substeps`` None runs the config's mean; ``draws`` None draws the
    observation noise from the carry's generator."""
    v = cfg.variant
    _check_variant(v)
    state = carry.sim
    if draws is None and v not in ("reconfigurable", "morphy"):    # their obs is exact
        draws = sample_variant_draws(carry.rng, state.num_envs, state.device)

    action = _scale_actions(cfg, raw_actions)
    prev_pos_error = target_position - state.pos
    prev_dist = safe_norm(prev_pos_error, dim=-1)

    # the reconfigurable variant's action ends in joint velocity targets
    motor_cmd = action[..., :cfg.num_motors] if cfg.num_joints > 0 else action
    if v == "reconfigurable":
        state = replace(state, dof_vel_target=action[..., cfg.num_motors:])
    state = dynamics.env_step(params, state, motor_cmd, n_substeps)

    obs = compute_robot_obs(state.pos, state.quat, state.linvel, state.angvel)
    crashes = state.crashes
    if v == "sim2real":
        pos_err_vf = quat_apply_inverse(obs.vehicle_quat, target_position - obs.pos)
        yaw_error = -ssa(get_euler_xyz_tensor(obs.quat))[..., 2]
        reward, crashes = _sim2real_reward(
            pos_err_vf, prev_dist, yaw_error, obs.body_linvel, obs.body_angvel,
            crashes, action, carry.prev_action)
    elif v == "acceleration_sim2real":
        pos_err_b = quat_apply_inverse(obs.quat, target_position - obs.pos)
        yaw_error = -ssa(get_euler_xyz_tensor(obs.quat))[..., 2]
        reward, crashes = _acceleration_reward(
            pos_err_b, prev_dist, yaw_error, obs.body_linvel, obs.body_angvel,
            crashes, _vf_action(obs.vehicle_quat, action),
            _vf_action(obs.vehicle_quat, carry.prev_action))
    elif v == "reconfigurable":
        pos_err_vf = quat_apply_inverse(obs.vehicle_quat, target_position - obs.pos)
        reward, crashes = _reconfigurable_reward(pos_err_vf, obs.quat, obs.body_angvel, crashes)
    elif v == "morphy":
        pos_err_vf = quat_apply_inverse(obs.vehicle_quat, target_position - obs.pos)
        reward, crashes = _morphy_reward(pos_err_vf, obs.quat, obs.body_angvel, state.dof_vel,
                                         crashes, action, carry.prev_action)
    else:
        reward, crashes = _motor_command_reward(
            target_position - obs.pos, prev_pos_error, obs.quat, obs.linvel,
            obs.body_angvel, crashes, action, carry.prev_action,
            crash_dist=cfg.crash_dist, **_MOTOR_REWARD[v])

    truncations = (state.sim_steps > cfg.episode_len_steps).to(torch.float32)
    state = replace(state, crashes=crashes, truncations=truncations)
    state_pre_reset = state
    state = dynamics.post_reward_step(params, state)

    # the observation shows the post-reset state, or the pre-reset one when
    # return_state_before_reset is set
    task_obs = _pack_obs(cfg, state_pre_reset if cfg.return_state_before_reset else state,
                         action, target_position, draws)
    done = torch.maximum(crashes, truncations)
    prev_action = torch.where(done.to(torch.bool)[:, None], torch.zeros_like(action), action)
    return (VariantCarry(sim=state, prev_action=prev_action, rng=carry.rng), task_obs,
            reward, crashes, truncations)


def _pack_obs(cfg: VariantTaskConfig, state: SimState, action, target, draws: VariantDraws):
    """The variant's observation with its sensor-style noise; the
    reconfigurable and morphy variants' is exact: the 13-d state, the
    action and the joint states."""
    obs = compute_robot_obs(state.pos, state.quat, state.linvel, state.angvel)
    pos_error = target - obs.pos
    if cfg.variant in ("reconfigurable", "morphy"):
        parts = [pos_error, obs.quat, obs.body_linvel, obs.body_angvel, action]
        if cfg.num_joints > 0:
            parts += [state.dof_pos, state.dof_vel]
        return torch.cat(parts, dim=-1)
    if cfg.variant in ("sim2real", "acceleration_sim2real"):
        q = obs.quat * torch.sign(obs.quat[..., 3:4])            # canonical sign
        euler = ssa(get_euler_xyz_tensor(q))
        euler_noisy = euler + 0.02 * draws.euler
        return torch.cat([
            pos_error + 0.03 * draws.pos,
            quat_from_euler_xyz_tensor(euler_noisy),
            obs.body_linvel + 0.02 * draws.linvel,
            obs.body_angvel + 0.02 * draws.angvel,
            action,
        ], dim=-1)
    euler = ssa(get_euler_xyz_tensor(obs.quat))
    euler_noisy = euler + (math.pi / 1032.0) * draws.euler
    rot6d = matrix_to_rotation_6d(quat_to_rotation_matrix(quat_from_euler_xyz_tensor(euler_noisy)))
    return torch.cat([
        pos_error + 0.001 * draws.pos,
        rot6d,
        obs.linvel + 0.002 * draws.linvel,
        obs.body_angvel + 0.001 * draws.angvel,
    ], dim=-1)


class PositionSetpointTaskVariant(BaseTask):
    """The gym-style task shared by the six variants. Runs on CUDA unless
    ``device="cpu"`` (argument or config) asks for the CPU."""

    CONFIG = VariantTaskConfig

    def __init__(self, task_config: VariantTaskConfig, seed=None, num_envs=None,
                 headless=None, device=None, use_warp=None, shard=None):
        _check_variant(task_config.variant)
        if seed is not None:
            task_config.seed = seed
        if num_envs is not None:
            task_config.num_envs = num_envs
        if headless is not None:
            task_config.headless = headless
        if device is not None:
            task_config.device = device
        super().__init__(task_config)
        cfg = task_config
        self.sim_env = SimBuilder().build_env(
            sim_name=cfg.sim_name, env_name=cfg.env_name, robot_name=cfg.robot_name,
            controller_name=cfg.controller_name, device=cfg.device,
            num_envs=cfg.num_envs, seed=cfg.seed, shard=shard)
        self.num_envs = self.sim_env.num_envs
        self.shard = shard          # this rank's block of the env axis, or None
        self.params = self.sim_env.params
        self.device = self.sim_env.device
        self.observation_space_dim = cfg.observation_space_dim
        self.action_space_dim = cfg.action_space_dim

        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.target_position = zeros(self.num_envs, 3)
        self.actions = zeros(self.num_envs, cfg.action_space_dim)
        self.rewards = zeros(self.num_envs)
        self.terminations = zeros(self.num_envs)
        self.truncations = zeros(self.num_envs)
        self.infos: Dict = {}
        self.counter = 0
        self.task_obs = {
            "observations": zeros(self.num_envs, cfg.observation_space_dim),
            "priviliged_obs": zeros(self.num_envs, cfg.privileged_observation_space_dim),
            "collisions": zeros(self.num_envs, 1),
            "rewards": zeros(self.num_envs, 1),
        }
        self._carry: Optional[VariantCarry] = None

    # -- functional access for the PPO learner ------------------------------
    @property
    def state(self) -> SimState:
        return self.sim_env.state

    def make_step_fn(self):
        """PPO protocol: (step_fn, init_carry, init_obs) with
        step_fn(carry, action) -> (carry, obs, reward, term, trunc); the
        carry is a VariantCarry."""
        cfg = self.task_config

        def step_fn(carry, action):
            # params and targets as they are now (parallel/mesh.shard_task)
            return variant_task_step(self.params, cfg, carry, action, self.target_position,
                                     None)

        self.reset()
        return step_fn, self._carry, self.task_obs["observations"]

    def set_carry(self, carry: VariantCarry):
        self._carry = carry
        self.sim_env.state = carry.sim

    # -- gym API ------------------------------------------------------------
    def close(self):
        self.sim_env.delete_env()

    def reset(self):
        self.sim_env.reset()
        rng = torch.Generator(device=self.device)
        rng.manual_seed(self.task_config.seed ^ 0x5EED)
        zero_action = torch.zeros((self.num_envs, self.task_config.action_space_dim),
                                  device=self.device)
        self._carry = VariantCarry(sim=self.sim_env.state, prev_action=zero_action, rng=rng)
        first = torch.Generator(device=self.device)
        first.manual_seed(0)
        for g in (rng, first):          # a task on its block draws by its shard
            set_shard(g, self.shard)
        self.task_obs["observations"] = _pack_obs(
            self.task_config, self.sim_env.state, zero_action, self.target_position,
            sample_variant_draws(first, self.num_envs, self.device))
        return self.get_return_tuple()

    def reset_idx(self, env_ids):
        self.sim_env.reset_idx(env_ids)
        # keep the carry in step with the per-env reset
        if self._carry is not None:
            self._carry = replace(self._carry, sim=self.sim_env.state)

    def render(self):
        return None

    def step(self, actions):
        self.counter += 1
        self.actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        carry, task_obs, reward, term, trunc = variant_task_step(
            self.params, self.task_config, self._carry, self.actions, self.target_position,
            self.sim_env._sample_substeps())
        self.set_carry(carry)
        self.sim_env.step_counter += 1
        self.task_obs["observations"] = task_obs
        self.rewards, self.terminations, self.truncations = reward, term, trunc
        self.infos = {}
        return self.get_return_tuple()

    def get_return_tuple(self):
        return (self.task_obs, self.rewards, self.terminations, self.truncations, self.infos)
