"""Position setpoint task: hover to the origin from state-only observations.

Counterpart of ``aerial_gym_simulator_tpu/tasks/position_setpoint_task.py``:
13-d observation [position error, quaternion, body linear velocity, body
angular velocity], exponential position rewards with uprightness and
anti-spin shaping, crash beyond ``crash_dist_threshold`` metres, truncation
after ``episode_len_steps``. ``task_step`` composes the whole RL step (sim,
reward, termination, masked reset, observation) from tensor code on the
sim's device and reads nothing back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..control.controllers import compute_robot_obs
from ..sim import dynamics
from ..sim.sim_builder import SimBuilder
from ..sim.structs import SimParams, SimState, replace
from ..utils.math import exp_func, quat_axis, quat_rotate_inverse, safe_norm
from .base_task import BaseTask


@dataclass
class PositionSetpointTaskConfig:
    seed: int = 1
    sim_name: str = "base_sim"
    env_name: str = "empty_env"
    robot_name: str = "base_quadrotor"
    controller_name: str = "lee_attitude_control"
    args: dict = field(default_factory=dict)
    num_envs: int = 4096
    use_warp: bool = False
    headless: bool = True
    device: Optional[str] = None          # None: CUDA; "cpu" must be asked for
    observation_space_dim: int = 13
    privileged_observation_space_dim: int = 0
    action_space_dim: int = 4
    episode_len_steps: int = 500
    return_state_before_reset: bool = False
    crash_dist_threshold: float = 8.0
    # carried for config-surface parity; the reward's shaping constants are
    # written into compute_reward
    reward_parameters: dict = field(default_factory=lambda: {
        "pos_error_gain1": [2.0, 2.0, 2.0],
        "pos_error_exp1": [1 / 3.5, 1 / 3.5, 1 / 3.5],
        "pos_error_gain2": [2.0, 2.0, 2.0],
        "pos_error_exp2": [2.0, 2.0, 2.0],
        "dist_reward_coefficient": 7.5,
        "max_dist": 15.0,
        "action_diff_penalty_gain": [1.0, 1.0, 1.0],
        "absolute_action_reward_gain": [2.0, 2.0, 2.0],
        "crash_penalty": -100,
    })


def compute_reward(pos_error, robot_quats, robot_angvels, crashes, crash_dist: float):
    """-> (reward, crashes): position terms, uprightness, anti-spin; -20 and
    a crash beyond ``crash_dist``."""
    dist = safe_norm(pos_error, dim=-1)
    pos_reward = exp_func(dist, 3.0, 8.0) + exp_func(dist, 2.0, 4.0)
    dist_reward = (20.0 - dist) / 40.0
    ups = quat_axis(robot_quats, 2)
    tiltage = torch.abs(1.0 - ups[..., 2])
    up_reward = 0.2 / (0.1 + tiltage * tiltage)
    spinnage = safe_norm(robot_angvels, dim=-1)
    ang_vel_reward = 3.0 / (1.0 + spinnage * spinnage)
    total = pos_reward + dist_reward + pos_reward * (up_reward + ang_vel_reward)
    crashes = torch.where(dist > crash_dist, torch.ones_like(crashes), crashes)
    total = torch.where(crashes > 0.0, torch.full_like(total, -20.0), total)
    return total, crashes


def _pack_obs(target_position, o):
    return torch.cat([target_position - o.pos, o.quat, o.body_linvel, o.body_angvel], dim=-1)


def task_step(params: SimParams, state: SimState, actions: torch.Tensor,
              target_position: torch.Tensor, episode_len: int, crash_dist: float,
              n_substeps: Optional[int] = None, obs_before_reset: bool = False):
    """Sim step -> reward -> termination -> masked reset -> observation;
    returns (state, obs (N, 13), reward, crashes, truncations)."""
    state = dynamics.env_step(params, state, actions, n_substeps)

    obs = compute_robot_obs(state.pos, state.quat, state.linvel, state.angvel)
    pos_err_vf = quat_rotate_inverse(obs.vehicle_quat, target_position - obs.pos)
    reward, crashes = compute_reward(pos_err_vf, obs.quat, obs.body_angvel, state.crashes,
                                     crash_dist)
    truncations = (state.sim_steps > episode_len).to(torch.float32)
    state = replace(state, crashes=crashes, truncations=truncations)

    # auto-reset AFTER the reward; by default the observation shows the
    # post-reset state, obs_before_reset packs the pre-reset one instead
    state = dynamics.post_reward_step(params, state)
    if obs_before_reset:
        task_obs = _pack_obs(target_position, obs)
    else:
        task_obs = _pack_obs(target_position, compute_robot_obs(
            state.pos, state.quat, state.linvel, state.angvel))
    return state, task_obs, reward, crashes, truncations


class PositionSetpointTask(BaseTask):
    """``task_registry.make_task("position_setpoint_task", ...)``. Runs on
    CUDA unless ``device="cpu"`` (argument or config) asks for the CPU."""

    def __init__(self, task_config: PositionSetpointTaskConfig, seed=None, num_envs=None,
                 headless=None, device=None, use_warp=None):
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
            num_envs=cfg.num_envs, seed=cfg.seed)
        self.num_envs = self.sim_env.num_envs
        self.params = self.sim_env.params
        self.device = self.sim_env.device

        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.target_position = zeros(self.num_envs, 3)
        self.actions = zeros(self.num_envs, cfg.action_space_dim)
        self.prev_actions = torch.zeros_like(self.actions)
        self.rewards = zeros(self.num_envs)
        self.terminations = zeros(self.num_envs)
        self.truncations = zeros(self.num_envs)
        self.infos: Dict = {}
        self.counter = 0
        self.observation_space_dim = cfg.observation_space_dim
        self.action_space_dim = cfg.action_space_dim
        self.task_obs = {
            "observations": zeros(self.num_envs, cfg.observation_space_dim),
            "priviliged_obs": zeros(self.num_envs, cfg.privileged_observation_space_dim),
            "collisions": zeros(self.num_envs, 1),
            "rewards": zeros(self.num_envs, 1),
        }

    # -- functional access for the PPO learner ------------------------------
    @property
    def state(self) -> SimState:
        return self.sim_env.state

    @state.setter
    def state(self, value: SimState):
        self.sim_env.state = value

    def functional_step(self, params, state, actions, n_substeps=None):
        """The step as a function of (params, state, actions)."""
        return task_step(params, state, actions, self.target_position,
                         self.task_config.episode_len_steps,
                         self.task_config.crash_dist_threshold, n_substeps)

    def make_step_fn(self):
        """PPO protocol: (step_fn, init_carry, init_obs) with
        step_fn(carry, action) -> (carry, obs, reward, term, trunc)."""
        episode_len = self.task_config.episode_len_steps
        crash_dist = self.task_config.crash_dist_threshold

        def step_fn(state, action):
            # the task's params and targets as they are now: sharding the
            # env axis (parallel/mesh.shard_task) slices them after this
            return task_step(self.params, state, action, self.target_position, episode_len,
                             crash_dist, None)

        self.reset()
        return step_fn, self.state, self.task_obs["observations"]

    def set_carry(self, carry):
        self.sim_env.state = carry

    # -- gym API ------------------------------------------------------------
    def close(self):
        self.sim_env.delete_env()

    def reset(self):
        self.target_position = torch.zeros((self.num_envs, 3), device=self.device)
        self.infos = {}
        self.sim_env.reset()
        s = self.state
        self.task_obs["observations"] = _pack_obs(
            self.target_position, compute_robot_obs(s.pos, s.quat, s.linvel, s.angvel))
        return self.get_return_tuple()

    def reset_idx(self, env_ids):
        self.sim_env.reset_idx(env_ids)

    def render(self):
        return None

    def step(self, actions):
        self.counter += 1
        self.prev_actions = self.actions
        self.actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        cfg = self.task_config
        state, task_obs, reward, term, trunc = task_step(
            self.params, self.state, self.actions, self.target_position,
            cfg.episode_len_steps, cfg.crash_dist_threshold,
            self.sim_env._sample_substeps(), bool(cfg.return_state_before_reset))
        self.sim_env.state = state
        self.sim_env.step_counter += 1
        self.task_obs["observations"] = task_obs
        self.rewards, self.terminations, self.truncations = reward, term, trunc
        self.infos = {}
        return self.get_return_tuple()

    def get_return_tuple(self):
        return (self.task_obs, self.rewards, self.terminations, self.truncations, self.infos)
