"""LiDAR and radar navigation tasks.

Counterpart of ``aerial_gym_simulator_tpu/tasks/lidar_navigation_task.py``:
  * sensor: a 48x120 world-frame pointcloud (the dome lidar on magpie, the
    fake-radar cone on lmf2_radar), turned back into a range image,
    min-pooled (3, 6) down to 16x20, corrupted like the real sensor, and
    observed as inverse range,
  * time to collision from the velocity along each ray, fed to a penalty,
  * obs = [perturbed unit vector to the goal, distance, perturbed
    roll/pitch, yaw error to a per-episode random target yaw, body
    velocities, previous action, 320 inverse-range pixels] (337),
  * acceleration-setpoint action transform [2 a_xyz, yaw_rate pi/3],
  * reward: position, very-close (gated by yaw alignment), velocity
    direction, stable-at-goal, action penalties, time-to-collision
    penalty, collision -10; the success/crash/timeout accounting and the
    curriculum of the camera navigation task.

The step (transform, sim, reward, curriculum, masked reset, render,
pointcloud processing, observation) runs on the sim's device and reads
nothing back. Every random number the step draws itself comes from the
sim state's generator in one place (``sample_lidar_nav_draws``); the step
takes the draws as an argument, so a test can hand it another
implementation's numbers.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..control.controllers import compute_robot_obs
from ..sensors.raycast_sensor import render_lidar
from ..sim import dynamics
from ..sim.sim_builder import SimBuilder
from ..sim.structs import SimParams, SimState, replace
from ..utils.env_rng import env_count, env_rand
from ..utils.math import interpolate_ratio, quat_rotate_inverse, safe_norm, ssa
from .base_task import BaseTask
from .navigation_task import CurriculumConfig, _constant, curriculum_update

DS_POOL = (3, 6)        # min-pool window: 48x120 -> 16x20
DS_SHAPE = (16, 20)
LOW_ROWS = 10           # the lidar's low-range corruption hits rows 10-15 of 16


@dataclass
class LidarNavigationTaskConfig:
    seed: int = 1
    sim_name: str = "base_sim"
    env_name: str = "env_with_lidar_nav_obstacles"
    robot_name: str = "magpie"
    controller_name: str = "magpie_acceleration_control"
    args: dict = field(default_factory=dict)
    num_envs: int = 512
    use_warp: bool = True
    headless: bool = True
    device: Optional[str] = None          # None: CUDA; "cpu" must be asked for
    observation_space_dim: int = 13 + 4 + DS_SHAPE[0] * DS_SHAPE[1]
    privileged_observation_space_dim: int = 0
    action_space_dim: int = 4
    episode_len_steps: int = 110
    return_state_before_reset: bool = False
    target_min_ratio: Tuple[float, float, float] = (0.90, 0.15, 0.15)
    target_max_ratio: Tuple[float, float, float] = (0.92, 0.80, 0.80)
    max_yawrate: float = math.pi / 3.0
    success_distance: float = 1.0
    # the radar task: sparse returns, radar_invalid_prob of the pooled
    # returns invalid (-1) each frame. With radar_invalid_anneal_env_steps
    # > 0 the share ramps from radar_invalid_prob_start to
    # radar_invalid_prob over that many env steps (a training aid; the
    # task ends at radar_invalid_prob)
    radar_mode: bool = False
    radar_invalid_prob: float = 0.8
    radar_invalid_prob_start: float = 0.2
    radar_invalid_anneal_env_steps: int = 0
    curriculum: CurriculumConfig = field(default_factory=lambda: CurriculumConfig(
        min_level=25, max_level=70, check_after_log_instances=2048,
        increase_step=2, decrease_step=1,
        success_rate_for_increase=0.7, success_rate_for_decrease=0.6))
    reward_parameters: dict = field(default_factory=lambda: {
        "pos_reward_magnitude": 3.0,
        "pos_reward_exponent": 1.0,
        "very_close_to_goal_reward_magnitude": 5.0,
        "very_close_to_goal_reward_exponent": 8.0,
        "vel_direction_component_reward_magnitude": 1.0,
        "x_action_diff_penalty_magnitude": 0.3,
        "x_action_diff_penalty_exponent": 5.0,
        "y_action_diff_penalty_magnitude": 0.3,
        "y_action_diff_penalty_exponent": 5.0,
        "z_action_diff_penalty_magnitude": 0.3,
        "z_action_diff_penalty_exponent": 5.0,
        "yawrate_action_diff_penalty_magnitude": 0.3,
        "yawrate_action_diff_penalty_exponent": 5.0,
        "x_absolute_action_penalty_magnitude": 0.1,
        "x_absolute_action_penalty_exponent": 0.3,
        "y_absolute_action_penalty_magnitude": 0.1,
        "y_absolute_action_penalty_exponent": 0.3,
        "z_absolute_action_penalty_magnitude": 0.15,
        "z_absolute_action_penalty_exponent": 1.0,
        "yawrate_absolute_action_penalty_magnitude": 0.15,
        "yawrate_absolute_action_penalty_exponent": 2.0,
        "collision_penalty": -10.0,
    })


def RadarNavigationTaskConfig() -> LidarNavigationTaskConfig:
    """The radar task: lmf2_radar in env_with_obstacles, sparse returns."""
    cfg = LidarNavigationTaskConfig()
    cfg.env_name = "env_with_obstacles"
    cfg.robot_name = "lmf2_radar"
    cfg.controller_name = "lmf2_acceleration_control"
    cfg.radar_mode = True
    return cfg


@dataclass
class LidarNavState:
    sim: SimState
    target_position: torch.Tensor       # (N, 3)
    target_yaw: torch.Tensor            # (N,)
    pos_error_prev: torch.Tensor        # (N, 3) vehicle frame
    prev_action: torch.Tensor           # (N, 4) transformed
    lidar_obs: torch.Tensor             # (N, 320) inverse range
    ttc: torch.Tensor                   # (N,) time to collision
    env_steps: torch.Tensor             # 0-d f32: env steps taken so far
    curriculum_level: torch.Tensor      # 0-d f32
    success_agg: torch.Tensor           # 0-d f32
    crash_agg: torch.Tensor
    timeout_agg: torch.Tensor

    @property
    def rng(self) -> torch.Generator:
        """The task draws from the sim state's generator."""
        return self.sim.rng


@dataclass
class LidarNavDraws:
    """The random numbers one step consumes itself, all uniform in [0, 1)."""
    obs_perturb: torch.Tensor           # (N, 3) goal-vector jitter
    euler_perturb: torch.Tensor         # (N, 3) roll/pitch jitter
    target_ratio: torch.Tensor          # (N, 3) fresh targets
    target_yaw: torch.Tensor            # (N,) fresh target yaws
    noise: torch.Tensor                 # (N, 16, 20) < 0.03: additive noise here
    noise_value: torch.Tensor           # (N, 16, 20) -> its value in [0.2, 10)
    drop: torch.Tensor                  # (N, 16, 20) radar: invalid; lidar < 0.02: max range
    low: torch.Tensor                   # (N, 6, 20) lidar, lower rows < 0.02: a low range
    low_value: torch.Tensor             # (N, 6, 20) -> its value in [0.2, 1)


def sample_lidar_nav_draws(gen: torch.Generator, num_envs: int, device) -> LidarNavDraws:
    H, W = DS_SHAPE
    L = (H - LOW_ROWS) * W
    u = env_rand(gen, (num_envs, 10 + 3 * H * W + 2 * L), device=device)
    grid = lambda a, rows: u[:, a:a + rows * W].reshape(num_envs, rows, W)
    p = 10
    return LidarNavDraws(
        obs_perturb=u[:, 0:3], euler_perturb=u[:, 3:6], target_ratio=u[:, 6:9],
        target_yaw=u[:, 9], noise=grid(p, H), noise_value=grid(p + H * W, H),
        drop=grid(p + 2 * H * W, H), low=grid(p + 3 * H * W, H - LOW_ROWS),
        low_value=grid(p + 3 * H * W + L, H - LOW_ROWS))


def _uniform(u, lo: float, hi: float):
    """A unit uniform mapped to [lo, hi), in the JAX package's order."""
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def action_transform(cfg: LidarNavigationTaskConfig, raw: torch.Tensor) -> torch.Tensor:
    """Policy output in [-1, 1]^4 -> [ax, ay, az, yaw_rate]."""
    a = torch.clamp(raw, -1.0, 1.0)
    return torch.cat([2.0 * a[..., 0:3], a[..., 3:4] * cfg.max_yawrate], dim=-1)


def _erf(mag, exp, v):
    return mag * torch.exp(-(v * v) * exp)


def _epf(mag, exp, v):
    return mag * (torch.exp(-(v * v) * exp) - 1.0)


def process_pointcloud(cfg: LidarNavigationTaskConfig, robot_pos, linvel, pts,
                       draws: LidarNavDraws, invalid_prob=None):
    """World pointcloud (N, H, W, 3) -> (inverse-range 16x20 observation
    (N, 320), time to collision (N,)). ``invalid_prob`` (a float or a 0-d
    tensor) replaces cfg.radar_invalid_prob."""
    N = pts.shape[0]
    dirs = pts - robot_pos[:, None, None, :]
    rng_img = safe_norm(dirs, dim=-1)                     # (N, 48, 120)
    rng_flat = rng_img.reshape(N, -1)
    unit_dir = dirs.reshape(N, -1, 3) / (rng_flat[..., None] + 1e-6)
    ten = torch.full_like(rng_img, 10.0)
    rng_img = torch.where(rng_img > 10.0, ten, rng_img)
    rng_img = torch.where(rng_img < 0.2, ten, rng_img)

    # time to collision: the range along each ray over the closing speed
    vel_along = torch.sum(linvel[:, None, :] * unit_dir, dim=-1)
    ttc_all = torch.where(vel_along > 0, rng_flat / (vel_along + 1e-6),
                          torch.full_like(rng_flat, 10.0))
    ttc = torch.clamp(torch.min(ttc_all, dim=-1).values, 0.0, 10.0)

    ds = -F.max_pool2d(-rng_img[:, None], DS_POOL, stride=DS_POOL)[:, 0]    # (N, 16, 20)
    ds = ds + (draws.noise < 0.03).to(ds.dtype) * _uniform(draws.noise_value, 0.2, 10.0)
    if cfg.radar_mode:
        p = cfg.radar_invalid_prob if invalid_prob is None else invalid_prob
        ds = torch.where(draws.drop < p, torch.full_like(ds, -1.0), ds)
    else:
        ds = torch.where(draws.drop < 0.02, torch.full_like(ds, 10.0), ds)
        low = ds[:, LOW_ROWS:]
        low = torch.where(draws.low < 0.02, _uniform(draws.low_value, 0.2, 1.0), low)
        ds = torch.cat([ds[:, :LOW_ROWS], low], dim=1)
    return (1.0 / ds).reshape(N, -1), ttc


def compute_reward(rp: dict, pos_error, prev_pos_error, vehicle_linvel, body_angvel,
                   yaw_error, crashes, action, prev_action, ttc,
                   curriculum_progress) -> torch.Tensor:
    mult = 1.0 + 2.0 * curriculum_progress
    dist = safe_norm(pos_error, dim=-1)
    pos_reward = _erf(rp["pos_reward_magnitude"], rp["pos_reward_exponent"], dist)
    very_close = _erf(rp["very_close_to_goal_reward_magnitude"],
                      rp["very_close_to_goal_reward_exponent"], dist)

    vel_norm = safe_norm(vehicle_linvel, dim=-1)
    vel_dir = vehicle_linvel / (vel_norm[..., None] + 1e-6)
    unit_to_goal = pos_error / (dist[..., None] + 1e-6)
    reasonable_vel = _erf(2.0, 2.0, vel_norm - 2.0)
    vel_dir_component = torch.sum(vel_dir * unit_to_goal, dim=-1)
    vel_dir_reward = torch.where(
        vel_dir_component > 0,
        rp["vel_direction_component_reward_magnitude"] * vel_dir_component * reasonable_vel,
        torch.full_like(vel_dir_component, -0.2)) * torch.clamp(dist / 3.0, max=1.0)

    vel_mag_penalty = _epf(2.0, 2.0, torch.clamp(vel_norm - 3.0, min=0.0))
    close_to_goal = 1.0 - _erf(1.0, 2.0, dist)
    neg_x_vel_penalty = _epf(2.0, 8.0, torch.clamp(vehicle_linvel[..., 0], min=0.0)) * close_to_goal
    vel_penalty = vel_mag_penalty + neg_x_vel_penalty

    low_vel_reward = _erf(1.5, 10.0, vel_norm) + _erf(1.5, 0.5, vel_norm)
    correct_yaw_reward = _erf(2.0, 0.2, yaw_error) + _erf(4.0, 15.0, yaw_error)
    alignment_factor = _erf(1.0, 2.0, yaw_error)
    low_angvel_reward = _erf(1.5, 5.0, body_angvel[..., 2]) * alignment_factor
    stable_at_goal = torch.where(dist < 1.0,
                                 low_vel_reward + correct_yaw_reward + low_angvel_reward,
                                 torch.zeros_like(dist))

    dist_from_goal_reward = (20.0 - dist) / 20.0

    ad = action - prev_action
    diff_pen = sum(_epf(rp[f"{k}_action_diff_penalty_magnitude"],
                        rp[f"{k}_action_diff_penalty_exponent"], ad[..., i])
                   for i, k in enumerate(("x", "y", "z", "yawrate")))
    abs_pen = curriculum_progress * sum(
        _epf(rp[f"{k}_absolute_action_penalty_magnitude"],
             rp[f"{k}_absolute_action_penalty_exponent"], action[..., i])
        for i, k in enumerate(("x", "y", "z", "yawrate")))

    ttc_penalty = _erf(-3.0, 2.0, ttc * ttc)

    reward = mult * (pos_reward + very_close * alignment_factor + vel_dir_reward
                     + dist_from_goal_reward + stable_at_goal + vel_penalty + diff_pen
                     + abs_pen + ttc_penalty)
    return torch.where(crashes > 0, torch.full_like(reward, rp["collision_penalty"]), reward)


def sample_targets(cfg: LidarNavigationTaskConfig, sim: SimState, u_ratio: torch.Tensor,
                   u_yaw: torch.Tensor):
    """Targets inside the env bounds and target yaws in [-pi, pi) from
    unit uniforms u_ratio (N, 3) and u_yaw (N,)."""
    lo = _constant(tuple(cfg.target_min_ratio), u_ratio.device)
    hi = _constant(tuple(cfg.target_max_ratio), u_ratio.device)
    target = interpolate_ratio(sim.bounds_lo, sim.bounds_hi, lo + (hi - lo) * u_ratio)
    return target, _uniform(u_yaw, -math.pi, math.pi)


def make_lidar_nav_step(params: SimParams, cfg: LidarNavigationTaskConfig):
    """-> step(ns, raw_actions, draws=None) -> (LidarNavState, obs (N, 337),
    reward, crashes, truncations, infos). ``draws`` None draws from the
    state's generator."""
    cur, rp = cfg.curriculum, cfg.reward_parameters

    def step(ns: LidarNavState, raw_actions: torch.Tensor,
             draws: Optional[LidarNavDraws] = None):
        N = ns.sim.num_envs
        if draws is None:
            draws = sample_lidar_nav_draws(ns.rng, N, ns.sim.device)
        action = action_transform(cfg, raw_actions)
        sim = dynamics.env_step(params, ns.sim, action)

        obs = compute_robot_obs(sim.pos, sim.quat, sim.linvel, sim.angvel)
        pos_error = quat_rotate_inverse(obs.vehicle_quat, ns.target_position - obs.pos)
        yaw_error = ssa(ns.target_yaw - obs.euler[..., 2])
        progress = (ns.curriculum_level - cur.min_level) / max(cur.max_level - cur.min_level, 1)
        reward = compute_reward(rp, pos_error, ns.pos_error_prev, obs.vehicle_linvel,
                                obs.body_angvel, yaw_error, sim.crashes, action,
                                ns.prev_action, ns.ttc, progress)
        crashes = sim.crashes
        truncations = (sim.sim_steps > cfg.episode_len_steps).to(torch.float32)
        dist = safe_norm(ns.target_position - obs.pos, dim=-1)
        not_crashed = (crashes <= 0).to(torch.float32)
        successes = truncations * (dist < cfg.success_distance).to(torch.float32) * not_crashed
        timeouts = truncations * (1.0 - successes) * not_crashed

        level, s_agg, c_agg, t_agg = curriculum_update(
            cur, ns.curriculum_level, ns.success_agg, ns.crash_agg, ns.timeout_agg,
            successes, crashes, timeouts, ns.rng)

        sim = replace(sim, crashes=crashes, truncations=truncations,
                      num_obstacles=torch.zeros_like(sim.num_obstacles) + level.to(torch.int32))
        done = torch.maximum(crashes, truncations)
        sim = dynamics.reset_envs(params, sim, done)
        done_b = done.to(torch.bool)

        fresh_target, fresh_yaw = sample_targets(cfg, sim, draws.target_ratio, draws.target_yaw)
        target = torch.where(done_b[:, None], fresh_target, ns.target_position)
        target_yaw = torch.where(done_b, fresh_yaw, ns.target_yaw)

        # render AFTER the reset, then the pointcloud's range image and TTC
        obs2 = compute_robot_obs(sim.pos, sim.quat, sim.linvel, sim.angvel)
        pts, _ = render_lidar(params, sim, gen=sim.rng, want_seg=False)
        env_steps = ns.env_steps + float(env_count(ns.rng, N))
        invalid_prob = None
        if cfg.radar_mode and cfg.radar_invalid_anneal_env_steps > 0:
            frac = torch.clamp(env_steps / float(cfg.radar_invalid_anneal_env_steps), 0.0, 1.0)
            invalid_prob = (cfg.radar_invalid_prob_start
                            + (cfg.radar_invalid_prob - cfg.radar_invalid_prob_start) * frac)
        lidar_obs, ttc = process_pointcloud(cfg, obs2.pos, obs2.linvel, pts, draws,
                                            invalid_prob)

        if cfg.return_state_before_reset:
            # the observation shows the state BEFORE the reset, with the
            # range image of the previous step
            pack_obs, pack_target, pack_yaw = obs, ns.target_position, ns.target_yaw
            pack_lidar = ns.lidar_obs
        else:
            pack_obs, pack_target, pack_yaw = obs2, target, target_yaw
            pack_lidar = lidar_obs
        vec_to_tgt = quat_rotate_inverse(pack_obs.vehicle_quat, pack_target - pack_obs.pos)
        dist_to_tgt = safe_norm(vec_to_tgt, dim=-1, keepdim=True)
        unit_vec = (vec_to_tgt + 0.2 * (draws.obs_perturb - 0.5)) / torch.clamp(dist_to_tgt,
                                                                                min=1e-6)
        euler = ssa(pack_obs.euler)
        e_pert = euler + 0.1 * (draws.euler_perturb - 0.5)
        task_obs = torch.cat([
            unit_vec, dist_to_tgt,
            e_pert[..., 0:1], e_pert[..., 1:2],
            ssa(pack_yaw - euler[..., 2])[..., None],
            pack_obs.body_linvel, pack_obs.body_angvel,
            action,
            pack_lidar,
        ], dim=-1)

        ns = LidarNavState(
            sim=sim, target_position=target, target_yaw=target_yaw,
            pos_error_prev=quat_rotate_inverse(obs2.vehicle_quat, target - obs2.pos),
            prev_action=torch.where(done_b[:, None], torch.zeros_like(action), action),
            lidar_obs=lidar_obs, ttc=ttc, env_steps=env_steps, curriculum_level=level,
            success_agg=s_agg, crash_agg=c_agg, timeout_agg=t_agg)
        infos = {"successes": successes, "timeouts": timeouts, "crashes": crashes,
                 "curriculum_level": level}
        return ns, task_obs, reward, crashes, truncations, infos

    return step


class LiDARNavigationTask(BaseTask):
    """``task_registry.make_task("lidar_navigation_task", ...)``. Runs on
    CUDA unless ``device="cpu"`` (argument or config) asks for the CPU."""

    def __init__(self, task_config: LidarNavigationTaskConfig, seed=None, num_envs=None,
                 headless=None, device=None, use_warp=None, shard=None):
        if seed is not None:
            task_config.seed = seed
        if num_envs is not None:
            task_config.num_envs = num_envs
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
        if self.params.lidar is None:
            raise ValueError(f"robot '{cfg.robot_name}' has no lidar sensor")
        if self.params.scene is not None:
            cfg.curriculum.max_level = min(cfg.curriculum.max_level,
                                           self.params.scene.num_assets)

        self._step = make_lidar_nav_step(self.params, cfg)
        self.nav_state = self._initial_state()
        self.observation_space_dim = cfg.observation_space_dim
        self.action_space_dim = cfg.action_space_dim
        self.infos: Dict = {}
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.task_obs = {"observations": zeros(self.num_envs, cfg.observation_space_dim)}
        self.rewards = zeros(self.num_envs)
        self.terminations = zeros(self.num_envs)
        self.truncations = zeros(self.num_envs)

    def _initial_state(self) -> LidarNavState:
        cfg = self.task_config
        dev, N = self.device, self.num_envs
        sim = replace(self.sim_env.state, num_obstacles=torch.full(
            (N,), cfg.curriculum.min_level, dtype=torch.int32, device=dev))
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        u = env_rand(sim.rng, (N, 4), device=dev)
        target, yaw = sample_targets(cfg, sim, u[:, :3], u[:, 3])
        return LidarNavState(
            sim=sim, target_position=target, target_yaw=yaw,
            pos_error_prev=zeros(N, 3), prev_action=zeros(N, 4),
            lidar_obs=zeros(N, cfg.observation_space_dim - 17),
            ttc=torch.full((N,), 10.0, device=dev), env_steps=zeros(),
            curriculum_level=torch.tensor(float(cfg.curriculum.min_level), device=dev),
            success_agg=zeros(), crash_agg=zeros(), timeout_agg=zeros())

    @property
    def state(self) -> SimState:
        return self.nav_state.sim

    def close(self):
        self.sim_env.delete_env()

    def reset(self):
        self.sim_env.state = self.nav_state.sim
        self.sim_env.reset()
        self.nav_state = dataclasses.replace(self.nav_state, sim=self.sim_env.state)
        return self.get_return_tuple()

    def reset_idx(self, env_ids):
        self.sim_env.state = self.nav_state.sim
        self.sim_env.reset_idx(env_ids)
        self.nav_state = dataclasses.replace(self.nav_state, sim=self.sim_env.state)

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.device)
        (self.nav_state, task_obs, reward, term, trunc,
         infos) = self._step(self.nav_state, actions)
        self.sim_env.state = self.nav_state.sim
        self.task_obs["observations"] = task_obs
        self.rewards, self.terminations, self.truncations = reward, term, trunc
        self.infos = infos
        return self.get_return_tuple()

    def get_return_tuple(self):
        return (self.task_obs, self.rewards, self.terminations, self.truncations, self.infos)

    def make_step_fn(self):
        """PPO protocol: (step_fn, init_carry, init_obs); the carry is the
        LidarNavState."""
        step = self._step

        def step_fn(ns, action):
            ns, obs, reward, term, trunc, _ = step(ns, action)
            return ns, obs, reward, term, trunc

        zero_obs = torch.zeros((self.num_envs, self.task_config.observation_space_dim),
                               device=self.device)
        return step_fn, self.nav_state, zero_obs

    def set_carry(self, carry: LidarNavState):
        self.nav_state = carry
        self.sim_env.state = carry.sim


class RadarNavigationTask(LiDARNavigationTask):
    """The same task with the fake-radar cone on lmf2_radar and sparse
    returns (``RadarNavigationTaskConfig``)."""
