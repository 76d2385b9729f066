"""Navigation task: depth-camera obstacle navigation with a learned
perception encoder (conv VAE or ViT).

Counterpart of ``aerial_gym_simulator_tpu/tasks/navigation_task.py``:
  * obs = 17 state dims + 64 latents (perturbed unit vector to the goal,
    distance, perturbed roll/pitch, body velocities, previous transformed
    action),
  * velocity-setpoint action transform with an inclination model,
  * reward: exponential position + very-close + progress terms, action
    difference/absolute penalties, collision -100,
  * success/crash/timeout accounting and the obstacle-count curriculum,
    all on the device (0-d tensors; the step reads nothing back),
  * the camera is rendered AFTER the auto-reset, depth only, so the
    returned observation reflects the fresh state; targets are re-sampled
    for auto-reset envs inside the step.

Randomness. Everything the step draws itself comes from the sim state's
generator in one place (``sample_nav_draws``); ``nav_step`` takes the draws
as an argument, so a test can hand it another implementation's numbers.
``env_step`` (wrench disturbance), ``reset_envs`` and the sensor noise draw
from the same generator inside their own modules.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..control.controllers import compute_robot_obs
from ..sensors.raycast_sensor import render_camera
from ..sim import dynamics
from ..sim.sim_builder import SimBuilder
from ..sim.structs import SimParams, SimState, replace
from ..utils.env_rng import env_rand, env_randn, env_sums
from ..utils.math import interpolate_ratio, quat_rotate_inverse, safe_norm, ssa
from .base_task import BaseTask


@dataclass
class CurriculumConfig:
    min_level: int = 15
    # capped at the built obstacle count at construction
    max_level: int = 50
    check_after_log_instances: int = 2048
    increase_step: int = 2
    decrease_step: int = 1
    success_rate_for_increase: float = 0.7
    success_rate_for_decrease: float = 0.6


@dataclass
class NavigationTaskConfig:
    seed: int = 1
    sim_name: str = "base_sim"
    env_name: str = "env_with_obstacles"
    robot_name: str = "lmf2"
    controller_name: str = "lmf2_velocity_control"
    args: dict = field(default_factory=dict)
    num_envs: int = 1024
    use_warp: bool = True
    headless: bool = True
    device: Optional[str] = None          # None: CUDA; "cpu" must be asked for
    observation_space_dim: int = 13 + 4 + 64
    privileged_observation_space_dim: int = 0
    action_space_dim: int = 4
    episode_len_steps: int = 100
    return_state_before_reset: bool = False
    target_min_ratio: Tuple[float, float, float] = (0.90, 0.1, 0.1)
    target_max_ratio: Tuple[float, float, float] = (0.94, 0.90, 0.90)
    max_speed: float = 2.0
    max_yawrate: float = math.pi / 3.0
    max_inclination_angle: float = math.pi / 4.0
    success_distance: float = 1.0
    latent_dim: int = 64
    use_vae: bool = True
    # pickled encoder parameters: the conv VAE's raw tree, or a dict tagged
    # {"arch": "vit", ...} for the ViT encoder
    vae_params_path: Optional[str] = None
    # a .pth of the reference framework's torch VAE (utils/vae/VAE.py),
    # imported by models/torch_vae_import; takes precedence over
    # vae_params_path
    torch_vae_path: Optional[str] = None
    curriculum: CurriculumConfig = field(default_factory=CurriculumConfig)
    reward_parameters: dict = field(default_factory=lambda: {
        "pos_reward_magnitude": 5.0,
        "pos_reward_exponent": 1.0 / 3.5,
        "very_close_to_goal_reward_magnitude": 5.0,
        "very_close_to_goal_reward_exponent": 2.0,
        "getting_closer_reward_multiplier": 10.0,
        "x_action_diff_penalty_magnitude": 0.8,
        "x_action_diff_penalty_exponent": 3.333,
        "z_action_diff_penalty_magnitude": 0.8,
        "z_action_diff_penalty_exponent": 5.0,
        "yawrate_action_diff_penalty_magnitude": 0.8,
        "yawrate_action_diff_penalty_exponent": 3.33,
        "x_absolute_action_penalty_magnitude": 0.1,
        "x_absolute_action_penalty_exponent": 0.3,
        "z_absolute_action_penalty_magnitude": 1.5,
        "z_absolute_action_penalty_exponent": 1.0,
        "yawrate_absolute_action_penalty_magnitude": 1.5,
        "yawrate_absolute_action_penalty_exponent": 2.0,
        "collision_penalty": -100.0,
    })


@dataclass
class NavState:
    sim: SimState
    target_position: torch.Tensor       # (N, 3)
    pos_error_prev: torch.Tensor        # (N, 3) vehicle-frame
    prev_action: torch.Tensor           # (N, 4) transformed
    latents: torch.Tensor               # (N, latent_dim)
    curriculum_level: torch.Tensor      # 0-d f32
    success_agg: torch.Tensor           # 0-d f32
    crash_agg: torch.Tensor
    timeout_agg: torch.Tensor

    @property
    def rng(self) -> torch.Generator:
        """The task draws from the sim state's generator."""
        return self.sim.rng


@dataclass
class NavDraws:
    """The random numbers one nav_step consumes itself."""
    obs_perturb: torch.Tensor           # (N, 3) uniform [0, 1): goal-vector jitter
    euler_perturb: torch.Tensor         # (N, 3) uniform [0, 1): roll/pitch jitter
    target_ratio: torch.Tensor          # (N, 3) uniform [0, 1): fresh targets
    latent_noise: torch.Tensor          # (N, latent_dim) standard normal


def sample_nav_draws(gen: torch.Generator, num_envs: int, latent_dim: int,
                     device) -> NavDraws:
    u = env_rand(gen, (num_envs, 9), device=device)
    return NavDraws(obs_perturb=u[:, 0:3], euler_perturb=u[:, 3:6], target_ratio=u[:, 6:9],
                    latent_noise=env_randn(gen, (num_envs, latent_dim), device=device))


def action_transform(cfg: NavigationTaskConfig, raw: torch.Tensor) -> torch.Tensor:
    """Policy output in [-1, 1]^4 -> [vx, 0, vz, yaw_rate] velocity command:
    speed from a[0], inclination of the velocity from a[1], yaw rate a[2]."""
    a = torch.clamp(raw, -1.0, 1.0)
    a0 = a[..., 0] + 1.0
    vx = a0 * torch.cos(cfg.max_inclination_angle * a[..., 1]) * cfg.max_speed / 2.0
    vz = a0 * torch.sin(cfg.max_inclination_angle * a[..., 1]) * cfg.max_speed / 2.0
    yaw_rate = a[..., 2] * cfg.max_yawrate
    return torch.stack([vx, torch.zeros_like(vx), vz, yaw_rate], dim=-1)


def _exp_reward(mag, exp, v):
    return mag * torch.exp(-(v * v) * exp)


def _exp_penalty(mag, exp, v):
    return mag * (torch.exp(-(v * v) * exp) - 1.0)


def compute_reward(rp: dict, pos_error, prev_pos_error, crashes, action, prev_action,
                   curriculum_progress) -> torch.Tensor:
    mult = 1.0 + 2.0 * curriculum_progress
    dist = safe_norm(pos_error, dim=-1)
    prev_dist = safe_norm(prev_pos_error, dim=-1)
    pos_reward = _exp_reward(rp["pos_reward_magnitude"], rp["pos_reward_exponent"], dist)
    very_close = _exp_reward(rp["very_close_to_goal_reward_magnitude"],
                             rp["very_close_to_goal_reward_exponent"], dist)
    closer = prev_dist - dist
    closer_reward = torch.where(closer > 0,
                                rp["getting_closer_reward_multiplier"] * closer,
                                2.0 * rp["getting_closer_reward_multiplier"] * closer)
    dist_reward = (20.0 - dist) / 20.0
    ad = action - prev_action
    diff_pen = (_exp_penalty(rp["x_action_diff_penalty_magnitude"],
                             rp["x_action_diff_penalty_exponent"], ad[..., 0])
                + _exp_penalty(rp["z_action_diff_penalty_magnitude"],
                               rp["z_action_diff_penalty_exponent"], ad[..., 2])
                + _exp_penalty(rp["yawrate_action_diff_penalty_magnitude"],
                               rp["yawrate_action_diff_penalty_exponent"], ad[..., 3]))
    abs_pen = curriculum_progress * (
        _exp_penalty(rp["x_absolute_action_penalty_magnitude"],
                     rp["x_absolute_action_penalty_exponent"], action[..., 0])
        + _exp_penalty(rp["z_absolute_action_penalty_magnitude"],
                       rp["z_absolute_action_penalty_exponent"], action[..., 2])
        + _exp_penalty(rp["yawrate_absolute_action_penalty_magnitude"],
                       rp["yawrate_absolute_action_penalty_exponent"], action[..., 3]))
    reward = mult * (pos_reward + very_close + closer_reward + dist_reward) + diff_pen + abs_pen
    return torch.where(crashes > 0, torch.full_like(reward, rp["collision_penalty"]), reward)


def curriculum_update(cur: CurriculumConfig, level, s_agg, c_agg, t_agg,
                      successes, crashes, timeouts, rng=None):
    """Accumulate success/crash/timeout counts; once enough episode
    outcomes are logged, raise or lower the obstacle-count level by the
    success rate and reset the aggregates. All arguments and results are
    tensors (level and aggregates 0-d); nothing is read back. The counts are
    summed over every env of the run: over every shard when the state's
    generator ``rng`` is sharded (``utils/env_rng.env_sums``)."""
    n_s, n_c, n_t = env_sums(rng, successes, crashes, timeouts)
    s_agg = s_agg + n_s
    c_agg = c_agg + n_c
    t_agg = t_agg + n_t
    instances = s_agg + c_agg + t_agg
    do_update = instances >= cur.check_after_log_instances
    success_rate = s_agg / torch.clamp(instances, min=1.0)
    new_level = torch.where(success_rate > cur.success_rate_for_increase,
                            level + cur.increase_step,
                            torch.where(success_rate < cur.success_rate_for_decrease,
                                        level - cur.decrease_step, level))
    new_level = torch.clamp(new_level, cur.min_level, cur.max_level)
    level = torch.where(do_update, new_level, level)
    zero = torch.zeros_like(s_agg)
    return (level, torch.where(do_update, zero, s_agg), torch.where(do_update, zero, c_agg),
            torch.where(do_update, zero, t_agg))


@functools.lru_cache(maxsize=None)
def _constant(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    """A small config tuple as a device tensor, copied to the device once."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def sample_targets(cfg: NavigationTaskConfig, sim: SimState, u: torch.Tensor) -> torch.Tensor:
    """Targets inside the env bounds from uniform draws u (N, 3)."""
    lo = _constant(tuple(cfg.target_min_ratio), u.device)
    hi = _constant(tuple(cfg.target_max_ratio), u.device)
    return interpolate_ratio(sim.bounds_lo, sim.bounds_hi, lo + (hi - lo) * u)


def _pooled_depth_features(pixels: torch.Tensor, latent_dim: int) -> torch.Tensor:
    """Without an encoder: min-pooled depth over an 8x8 grid."""
    window = (pixels.shape[1] // 8, pixels.shape[2] // 8)
    small = -F.max_pool2d(-pixels[:, None], window, stride=window)
    return small.flatten(1)[:, :latent_dim]


def nav_step(params: SimParams, cfg: NavigationTaskConfig, vae, ns: NavState,
             raw_actions: torch.Tensor, draws: Optional[NavDraws] = None):
    """One task step -> (NavState, obs (N, 81), reward, crashes,
    truncations, infos). ``draws`` None draws from the state's generator."""
    cur, rp = cfg.curriculum, cfg.reward_parameters
    if draws is None:
        draws = sample_nav_draws(ns.rng, ns.sim.num_envs, cfg.latent_dim, ns.sim.device)
    action = action_transform(cfg, raw_actions)
    sim = dynamics.env_step(params, ns.sim, action)

    obs = compute_robot_obs(sim.pos, sim.quat, sim.linvel, sim.angvel)
    pos_error = quat_rotate_inverse(obs.vehicle_quat, ns.target_position - obs.pos)
    progress = (ns.curriculum_level - cur.min_level) / max(cur.max_level - cur.min_level, 1)
    reward = compute_reward(rp, pos_error, ns.pos_error_prev, sim.crashes, action,
                            ns.prev_action, progress)
    crashes = sim.crashes
    truncations = (sim.sim_steps > cfg.episode_len_steps).to(torch.float32)
    dist = safe_norm(ns.target_position - obs.pos, dim=-1)
    not_crashed = (crashes <= 0).to(torch.float32)
    successes = truncations * (dist < cfg.success_distance).to(torch.float32) * not_crashed
    timeouts = truncations * (1.0 - successes) * not_crashed

    level, s_agg, c_agg, t_agg = curriculum_update(
        cur, ns.curriculum_level, ns.success_agg, ns.crash_agg, ns.timeout_agg,
        successes, crashes, timeouts, ns.rng)

    # auto-reset with the curriculum's obstacle count
    sim = replace(sim, crashes=crashes, truncations=truncations,
                  num_obstacles=torch.zeros_like(sim.num_obstacles) + level.to(torch.int32))
    done = torch.maximum(crashes, truncations)
    sim = dynamics.reset_envs(params, sim, done)
    done_b = done.to(torch.bool)[:, None]

    # fresh targets for reset envs, inside their fresh bounds
    target = torch.where(done_b, sample_targets(cfg, sim, draws.target_ratio),
                         ns.target_position)

    # render AFTER the reset, depth only, then perception
    obs2 = compute_robot_obs(sim.pos, sim.quat, sim.linvel, sim.angvel)
    if params.camera is not None:
        pixels, _ = render_camera(params, sim, gen=sim.rng, want_seg=False)
        if vae is not None:
            latents = vae.encode(pixels, noise=draws.latent_noise)
        else:
            latents = _pooled_depth_features(pixels, cfg.latent_dim)
    else:
        latents = torch.zeros_like(ns.latents)

    if cfg.return_state_before_reset:
        # the observation shows the state BEFORE the reset, with the
        # latents rendered for the previous step
        pack_obs, pack_target, pack_latents = obs, ns.target_position, ns.latents
    else:
        pack_obs, pack_target, pack_latents = obs2, target, latents
    vec_to_tgt = quat_rotate_inverse(pack_obs.vehicle_quat, pack_target - pack_obs.pos)
    dist_to_tgt = safe_norm(vec_to_tgt, dim=-1, keepdim=True)
    unit_vec = (vec_to_tgt + 0.2 * (draws.obs_perturb - 0.5)) / torch.clamp(dist_to_tgt,
                                                                            min=1e-6)
    e_pert = ssa(pack_obs.euler) + 0.1 * (draws.euler_perturb - 0.5)
    task_obs = torch.cat([
        unit_vec,
        dist_to_tgt,
        e_pert[..., 0:1], e_pert[..., 1:2],
        torch.zeros_like(dist_to_tgt),
        pack_obs.body_linvel, pack_obs.body_angvel,
        action,
        pack_latents,
    ], dim=-1)

    ns = NavState(
        sim=sim, target_position=target,
        pos_error_prev=quat_rotate_inverse(obs2.vehicle_quat, target - obs2.pos),
        prev_action=torch.where(done_b, torch.zeros_like(action), action),
        latents=latents, curriculum_level=level, success_agg=s_agg, crash_agg=c_agg,
        timeout_agg=t_agg)
    infos = {"successes": successes, "timeouts": timeouts, "crashes": crashes,
             "curriculum_level": level}
    return ns, task_obs, reward, crashes, truncations, infos


class NavigationTask(BaseTask):
    """``task_registry.make_task("navigation_task", ...)``. Runs on CUDA
    unless ``device="cpu"`` (argument or config) asks for the CPU."""

    def __init__(self, task_config: NavigationTaskConfig, seed=None, num_envs=None,
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
        # cap the curriculum at the actual number of obstacle slots
        if self.params.scene is not None:
            cfg.curriculum.max_level = min(cfg.curriculum.max_level,
                                           self.params.scene.num_assets)

        self.vae = None
        if cfg.use_vae and self.params.camera is not None:
            self.vae = self._build_encoder(cfg)

        self.nav_state = self._initial_nav_state()
        self.observation_space_dim = cfg.observation_space_dim
        self.action_space_dim = cfg.action_space_dim
        self.infos: Dict = {}
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.task_obs = {"observations": zeros(self.num_envs, cfg.observation_space_dim)}
        self.rewards = zeros(self.num_envs)
        self.terminations = zeros(self.num_envs)
        self.truncations = zeros(self.num_envs)

    def _build_encoder(self, cfg: NavigationTaskConfig):
        if cfg.torch_vae_path:
            # weights trained in the reference framework; takes precedence
            # over vae_params_path
            from ..models.torch_vae_import import TorchVAEImageEncoder
            return TorchVAEImageEncoder(cfg.torch_vae_path, latent_dim=cfg.latent_dim,
                                        device=self.device)
        from ..models.vae import VAEImageEncoder
        from ..models.vit import ViTImageEncoder
        image_res = (self.params.camera.height, self.params.camera.width)
        arch, encoder = "conv", None
        if cfg.vae_params_path:
            from ..sim.convert import load_encoder_pickle
            arch, encoder = load_encoder_pickle(cfg.vae_params_path, image_res)
        kw = dict(latent_dim=cfg.latent_dim, image_res=image_res, encoder=encoder,
                  seed=cfg.seed, device=self.device)
        if arch == "vit":
            return ViTImageEncoder(patch=encoder.patch, **kw)
        return VAEImageEncoder(**kw)

    def _initial_nav_state(self) -> NavState:
        cfg = self.task_config
        dev, N = self.device, self.num_envs
        sim = replace(self.sim_env.state, num_obstacles=torch.full(
            (N,), cfg.curriculum.min_level, dtype=torch.int32, device=dev))
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        u = env_rand(sim.rng, (N, 3), device=dev)
        return NavState(
            sim=sim,
            target_position=sample_targets(cfg, sim, u),
            pos_error_prev=zeros(N, 3),
            prev_action=zeros(N, 4),
            latents=zeros(N, cfg.latent_dim),
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
         infos) = nav_step(self.params, self.task_config, self.vae, self.nav_state, actions)
        self.sim_env.state = self.nav_state.sim
        self.task_obs["observations"] = task_obs
        self.rewards, self.terminations, self.truncations = reward, term, trunc
        self.infos = infos
        return self.get_return_tuple()

    def get_return_tuple(self):
        return (self.task_obs, self.rewards, self.terminations, self.truncations, self.infos)

    def make_step_fn(self):
        """PPO protocol: (step_fn, init_carry, init_obs) with
        step_fn(carry, action) -> (carry, obs, reward, term, trunc); the
        carry is the NavState, which draws from its sim state's generator."""
        params, cfg, vae = self.params, self.task_config, self.vae

        def step_fn(ns, action):
            ns, obs, reward, term, trunc, _ = nav_step(params, cfg, vae, ns, action)
            return ns, obs, reward, term, trunc

        zero_obs = torch.zeros((self.num_envs, cfg.observation_space_dim), device=self.device)
        return step_fn, self.nav_state, zero_obs

    def set_carry(self, carry: NavState):
        self.nav_state = carry
        self.sim_env.state = carry.sim
