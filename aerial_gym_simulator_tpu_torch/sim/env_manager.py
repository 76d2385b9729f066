"""Stateful facade over the simulation functions.

Counterpart of ``aerial_gym_simulator_tpu/sim/env_manager.py``:
``step(actions, env_actions)``, ``reset()``, ``reset_idx(env_ids)``, ``get_obs()``,
``post_reward_calculation_step()``, ``render()`` and, for reconfigurable
robots, ``robot_manager.robot.set_dof_position_targets`` /
``set_dof_velocity_targets``. The steps run eagerly
on the params' device; nothing in ``step`` or ``render`` reads a device
value back to the host.
"""

from __future__ import annotations

import logging
import math
import random as pyrandom
from typing import Dict

import torch

from ..control.controllers import compute_robot_obs
from ..utils import checkpoint
from . import dynamics
from .params import initial_state
from .structs import SimParams, SimState, replace

logger = logging.getLogger(__name__)


class _RobotHandle:
    """``env_manager.robot_manager.robot``: the joint targets of a
    reconfigurable robot. They live in the state, so the setters replace
    the state's tensors (a value broadcast to (N, D))."""

    def __init__(self, env_manager: "EnvManager"):
        self._em = env_manager

    def _targets(self, targets, like: torch.Tensor) -> torch.Tensor:
        t = torch.as_tensor(targets, dtype=torch.float32, device=like.device)
        return t.expand(like.shape).clone()

    def set_dof_position_targets(self, targets):
        em = self._em
        em.state = replace(em.state, dof_pos_target=self._targets(targets,
                                                                  em.state.dof_pos_target))

    def set_dof_velocity_targets(self, targets):
        em = self._em
        em.state = replace(em.state, dof_vel_target=self._targets(targets,
                                                                  em.state.dof_vel_target))


class _RobotManagerHandle:
    """The attribute chain ``env_manager.robot_manager.robot``."""

    def __init__(self, env_manager: "EnvManager"):
        self.robot = _RobotHandle(env_manager)


class EnvManager:
    """Owns (params, state) and steps them."""

    def __init__(self, params: SimParams, seed: int = 0, sim_config=None,
                 env_config=None, robot_config=None, controller_config=None):
        self.params = params
        self.device = params.device
        self.sim_config = sim_config
        self.env_config = env_config
        self.robot_config = robot_config
        self.controller_config = controller_config
        self.num_envs = params.env.num_envs
        self.num_robot_actions = params.controller.num_actions
        self.num_env_actions = params.env.num_env_actions
        self.state: SimState = initial_state(params, seed=seed)
        self.step_counter = 0
        self._py_rng = pyrandom.Random(seed)
        # the latest env actions (dynamic-obstacle twists)
        self.env_actions = None
        self.robot_manager = _RobotManagerHandle(self)
        # latest sensor captures (filled by render())
        self._sensor_frames = None
        self._sensor_seg = None
        self._lidar_frames = None
        self._lidar_seg = None
        self._rgb_frames = None
        self.reset()

    # -- core loop ---------------------------------------------------------

    def _sample_substeps(self) -> int:
        env = self.params.env
        if env.substep_std == 0.0:
            return env.substep_mean
        return max(int(math.floor(self._py_rng.gauss(env.substep_mean,
                                                     env.substep_std))), 0)

    def _as_actions(self, actions) -> torch.Tensor:
        return torch.as_tensor(actions, dtype=torch.float32, device=self.device)

    def step(self, actions, env_actions=None):
        """One env step. ``env_actions`` (N, W) or (N, A, W) sets the
        obstacles' twists (envs/scene.apply_env_actions) when the scene has
        obstacles; the obstacles keep those twists until the next env
        actions or their env's reset."""
        if env_actions is not None:
            self.env_actions = self._as_actions(env_actions)
            if self.params.scene is not None and self.params.scene.num_assets > 0:
                from ..envs.scene import apply_env_actions
                self.state = apply_env_actions(self.params, self.state, self.env_actions)
        self.state = dynamics.env_step(self.params, self.state, self._as_actions(actions),
                                       self._sample_substeps())
        self.step_counter += 1
        return self.state

    def reset(self):
        mask = torch.ones((self.num_envs,), dtype=torch.float32, device=self.device)
        self.state = dynamics.reset_envs(self.params, self.state, mask)
        return self.get_obs()

    def reset_idx(self, env_ids):
        mask = torch.zeros((self.num_envs,), dtype=torch.float32, device=self.device)
        mask[torch.as_tensor(env_ids, device=self.device, dtype=torch.long)] = 1.0
        self.state = dynamics.reset_envs(self.params, self.state, mask)

    def post_reward_calculation_step(self, crashes=None, truncations=None):
        """Auto-reset done envs; a task may pass its own crash/truncation
        verdicts."""
        if crashes is not None or truncations is not None:
            self.state = replace(
                self.state,
                crashes=self.state.crashes if crashes is None else crashes,
                truncations=self.state.truncations if truncations is None else truncations)
        self.state = dynamics.post_reward_step(self.params, self.state)

    # -- observation access ------------------------------------------------

    def get_obs(self) -> Dict[str, torch.Tensor]:
        """The observation dict; a camera or lidar with ``num_sensors`` S > 1
        fills its pixel keys with (N, S, H, W) captures."""
        s = self.state
        obs = compute_robot_obs(s.pos, s.quat, s.linvel, s.angvel)
        out = {
            "robot_position": obs.pos,
            "robot_orientation": obs.quat,
            "robot_linvel": obs.linvel,
            "robot_angvel": obs.angvel,
            "robot_euler_angles": obs.euler,
            "robot_vehicle_orientation": obs.vehicle_quat,
            "robot_vehicle_linvel": obs.vehicle_linvel,
            "robot_body_linvel": obs.body_linvel,
            "robot_body_angvel": obs.body_angvel,
            "robot_actions": None,
            "crashes": s.crashes,
            "truncations": s.truncations,
            "motor_thrusts": s.motor_thrust,
            "imu_measurement": torch.cat([s.applied_force_b, s.applied_torque_b], dim=-1),
            "obstacle_position": s.obstacle_pos,
            "obstacle_orientation": s.obstacle_quat,
            "num_envs": self.num_envs,
            "gravity": self.params.gravity,
            "robot_mass": self.params.robot.mass,
            "robot_inertia": self.params.robot.inertia,
            "env_bounds_min": s.bounds_lo,
            "env_bounds_max": s.bounds_hi,
            "num_obstacles_in_env": s.num_obstacles,
        }
        if self._sensor_frames is not None:
            out["depth_range_pixels"] = self._sensor_frames
        if self._sensor_seg is not None:
            out["segmentation_pixels"] = self._sensor_seg
        if self._lidar_frames is not None:
            # a robot with camera and lidar: the lidar rides its own keys
            out["lidar_range_pixels"] = self._lidar_frames
        if self._lidar_seg is not None:
            out["lidar_segmentation_pixels"] = self._lidar_seg
        if self._rgb_frames is not None:
            out["rgb_pixels"] = self._rgb_frames
        return out

    @property
    def sim_steps(self):
        return self.state.sim_steps

    def render(self, render_components: str = "sensors"):
        """Capture the sensors into get_obs()["depth_range_pixels"] (and
        "segmentation_pixels" for a segmentation sensor). Configured noise
        is drawn from the state's generator. No-op without a camera or
        lidar.

        A robot with camera and lidar captures both: the camera keeps those
        keys, the lidar lands in "lidar_range_pixels" /
        "lidar_segmentation_pixels"; a lidar-only robot keeps the camera's
        keys. render_components="rgb" also captures the camera's RGB image
        into get_obs()["rgb_pixels"]; a plain render() drops a stale one."""
        params, state = self.params, self.state
        if params.camera is None and params.lidar is None:
            return None
        from ..sensors.raycast_sensor import render_camera, render_lidar, render_rgb_camera
        if "rgb" in render_components:
            if params.camera is None:
                logger.warning("render('rgb') requested but no camera sensor is configured; "
                               "rgb_pixels will not be captured (lidar-only robot)")
            else:
                self._rgb_frames = render_rgb_camera(params, state)[0]
        else:
            # a plain render() advances depth but not rgb: do not pair them
            self._rgb_frames = None
        camera = (render_camera(params, state, gen=state.rng) if params.camera is not None
                  else None)
        lidar = (render_lidar(params, state, gen=state.rng) if params.lidar is not None
                 else (None, None))
        if camera is not None:
            (self._sensor_frames, self._sensor_seg), (self._lidar_frames, self._lidar_seg) = (
                camera, lidar)
        else:
            self._sensor_frames, self._sensor_seg = lidar
        return self._sensor_frames

    def delete_env(self):
        self.state = None

    # -- saved sim state ---------------------------------------------------
    # Everything the continuation draws from is in the file: the state with
    # its generator (dynamics, resets, sensor noise), the obstacles' twists
    # and the sensors' mounts, (N, S, .) for S > 1, the step counter and the
    # host RNG of the substep count, so a reloaded sim continues the same
    # trajectory and renders the same noisy frames.

    def _saved(self):
        return {"state": self.state, "step_counter": self.step_counter,
                "py_rng": self._py_rng.getstate()}

    def save_state(self, path: str):
        """Write the complete simulator state to ``path``
        (``utils/checkpoint.save_state``, atomic)."""
        checkpoint.save_state(path, self._saved())

    def load_state(self, path: str):
        """Restore a state written by ``save_state``. The current state is
        the template: the file must come from the same configuration (its
        structure and every tensor's shape are checked)."""
        saved = checkpoint.load_state(path, like=self._saved())
        self.state = saved["state"]
        self.step_counter = int(saved["step_counter"])
        self._py_rng.setstate(saved["py_rng"])
        # frames captured on the abandoned trajectory: the next render()
        # captures anew
        self._sensor_frames = None
        self._sensor_seg = None
        self._lidar_frames = None
        self._lidar_seg = None
        self._rgb_frames = None
        logger.info("sim state loaded from %s", path)
