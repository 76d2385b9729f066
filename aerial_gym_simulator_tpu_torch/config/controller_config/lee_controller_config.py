"""Lee controller gains, copied from the JAX package's
``config/controller_config/lee_controller_config.py``."""

from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class ControllerConfig:
    name: str = "lee_controller"
    # dispatch key into the controller family; empty means `name`
    base_controller: str = ""
    num_actions: int = 4
    max_inclination_angle_rad: float = np.pi / 3.0
    max_yaw_rate: float = np.pi / 3.0

    K_pos_tensor_max: List[float] = field(default_factory=lambda: [3.0, 3.0, 2.0])
    K_pos_tensor_min: List[float] = field(default_factory=lambda: [2.0, 2.0, 1.0])
    K_vel_tensor_max: List[float] = field(default_factory=lambda: [3.0, 3.0, 3.0])
    K_vel_tensor_min: List[float] = field(default_factory=lambda: [2.0, 2.0, 2.0])
    K_rot_tensor_max: List[float] = field(default_factory=lambda: [1.2, 1.2, 0.6])
    K_rot_tensor_min: List[float] = field(default_factory=lambda: [0.8, 0.8, 0.4])
    K_angvel_tensor_max: List[float] = field(default_factory=lambda: [0.2, 0.2, 0.2])
    K_angvel_tensor_min: List[float] = field(default_factory=lambda: [0.1, 0.1, 0.1])

    randomize_params: bool = False


def lee_controller_config(name: str, num_actions: int = 4) -> ControllerConfig:
    return ControllerConfig(name=name, num_actions=num_actions)


def lmf2_controller_config(name: str, num_actions: int = 4) -> ControllerConfig:
    """Gain ranges of the lmf2 platform, sampled per env at every reset.
    K_vel z has min 1.7 above max 1.3: that is the source's own data, and
    ``lo + (hi - lo) * u`` samples the reversed interval all the same."""
    return ControllerConfig(
        name=name, num_actions=num_actions,
        K_pos_tensor_min=[2.0, 2.0, 1.0], K_pos_tensor_max=[2.0, 2.0, 1.0],
        K_vel_tensor_min=[2.7, 2.7, 1.7], K_vel_tensor_max=[3.3, 3.3, 1.3],
        K_rot_tensor_min=[1.6, 1.6, 0.25], K_rot_tensor_max=[1.85, 1.85, 0.4],
        K_angvel_tensor_min=[0.4, 0.4, 0.075], K_angvel_tensor_max=[0.5, 0.5, 0.09],
        randomize_params=True,
    )


def magpie_controller_config(name: str, num_actions: int = 4) -> ControllerConfig:
    """Gain ranges of the magpie platform, sampled per env at every reset."""
    return ControllerConfig(
        name=name, num_actions=num_actions,
        K_pos_tensor_min=[2.0, 2.0, 1.0], K_pos_tensor_max=[2.0, 2.0, 1.0],
        K_vel_tensor_min=[2.7, 2.7, 2.3], K_vel_tensor_max=[3.3, 3.3, 2.6],
        K_rot_tensor_min=[8.9453125, 8.9453125, 0.32499998807907104],
        K_rot_tensor_max=[12.9453125, 12.9453125, 0.32499998807907104],
        K_angvel_tensor_min=[0.65910937666893005, 0.65910937666893005,
                             0.028818358927965164],
        K_angvel_tensor_max=[0.8910937666893005, 0.8910937666893005,
                             0.048818358927965164],
        randomize_params=True,
    )


@dataclass
class NoControlConfig(ControllerConfig):
    """Pass-through: actions are per-motor thrust references. SimBuilder
    sets ``num_actions`` to the robot's motor count."""
    name: str = "no_control"
    num_actions: int = 4


def octarotor_controller_config(name: str, num_actions: int = 4) -> ControllerConfig:
    """Gain ranges of the octarotor, sampled per env at every reset. K_rot
    x/y have min 10.8 above max 10.2: that is the source's own data, and
    ``lo + (hi - lo) * u`` samples the reversed interval all the same."""
    return ControllerConfig(
        name=name, num_actions=num_actions,
        K_pos_tensor_min=[2.0, 2.0, 1.0], K_pos_tensor_max=[3.0, 3.0, 2.0],
        K_vel_tensor_min=[2.0, 2.0, 2.0], K_vel_tensor_max=[3.0, 3.0, 3.0],
        K_rot_tensor_min=[10.8, 10.8, 5.4], K_rot_tensor_max=[10.2, 10.2, 5.6],
        K_angvel_tensor_min=[2.1, 2.1, 2.1], K_angvel_tensor_max=[2.2, 2.2, 2.2],
        randomize_params=True,
    )


def rov_fully_actuated_controller_config() -> ControllerConfig:
    """The ROV's 6-DoF pose controller: 7 actions [x, y, z, qx, qy, qz, qw]."""
    return ControllerConfig(
        name="fully_actuated_control", num_actions=7,
        K_pos_tensor_min=[1.0, 1.0, 1.0], K_pos_tensor_max=[1.0, 1.0, 1.0],
        K_vel_tensor_min=[8.0, 8.0, 8.0], K_vel_tensor_max=[8.0, 8.0, 8.0],
        K_rot_tensor_min=[2.2, 2.2, 2.6], K_rot_tensor_max=[2.2, 2.2, 2.6],
        K_angvel_tensor_min=[2.1, 2.1, 2.1], K_angvel_tensor_max=[2.2, 2.2, 2.2],
        randomize_params=True,
    )
