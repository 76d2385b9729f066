"""Helpers that the kinds share for reading the port's objects. Nothing here
drives a loop; every import of the port is inside a function."""

from __future__ import annotations

import dataclasses

STATE_FIELDS = ("pos", "quat", "linvel", "angvel", "motor_thrust", "motor_tau_inc",
                "motor_tau_dec", "motor_thrust_constant", "K_pos", "K_vel", "K_rot", "K_angvel",
                "obstacle_pos", "obstacle_quat", "obstacle_linvel", "obstacle_angvel",
                "cam_mount_pos", "cam_mount_quat", "crashes", "truncations", "sim_steps")


def port_seed(seed: int) -> int:
    """The seed handed to the port's builders, some of which seed numpy's
    legacy generator (32 bits)."""
    return seed % 2 ** 32


def state_dict(state):
    """The compared fields of a port ``SimState`` as a dict of tensors."""
    return {k: getattr(state, k) for k in STATE_FIELDS}


def scene_tables(scene):
    """The per-env local primitive tables the scene compiler made at set-up
    (kind, size, local pose, semantic id, slot): the scene's description,
    which the references compose with the obstacle poses themselves."""
    return dict(kind=scene.env_prim_kind, size=scene.env_prim_size, pos=scene.env_prim_pos,
                rot=scene.env_prim_rot, semantic=scene.env_prim_semantic, slot=scene.env_prim_slot)


def small_camera(params, hw, device):
    """Tests only: the camera at another resolution."""
    from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
        BaseDepthCameraConfig)
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import build_ray_sensor_params
    cam = build_ray_sensor_params(BaseDepthCameraConfig(height=hw[0], width=hw[1]), device)
    return dataclasses.replace(params, camera=cam)


def raycast_launches():
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda
    return dict(raycast_cuda.LAUNCHES)


def attention_launches():
    from aerial_gym_simulator_tpu_torch.ops import attention_cuda
    return dict(attention_cuda.LAUNCHES)
