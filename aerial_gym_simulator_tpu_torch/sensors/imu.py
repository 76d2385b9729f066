"""IMU sensor: specific force and angular rate with a bias random walk.

Counterpart of ``aerial_gym_simulator_tpu/sensors/imu.py``. The
accelerometer reads the applied body force over the mass (specific force:
gravity does not show in free fall), the gyro the body rate; both are
rotated into the (perturbed) mount frame, get white noise scaled by
1/sqrt(dt) and a bias that walks by sqrt(dt) per step (each term gated by
``enable_noise`` / ``enable_bias``), optionally gravity compensation and a
world-frame output, and are clamped to the sensor's range. Biases re-draw
uniformly in +-init at reset.

Every draw comes from the state's ``torch.Generator`` or, for the
measurement, from an ``ImuDraws`` the caller passes. Nothing here reads a
device value back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..sim.params import f32
from ..sim.structs import ImuParams, SimParams, SimState
from ..utils.env_rng import env_rand, env_randn
from ..utils.math import quat_from_euler_xyz, quat_mul, quat_rotate, quat_rotate_inverse


def build_imu_params(cfg, device) -> ImuParams:
    """An IMU config -> ImuParams on ``device``. ``max_bias_init_value``
    is either [accel (3), gyro (3)] or one 3-vector for both."""
    bias_init = np.asarray(getattr(cfg, "max_bias_init_value", [1e-3] * 6), np.float32)
    if bias_init.shape == (6,):
        accel_bias_init, gyro_bias_init = bias_init[:3], bias_init[3:]
    else:
        accel_bias_init = gyro_bias_init = bias_init
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    deg = lambda name, default: t(np.asarray(getattr(cfg, name, default), np.float32)
                                  * (np.pi / 180.0))
    return ImuParams(
        accel_noise_std=t(cfg.accel_noise_std),
        gyro_noise_std=t(cfg.gyro_noise_std),
        accel_bias_std=t(cfg.accel_bias_std),
        gyro_bias_std=t(cfg.gyro_bias_std),
        max_accel=f32(cfg.max_measurement_acceleration),
        max_gyro=f32(cfg.max_measurement_angular_velocity),
        accel_bias_init=t(accel_bias_init),
        gyro_bias_init=t(gyro_bias_init),
        min_mount_euler_rad=deg("min_euler_rotation_deg", [-2.0, -2.0, -2.0]),
        max_mount_euler_rad=deg("max_euler_rotation_deg", [2.0, 2.0, 2.0]),
        world_frame=cfg.world_frame,
        gravity_compensation=cfg.gravity_compensation,
        enable_noise=bool(getattr(cfg, "enable_noise", True)),
        enable_bias=bool(getattr(cfg, "enable_bias", True)),
        randomize_placement=bool(getattr(cfg, "randomize_placement", False)),
    )


def sample_imu_reset(ip: ImuParams, gen: torch.Generator, num_envs: int):
    """Reset draws -> (accel_bias (N, 3), gyro_bias (N, 3), mount_quat
    (N, 4)): biases uniform in +-init, and a mount quaternion from Euler
    angles uniform in the mount range when ``randomize_placement`` (else
    the identity)."""
    dev = ip.accel_bias_init.device
    u = env_rand(gen, (3, num_envs, 3), dim=1, device=dev)
    accel_bias = -ip.accel_bias_init + 2.0 * ip.accel_bias_init * u[0]
    gyro_bias = -ip.gyro_bias_init + 2.0 * ip.gyro_bias_init * u[1]
    if ip.randomize_placement:
        lo, hi = ip.min_mount_euler_rad, ip.max_mount_euler_rad
        eul = lo + (hi - lo) * u[2]
        mount_quat = quat_from_euler_xyz(eul[:, 0], eul[:, 1], eul[:, 2])
    else:
        mount_quat = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(num_envs, 4).clone()
    return accel_bias, gyro_bias, mount_quat


@dataclass
class ImuDraws:
    """The four standard-normal (N, 3) draws one measurement consumes: the
    accelerometer's and the gyro's bias increments, then their white
    noise."""
    accel_bias: torch.Tensor
    gyro_bias: torch.Tensor
    accel_noise: torch.Tensor
    gyro_noise: torch.Tensor


def sample_imu_draws(gen: torch.Generator, num_envs: int, device) -> ImuDraws:
    z = env_randn(gen, (4, num_envs, 3), dim=1, device=device)
    return ImuDraws(accel_bias=z[0], gyro_bias=z[1], accel_noise=z[2], gyro_noise=z[3])


def imu_measurement(params: SimParams, state: SimState, draws: Optional[ImuDraws] = None):
    """-> (accel (N, 3), gyro (N, 3), new accel bias, new gyro bias); the
    caller writes the biases back into the state. ``draws`` None draws from
    the state's generator."""
    ip = params.imu
    sqrt_dt = math.sqrt(params.dt)
    if draws is None:
        draws = sample_imu_draws(state.rng, state.num_envs, state.device)

    accel_b = state.applied_force_b / params.robot.mass
    gyro_b = quat_rotate_inverse(state.quat, state.angvel)
    mq = state.imu_mount_quat
    accel_s = quat_rotate_inverse(mq, accel_b)
    gyro_s = quat_rotate_inverse(mq, gyro_b)

    accel_bias = state.imu_accel_bias + draws.accel_bias * ip.accel_bias_std * sqrt_dt
    gyro_bias = state.imu_gyro_bias + draws.gyro_bias * ip.gyro_bias_std * sqrt_dt
    e_bias = 1.0 if ip.enable_bias else 0.0
    e_noise = 1.0 if ip.enable_noise else 0.0
    accel = accel_s + e_bias * accel_bias + e_noise * (draws.accel_noise * ip.accel_noise_std
                                                       / sqrt_dt)
    gyro = gyro_s + e_bias * gyro_bias + e_noise * (draws.gyro_noise * ip.gyro_noise_std
                                                    / sqrt_dt)
    if ip.gravity_compensation:
        accel = accel + quat_rotate_inverse(quat_mul(state.quat, mq),
                                            params.gravity.expand_as(accel))
    if ip.world_frame:
        accel = quat_rotate(quat_mul(state.quat, mq), accel)
        gyro = state.angvel
    accel = torch.clamp(accel, -ip.max_accel, ip.max_accel)
    gyro = torch.clamp(gyro, -ip.max_gyro, ip.max_gyro)
    return accel, gyro, accel_bias, gyro_bias
