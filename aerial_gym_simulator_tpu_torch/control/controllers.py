"""Geometric (Lee SE(3)) controllers on batched torch tensors.

Counterpart of ``aerial_gym_simulator_tpu/control/controllers.py``.

Controller name -> action semantics:
  lee_position_control     [x, y, z, yaw]                 world-frame position
  lee_velocity_control     [vx, vy, vz, yaw_rate]         vehicle-frame velocity
  lee_velocity_steering_angle_control
                           [vx, vy, vz, yaw]              velocity, absolute yaw
  lee_attitude_control     [thrust, roll, pitch, yaw_rate]
  lee_rates_control        [thrust, p, q, r]              body rates
  lee_acceleration_control [ax, ay, az, yaw_rate]         world-frame acceleration
  fully_actuated_control   [x, y, z, qx, qy, qz, qw]      6-DoF pose, full wrench
  no_control               per-motor thrusts; the robot step applies them
                           (``sim/dynamics.compute_robot_wrench``)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..sim.structs import ControllerParams, RobotParams
from ..utils.math import (
    compute_vee_map,
    cross,
    get_euler_xyz_tensor,
    normalize,
    quat_from_euler_xyz,
    quat_inverse,
    quat_mul,
    quat_rotate,
    quat_rotate_inverse,
    quat_to_rotation_matrix,
    rotation_matrix_to_quat,
    ssa,
    vehicle_frame_quat_from_quat,
)


class RobotObs(NamedTuple):
    """Derived per-substep robot states."""
    pos: torch.Tensor             # (N, 3) world
    quat: torch.Tensor            # (N, 4) xyzw
    linvel: torch.Tensor          # (N, 3) world
    angvel: torch.Tensor          # (N, 3) world
    euler: torch.Tensor           # (N, 3) ssa-wrapped xyz euler
    vehicle_quat: torch.Tensor    # (N, 4) yaw-only
    vehicle_linvel: torch.Tensor  # (N, 3)
    body_linvel: torch.Tensor     # (N, 3)
    body_angvel: torch.Tensor     # (N, 3)


class Gains(NamedTuple):
    K_pos: torch.Tensor
    K_vel: torch.Tensor
    K_rot: torch.Tensor
    K_angvel: torch.Tensor


def compute_robot_obs(pos, quat, linvel, angvel) -> RobotObs:
    vq = vehicle_frame_quat_from_quat(quat)
    return RobotObs(
        pos=pos,
        quat=quat,
        linvel=linvel,
        angvel=angvel,
        euler=ssa(get_euler_xyz_tensor(quat)),
        vehicle_quat=vq,
        vehicle_linvel=quat_rotate_inverse(vq, linvel),
        body_linvel=quat_rotate_inverse(quat, linvel),
        body_angvel=quat_rotate_inverse(quat, angvel),
    )


# ---------------------------------------------------------------------------
# shared pieces
# ---------------------------------------------------------------------------


def compute_acceleration(obs: RobotObs, g: Gains, setpoint_position, setpoint_velocity):
    """K_pos * pos_err + K_vel * vel_err, velocity setpoint in vehicle frame."""
    pos_err = setpoint_position - obs.pos
    setvel_world = quat_rotate(obs.vehicle_quat, setpoint_velocity)
    vel_err = setvel_world - obs.linvel
    return g.K_pos * pos_err + g.K_vel * vel_err


def compute_body_torque(cp: ControllerParams, rp: RobotParams, obs: RobotObs,
                        g: Gains, setpoint_quat, setpoint_angvel):
    """SO(3) rotation-error torque with gyroscopic feed-forward."""
    yaw_rate = torch.clamp(setpoint_angvel[..., 2], -cp.max_yaw_rate, cp.max_yaw_rate)
    setpoint_angvel = torch.cat([setpoint_angvel[..., :2], yaw_rate[..., None]], dim=-1)
    RT_Rd_quat = quat_mul(quat_inverse(obs.quat), setpoint_quat)
    RT_Rd = quat_to_rotation_matrix(RT_Rd_quat)
    rot_err = 0.5 * compute_vee_map(RT_Rd.transpose(-2, -1) - RT_Rd)
    angvel_err = obs.body_angvel - quat_rotate(RT_Rd_quat, setpoint_angvel)
    Iw = obs.body_angvel @ rp.inertia.T
    feed_forward = cross(obs.body_angvel, Iw)
    return -g.K_rot * rot_err - g.K_angvel * angvel_err + feed_forward


def desired_quat_from_forces_and_yaw(forces, yaw_setpoint):
    """Small-angle desired orientation: roll and pitch that tilt the body z
    axis along the force, at the given yaw."""
    c_phi_s_theta = forces[..., 0]
    s_phi = -forces[..., 1]
    c_phi_c_theta = forces[..., 2]
    pitch = torch.atan2(c_phi_s_theta, c_phi_c_theta)
    roll = torch.atan2(s_phi, torch.sqrt(c_phi_c_theta ** 2 + c_phi_s_theta ** 2))
    return quat_from_euler_xyz(roll, pitch, yaw_setpoint)


def desired_quat_from_forces_full(forces, yaw_setpoint):
    """Full-SO(3) desired orientation from the thrust direction."""
    b3 = normalize(forces)
    temp = torch.stack([torch.cos(yaw_setpoint), torch.sin(yaw_setpoint),
                        torch.zeros_like(yaw_setpoint)], dim=-1)
    b2 = normalize(cross(b3, temp))
    b1 = cross(b2, b3)
    R = torch.stack([b1, b2, b3], dim=-1)  # columns are b1, b2, b3
    return rotation_matrix_to_quat(R)


def euler_rates_to_body_rates(euler, euler_rates):
    """T(euler) @ euler_rates, written out row by row."""
    s_pitch, c_pitch = torch.sin(euler[..., 1]), torch.cos(euler[..., 1])
    s_roll, c_roll = torch.sin(euler[..., 0]), torch.cos(euler[..., 0])
    r0, r1, r2 = euler_rates[..., 0], euler_rates[..., 1], euler_rates[..., 2]
    return torch.stack([
        r0 - s_pitch * r2,
        c_roll * r1 + s_roll * c_pitch * r2,
        -s_roll * r1 + c_roll * c_pitch * r2,
    ], dim=-1)


# ---------------------------------------------------------------------------
# controller variants
# ---------------------------------------------------------------------------


def _thrust_along_body_z(obs: RobotObs, forces):
    """Project a world-frame force command on the body z axis."""
    R = quat_to_rotation_matrix(obs.quat)
    return torch.sum(forces * R[..., :, 2], dim=-1)


def _zero3(x):
    return torch.zeros(x.shape[:-1] + (3,), dtype=x.dtype, device=x.device)


def _yaw_rate_only(action):
    z = torch.zeros_like(action[..., 3])
    return torch.stack([z, z, action[..., 3]], dim=-1)


def _wrench(thrust_z, torque):
    zeros = torch.zeros_like(thrust_z)
    return torch.stack([zeros, zeros, thrust_z, torque[..., 0], torque[..., 1],
                        torque[..., 2]], dim=-1)


def lee_position_control(cp, rp, gravity, obs, g, action):
    accel = compute_acceleration(obs, g, action[..., 0:3], _zero3(action))
    forces = (accel - gravity) * rp.mass
    thrust = _thrust_along_body_z(obs, forces)
    quat_des = desired_quat_from_forces_full(forces, action[..., 3])
    torque = compute_body_torque(cp, rp, obs, g, quat_des, _zero3(action))
    return _wrench(thrust, torque)


def lee_velocity_control(cp, rp, gravity, obs, g, action):
    accel = compute_acceleration(obs, g, obs.pos, action[..., 0:3])
    forces = (accel - gravity) * rp.mass
    thrust = _thrust_along_body_z(obs, forces)
    quat_des = desired_quat_from_forces_full(forces, obs.euler[..., 2])
    body_rates = euler_rates_to_body_rates(obs.euler, _yaw_rate_only(action))
    torque = compute_body_torque(cp, rp, obs, g, quat_des, body_rates)
    return _wrench(thrust, torque)


def lee_velocity_steering_angle_control(cp, rp, gravity, obs, g, action):
    accel = compute_acceleration(obs, g, obs.pos, action[..., 0:3])
    forces = (accel - gravity) * rp.mass
    thrust = _thrust_along_body_z(obs, forces)
    quat_des = desired_quat_from_forces_full(forces, action[..., 3])
    torque = compute_body_torque(cp, rp, obs, g, quat_des, _zero3(action))
    return _wrench(thrust, torque)


def lee_attitude_control(cp, rp, gravity, obs, g, action):
    thrust = (action[..., 0] + 1.0) * rp.mass * torch.linalg.norm(gravity)
    body_rates = euler_rates_to_body_rates(obs.euler, _yaw_rate_only(action))
    quat_des = quat_from_euler_xyz(action[..., 1], action[..., 2], obs.euler[..., 2])
    torque = compute_body_torque(cp, rp, obs, g, quat_des, body_rates)
    return _wrench(thrust, torque)


def lee_rates_control(cp, rp, gravity, obs, g, action):
    # hover-normalised collective thrust, as the attitude controller's: the
    # reference's line (cmd[:, 0] - gravity) * mass mixes shapes, and the
    # JAX package implements the intended semantics
    thrust = (action[..., 0] + 1.0) * rp.mass * torch.linalg.norm(gravity)
    torque = compute_body_torque(cp, rp, obs, g, obs.quat, action[..., 1:4])
    return _wrench(thrust, torque)


def lee_acceleration_control(cp, rp, gravity, obs, g, action):
    forces = rp.mass * (action[..., 0:3] - gravity)
    thrust = _thrust_along_body_z(obs, forces)
    quat_des = desired_quat_from_forces_and_yaw(forces, obs.euler[..., 2])
    body_rates = euler_rates_to_body_rates(obs.euler, _yaw_rate_only(action))
    torque = compute_body_torque(cp, rp, obs, g, quat_des, body_rates)
    return _wrench(thrust, torque)


def fully_actuated_control(cp, rp, gravity, obs, g, action):
    """6-DoF pose control: the world-frame force rotated into the body
    frame, so the wrench has all six components. It takes 7 actions: the
    generic name is registered with the default 4, so a 4-wide action
    raises here (the JAX package clamps the missing quaternion indices)."""
    if action.shape[-1] != 7:
        raise ValueError("fully_actuated_control takes 7 actions [x, y, z, qx, qy, qz, qw], "
                         f"got {action.shape[-1]}")
    quat_des = normalize(action[..., 3:7])
    accel = compute_acceleration(obs, g, action[..., 0:3], _zero3(action))
    forces = rp.mass * (accel - gravity)
    force_body = quat_rotate_inverse(obs.quat, forces)
    torque = compute_body_torque(cp, rp, obs, g, quat_des, _zero3(action))
    return torch.cat([force_body, torque], dim=-1)


_CONTROLLERS = {
    "lee_position_control": lee_position_control,
    "lee_velocity_control": lee_velocity_control,
    "lee_attitude_control": lee_attitude_control,
    "lee_rates_control": lee_rates_control,
    "lee_acceleration_control": lee_acceleration_control,
    "lee_velocity_steering_angle_control": lee_velocity_steering_angle_control,
    "fully_actuated_control": fully_actuated_control,
}


def controller_update(name: str, cp: ControllerParams, rp: RobotParams,
                      gravity, obs: RobotObs, gains: Gains, action):
    """Dispatch on the controller name -> (N, 6) body wrench command.
    'no_control' has no wrench: the robot step takes its actions as motor
    thrust references."""
    if name == "no_control":
        raise ValueError("no_control has no wrench output; handled in robot step")
    try:
        fn = _CONTROLLERS[name]
    except KeyError:
        raise ValueError(f"unknown controller '{name}'; known: {sorted(_CONTROLLERS)}")
    return fn(cp, rp, gravity, obs, gains, action)
