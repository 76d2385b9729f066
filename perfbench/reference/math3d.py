"""Quaternion and vector helpers of the plain references.

A frozen copy of the functions the simulator's step and camera use, taken
from ``aerial_gym_simulator_tpu_torch/utils/math.py`` (lines 25-115,
135-176, 200-307, 317-334 at the commit that added this benchmark), with
the same expressions in the same order, so that a reference run on the
card rounds as the port's plain code did when the benchmark was made.
Quaternions are [x, y, z, w]; euler angles intrinsic XYZ. Imports torch
alone.
"""

from __future__ import annotations

import math

import torch


def safe_sqrt(x):
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def safe_norm(x, dim=-1, keepdim=False):
    return safe_sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def normalize(x, eps=1e-9):
    n = safe_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def tensor_clamp(t, lo, hi):
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        return torch.minimum(torch.maximum(t, lo), hi)
    return torch.clamp(t, lo, hi)


def ssa(a):
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def rowwise_matmul(a, b):
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def compute_vee_map(skew):
    return torch.stack([-skew[..., 1, 2], skew[..., 0, 2], -skew[..., 0, 1]], dim=-1)


def quat_mul(a, b):
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by - ax * bz + ay * bw + az * bx
    z = aw * bz + ax * by - ay * bx + az * bw
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_conjugate(q):
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_rotate(q, v):
    q_w = q[..., 3:4]
    q_vec = q[..., :3]
    a = v * (2.0 * q_w * q_w - 1.0)
    b = cross(q_vec, v) * (2.0 * q_w)
    c = q_vec * (2.0 * torch.sum(q_vec * v, dim=-1, keepdim=True))
    return a + b + c


def quat_rotate_inverse(q, v):
    q_w = q[..., 3:4]
    q_vec = q[..., :3]
    a = v * (2.0 * q_w * q_w - 1.0)
    b = cross(q_vec, v) * (2.0 * q_w)
    c = q_vec * (2.0 * torch.sum(q_vec * v, dim=-1, keepdim=True))
    return a - b + c


def quat_to_rotation_matrix(q):
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
        2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
        2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def rotation_matrix_to_quat(m):
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)
    qw, qx, qy, qz = (0.5 * safe_sqrt(v) for v in (qw2, qx2, qy2, qz2))

    def den(q):
        return 4.0 * torch.clamp(q, min=1e-12)

    c0 = torch.stack([(m21 - m12) / den(qw), (m02 - m20) / den(qw),
                      (m10 - m01) / den(qw), qw], dim=-1)
    c1 = torch.stack([qx, (m01 + m10) / den(qx), (m02 + m20) / den(qx),
                      (m21 - m12) / den(qx)], dim=-1)
    c2 = torch.stack([(m01 + m10) / den(qy), qy, (m12 + m21) / den(qy),
                      (m02 - m20) / den(qy)], dim=-1)
    c3 = torch.stack([(m02 + m20) / den(qz), (m12 + m21) / den(qz), qz,
                      (m10 - m01) / den(qz)], dim=-1)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], dim=-1), dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    return normalize(torch.gather(cands, -2, idx).squeeze(-2))


def quat_from_euler_xyz(roll, pitch, yaw):
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def get_euler_xyz_tensor(q):
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    roll = torch.atan2(2.0 * (qw * qx + qy * qz), qw * qw - qx * qx - qy * qy + qz * qz)
    sinp = 2.0 * (qw * qy - qz * qx)
    sat = torch.abs(sinp) >= 1.0
    pitch = torch.where(sat, torch.sign(sinp) * (math.pi / 2.0),
                        torch.asin(torch.where(sat, torch.zeros_like(sinp),
                                               torch.clamp(sinp, -1.0, 1.0))))
    yaw = torch.atan2(2.0 * (qw * qz + qx * qy), qw * qw + qx * qx - qy * qy - qz * qz)
    two_pi = 2.0 * math.pi
    return torch.stack([torch.remainder(roll, two_pi), torch.remainder(pitch, two_pi),
                        torch.remainder(yaw, two_pi)], dim=-1)


def vehicle_frame_quat(q):
    yaw = get_euler_xyz_tensor(q)[..., 2]
    zeros = torch.zeros_like(yaw)
    return quat_from_euler_xyz(zeros, zeros, yaw)


def quat_integrate(q, omega_world, dt):
    angle = safe_norm(omega_world, dim=-1, keepdim=True)
    half = 0.5 * dt * angle
    k = 0.5 * dt * torch.sinc(half / math.pi)
    dq = torch.cat([omega_world * k, torch.cos(half)], dim=-1)
    return normalize(quat_mul(dq, q))
