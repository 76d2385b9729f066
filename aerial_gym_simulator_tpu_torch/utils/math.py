"""Batched quaternion / SO(3) math on torch tensors.

Counterpart of ``aerial_gym_simulator_tpu/utils/math.py``. Conventions are
the same:

  * quaternions are ``[x, y, z, w]`` (scalar last),
  * euler angles are intrinsic XYZ (roll, pitch, yaw),
  * every function broadcasts over arbitrary leading batch dims.

Functions are plain elementwise tensor code; they run on whatever device
their inputs live on.
"""

from __future__ import annotations

import math

import torch

# ---------------------------------------------------------------------------
# generic helpers
# ---------------------------------------------------------------------------


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt(max(x, 0)) with a zero (finite) gradient at and below zero."""
    pos = x > 0
    return torch.where(pos, torch.sqrt(torch.where(pos, x, torch.ones_like(x))),
                       torch.zeros_like(x))


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    """L2 norm with a zero gradient at x = 0 (forward equals the norm)."""
    return safe_sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def normalize(x: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Unit-normalize along the last axis (safe for zero vectors)."""
    n = safe_norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def tensor_clamp(t, lo, hi):
    """min(max(t, lo), hi); lo/hi are numbers or broadcastable tensors."""
    if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
        return torch.minimum(torch.maximum(t, lo), hi)
    return torch.clamp(t, lo, hi)


def ssa(a: torch.Tensor) -> torch.Tensor:
    """Smallest signed angle, wraps to [-pi, pi)."""
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def normalize_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap an angle to (-pi, pi] through atan2(sin x, cos x)."""
    return torch.atan2(torch.sin(x), torch.cos(x))


def scale_transform(x, lower, upper):
    """Map x in [-1, 1] -> [lower, upper]."""
    return 0.5 * (x + 1.0) * (upper - lower) + lower


def unscale_transform(x, lower, upper):
    """Map x in [lower, upper] -> [-1, 1]."""
    return (2.0 * x - upper - lower) / (upper - lower)


def interpolate_ratio(lo, hi, ratio):
    """lo + (hi - lo) * ratio."""
    return lo + (hi - lo) * ratio


def exponential_reward(magnitude, base_width, value):
    """magnitude * exp(-value^2 / base_width)."""
    return magnitude * torch.exp(-(value * value) / base_width)


def exponential_penalty(magnitude, base_width, value):
    """magnitude * (exp(-value^2 / base_width) - 1): 0 at value = 0."""
    return magnitude * (torch.exp(-(value * value) / base_width) - 1.0)


def rowwise_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for a small inner size, the products over the inner index
    summed in its order, elementwise: each output row depends on its own row
    alone. A GEMM picks its kernel, and so its rounding, by the row count,
    which would make a block of envs round unlike the same envs in the whole
    batch. On an H100 cuBLAS does so for the two products that go through
    here: the allocation (N, 6) @ (6, 4) (``sim/dynamics.py``) and the
    batched 3x3 matrix-vector product of the obstacle frames
    (``ops/raycast_cuda.pack_prims_world``); the step's other small products
    were found bit-equal across row counts and stay ``@``."""
    out = a[..., :, 0:1] * b[..., 0:1, :]
    for k in range(1, a.shape[-1]):
        out = out + a[..., :, k:k + 1] * b[..., k:k + 1, :]
    return out


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, written out elementwise so it
    broadcasts like jnp.cross."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx],
                       dim=-1)


def compute_vee_map(skew: torch.Tensor) -> torch.Tensor:
    """Vee map of a (...,3,3) skew-symmetric matrix -> (...,3)."""
    return torch.stack([-skew[..., 1, 2], skew[..., 0, 2], -skew[..., 0, 1]], dim=-1)


def hat_map(v: torch.Tensor) -> torch.Tensor:
    """Hat (skew) map of a (...,3) vector -> (...,3,3); compute_vee_map
    inverts it."""
    zeros = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([zeros, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], zeros, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], zeros], dim=-1),
    ], dim=-2)


def pd_control(pos_error, vel_error, stiffness, damping):
    return stiffness * pos_error + damping * vel_error


# ---------------------------------------------------------------------------
# quaternion algebra (xyzw, scalar-last)
# ---------------------------------------------------------------------------


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b for xyzw quaternions, broadcasting batch dims."""
    ax, ay, az, aw = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bx, by, bz, bw = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    x = aw * bx + ax * bw + ay * bz - az * by
    y = aw * by - ax * bz + ay * bw + az * bx
    z = aw * bz + ax * by - ay * bx + az * bw
    w = aw * bw - ax * bx - ay * by - az * bz
    return torch.stack([x, y, z, w], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:4]], dim=-1)


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Inverse of a unit quaternion (its conjugate)."""
    return quat_conjugate(q)


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    return normalize(q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (body -> world)."""
    q_w = q[..., 3:4]
    q_vec = q[..., :3]
    a = v * (2.0 * q_w * q_w - 1.0)
    b = cross(q_vec, v) * (2.0 * q_w)
    c = q_vec * (2.0 * torch.sum(q_vec * v, dim=-1, keepdim=True))
    return a + b + c


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by q^{-1} (world -> body)."""
    q_w = q[..., 3:4]
    q_vec = q[..., :3]
    a = v * (2.0 * q_w * q_w - 1.0)
    b = cross(q_vec, v) * (2.0 * q_w)
    c = q_vec * (2.0 * torch.sum(q_vec * v, dim=-1, keepdim=True))
    return a - b + c


def quat_apply_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return quat_rotate_inverse(q, v)


def quat_axis(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Column ``axis`` of the rotation matrix of q (a rotated basis vector)."""
    e = torch.zeros(q.shape[:-1] + (3,), dtype=q.dtype, device=q.device)
    e[..., axis] = 1.0
    return quat_rotate(q, e)


def exp_func(x, gain: float, exp: float):
    """gain * exp(-exp * x^2): reward shaping of the setpoint tasks."""
    return gain * torch.exp(-exp * x * x)


def exp_penalty_func(x, gain: float, exp: float):
    """gain * (exp(-exp * x^2) - 1): a penalty that is 0 at x = 0."""
    return gain * (torch.exp(-exp * x * x) - 1.0)


def quat_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """(...,4) xyzw -> (...,3,3) rotation matrix."""
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def rotation_matrix_to_quat(m: torch.Tensor) -> torch.Tensor:
    """(...,3,3) -> (...,4) xyzw, branch-free Shepperd's method: all four
    candidates are evaluated and the numerically strongest is selected."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]

    qw2 = torch.clamp(1.0 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1.0 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1.0 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1.0 - m00 - m11 + m22, min=0.0)

    qw = 0.5 * safe_sqrt(qw2)
    qx = 0.5 * safe_sqrt(qx2)
    qy = 0.5 * safe_sqrt(qy2)
    qz = 0.5 * safe_sqrt(qz2)

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

    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    best = torch.argmax(mags, dim=-1)                        # (...)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)            # (..., 4, 4)
    idx = best[..., None, None].expand(best.shape + (1, 4))
    q = torch.gather(cands, -2, idx).squeeze(-2)
    return normalize(q)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    """Intrinsic XYZ euler angles -> xyzw quaternion."""
    cy = torch.cos(yaw * 0.5)
    sy = torch.sin(yaw * 0.5)
    cr = torch.cos(roll * 0.5)
    sr = torch.sin(roll * 0.5)
    cp = torch.cos(pitch * 0.5)
    sp = torch.sin(pitch * 0.5)
    qw = cy * cr * cp + sy * sr * sp
    qx = cy * sr * cp - sy * cr * sp
    qy = cy * cr * sp + sy * sr * cp
    qz = sy * cr * cp - cy * sr * sp
    return torch.stack([qx, qy, qz, qw], dim=-1)


def quat_from_euler_xyz_tensor(euler: torch.Tensor) -> torch.Tensor:
    return quat_from_euler_xyz(euler[..., 0], euler[..., 1], euler[..., 2])


def get_euler_xyz(q: torch.Tensor):
    """xyzw quaternion -> (roll, pitch, yaw), each wrapped mod 2*pi."""
    qx, qy, qz, qw = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    sinr_cosp = 2.0 * (qw * qx + qy * qz)
    cosr_cosp = qw * qw - qx * qx - qy * qy + qz * qz
    roll = torch.atan2(sinr_cosp, cosr_cosp)

    sinp = 2.0 * (qw * qy - qz * qx)
    sat = torch.abs(sinp) >= 1.0
    pitch = torch.where(
        sat,
        torch.sign(sinp) * (math.pi / 2.0),
        torch.asin(torch.where(sat, torch.zeros_like(sinp),
                               torch.clamp(sinp, -1.0, 1.0))),
    )

    siny_cosp = 2.0 * (qw * qz + qx * qy)
    cosy_cosp = qw * qw + qx * qx - qy * qy - qz * qz
    yaw = torch.atan2(siny_cosp, cosy_cosp)

    two_pi = 2.0 * math.pi
    return (torch.remainder(roll, two_pi), torch.remainder(pitch, two_pi),
            torch.remainder(yaw, two_pi))


def get_euler_xyz_tensor(q: torch.Tensor) -> torch.Tensor:
    return torch.stack(get_euler_xyz(q), dim=-1)


def vehicle_frame_quat_from_quat(body_quat: torch.Tensor) -> torch.Tensor:
    """Yaw-only ('vehicle frame') quaternion from a full-body quaternion."""
    yaw = get_euler_xyz_tensor(body_quat)[..., 2]
    zeros = torch.zeros_like(yaw)
    return quat_from_euler_xyz(zeros, zeros, yaw)


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """Unit xyzw quaternion of a rotation by ``angle`` (...) about ``axis``
    (..., 3), which need not be unit length."""
    theta = (angle / 2.0)[..., None]
    xyz = normalize(axis) * torch.sin(theta)
    return quat_unit(torch.cat([xyz, torch.cos(theta)], dim=-1))


def quat_integrate(q: torch.Tensor, omega_world: torch.Tensor, dt) -> torch.Tensor:
    """Integrate a unit quaternion by world-frame angular velocity over dt
    with the exponential map q' = exp(0.5 dt omega) q, renormalized."""
    angle = safe_norm(omega_world, dim=-1, keepdim=True)
    half = 0.5 * dt * angle
    k = 0.5 * dt * torch.sinc(half / math.pi)  # = sin(half) / angle
    dq = torch.cat([omega_world * k, torch.cos(half)], dim=-1)
    return quat_unit(quat_mul(dq, q))


# ---------------------------------------------------------------------------
# rigid transforms
# ---------------------------------------------------------------------------


def tf_apply(q, t, v):
    return quat_rotate(q, v) + t


def tf_vector(q, v):
    return quat_rotate(q, v)


def tf_inverse(q, t):
    """The inverse of the transform (q, t) -> (q^-1, -(q^-1 t))."""
    q_inv = quat_conjugate(q)
    return q_inv, -quat_rotate(q_inv, t)


def tf_combine(q1, t1, q2, t2):
    """(q1, t1) after (q2, t2): (q1 q2, q1 t2 + t1)."""
    return quat_mul(q1, q2), quat_rotate(q1, t2) + t1


def get_basis_vector(q, v):
    return quat_rotate(q, v)
