"""Port parity: aerial_gym_simulator_tpu_torch.utils.math against the JAX
package's utils/math.py on the same random batches (numpy, fixed seed).

Tolerance: atol 1e-6. Both sides run the same f32 formulas on the CPU;
what differs is rounding order inside library calls (sin/cos/atan2 and
reductions), a few ulp of values of order 1.
"""

import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aerial_gym_simulator_tpu.utils import math as jm
from aerial_gym_simulator_tpu_torch.utils import math as tm

ATOL = 1e-6
N = 257


def _rng(seed=0):
    return np.random.RandomState(seed)


def _quats(rs, n=N):
    q = rs.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _vecs(rs, n=N, scale=3.0):
    return (rs.uniform(-scale, scale, size=(n, 3))).astype(np.float32)


def _close(a_torch, b_jax, atol=ATOL):
    np.testing.assert_allclose(a_torch.numpy(), np.asarray(b_jax), atol=atol, rtol=0)


def _args(kind, rs):
    if kind == "q":
        return _quats(rs)
    if kind == "v":
        return _vecs(rs)
    if kind == "s":
        return rs.uniform(-3, 3, size=(N,)).astype(np.float32)
    raise ValueError(kind)


CASES = {
    "quat_rotate": ("qv", lambda m, q, v: m.quat_rotate(q, v)),
    "quat_rotate_inverse": ("qv", lambda m, q, v: m.quat_rotate_inverse(q, v)),
    "quat_mul": ("qq", lambda m, a, b: m.quat_mul(a, b)),
    "quat_to_rotation_matrix": ("q", lambda m, q: m.quat_to_rotation_matrix(q)),
    "quat_from_euler_xyz": ("sss", lambda m, r, p, y: m.quat_from_euler_xyz(r, p, y)),
    "quat_from_euler_xyz_tensor": ("v", lambda m, e: m.quat_from_euler_xyz_tensor(e)),
    "quat_integrate": ("qv", lambda m, q, w: m.quat_integrate(q, w, 0.01)),
    "quat_integrate_large_step": ("qv", lambda m, q, w: m.quat_integrate(q, 10.0 * w, 0.05)),
    "tf_apply": ("qvv", lambda m, q, t, v: m.tf_apply(q, t, v)),
    "safe_sqrt": ("s", lambda m, x: m.safe_sqrt(x)),
    "safe_norm": ("v", lambda m, x: m.safe_norm(x)),
    "interpolate_ratio": ("vvv", lambda m, lo, hi, r: m.interpolate_ratio(lo, hi, r)),
    "tensor_clamp": ("vvv", lambda m, x, lo, hi: m.tensor_clamp(x, lo, lo + abs(hi))),
    "normalize": ("v", lambda m, x: m.normalize(x)),
    "ssa": ("s", lambda m, a: m.ssa(4.0 * a)),
    "rotation_matrix_to_quat": ("q", lambda m, q: m.rotation_matrix_to_quat(
        m.quat_to_rotation_matrix(q))),
    "vehicle_frame_quat_from_quat": ("q", lambda m, q: m.vehicle_frame_quat_from_quat(q)),
    "quat_apply_inverse": ("qv", lambda m, q, v: m.quat_apply_inverse(q, v)),
    "exp_penalty_func": ("s", lambda m, x: m.exp_penalty_func(x, 0.3, 4.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_math_matches_jax(name):
    kinds, fn = CASES[name]
    rs = _rng(zlib.crc32(name.encode()) % 1000)
    args = [_args(k, rs) for k in kinds]
    out_t = fn(tm, *[torch.from_numpy(a) for a in args])
    out_j = fn(jm, *[jnp.asarray(a) for a in args])
    if name == "rotation_matrix_to_quat":
        # q and -q are the same rotation: compare with the sign of w fixed
        out_t = out_t * torch.sign(out_t[..., 3:4])
        out_j = out_j * jnp.sign(out_j[..., 3:4])
    _close(out_t, out_j)


def test_euler_angles_match_jax():
    """get_euler_xyz wraps mod 2*pi, so compare on the circle (cos, sin):
    an angle a hair below 0 wraps to ~2*pi on one side and not the other."""
    q = _quats(_rng(3))
    e_t = tm.get_euler_xyz_tensor(torch.from_numpy(q)).numpy()
    e_j = np.asarray(jm.get_euler_xyz_tensor(jnp.asarray(q)))
    np.testing.assert_allclose(np.cos(e_t), np.cos(e_j), atol=ATOL)
    np.testing.assert_allclose(np.sin(e_t), np.sin(e_j), atol=ATOL)


def test_safe_functions_have_finite_gradients_at_zero():
    x = torch.zeros(4, 3, requires_grad=True)
    tm.safe_norm(x).sum().backward()
    assert torch.isfinite(x.grad).all()
