"""Port parity for fused attention: the port's plain version
(ops/attention.attention_reference, what CPU tensors run and what the
CUDA kernel is held against on the card) against the JAX package's XLA
oracle and its Pallas kernel in interpret mode, on the same numpy-seeded
inputs; and the wrapper's contract on the CPU.

Tolerances: f32 atol 1e-5 (the same sums in another order); bf16 atol
0.05 (the two frameworks round the probabilities and the output to bf16
at different places), as tests/test_attention_pallas.py holds the Pallas
kernel to its oracle.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_gym_simulator_tpu.ops.attention_pallas import attention_oracle
from aerial_gym_simulator_tpu.ops.attention_pallas import fused_attention as j_fused

from aerial_gym_simulator_tpu_torch.ops import attention_cuda as ac
from aerial_gym_simulator_tpu_torch.ops.attention import attention_reference

CASES = [
    pytest.param((2, 17, 128, 4), "float32", 1e-5, id="f32-2x17x128-h4"),
    pytest.param((1, 225, 128, 4), "float32", 1e-5, id="f32-1x225x128-h4"),
    pytest.param((2, 225, 256, 8), "bfloat16", 0.05, id="bf16-2x225x256-h8"),
    # heads above 128 columns: 256 (the one-pass wide kernels' width; one head,
    # then two), and 512 (the sliced kernels')
    pytest.param((1, 33, 256, 1), "float32", 1e-5, id="f32-1x33x256-h1"),
    pytest.param((1, 17, 512, 2), "float32", 1e-5, id="f32-1x17x512-h2"),
    pytest.param((1, 33, 512, 2), "bfloat16", 0.05, id="bf16-1x33x512-h2"),
    pytest.param((1, 17, 512, 1), "float32", 1e-5, id="f32-1x17x512-h1"),
]


def _qkv(shape, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(shape[:3]).astype(np.float32) for _ in range(3)]


def _both(shape, dtype):
    """numpy q, k, v -> (jax arrays, torch tensors) in ``dtype``."""
    arrays = _qkv(shape)
    j = [jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrays]
    t = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return j, t


@pytest.mark.parametrize("shape,dtype,atol", CASES)
def test_plain_version_matches_jax_oracle(shape, dtype, atol):
    j, t = _both(shape, dtype)
    ref = np.asarray(attention_oracle(*j, shape[3]).astype(jnp.float32))
    out = attention_reference(*t, shape[3])
    assert out.dtype == getattr(torch, dtype) and tuple(out.shape) == shape[:3]
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=0)


@pytest.mark.parametrize("shape,dtype,atol", CASES)
def test_plain_version_matches_pallas_kernel_interpreted(shape, dtype, atol):
    j, t = _both(shape, dtype)
    ref = np.asarray(j_fused(*j, shape[3], interpret=True).astype(jnp.float32))
    out = ac.fused_attention(*t, shape[3])       # CPU tensors: the plain version
    np.testing.assert_allclose(out.float().numpy(), ref, atol=atol, rtol=0)


def test_sm_scale_is_honoured():
    (j, t), h = _both((2, 17, 128, 4), "float32"), 4
    ref = np.asarray(attention_oracle(*j, h, sm_scale=0.05))
    np.testing.assert_allclose(attention_reference(*t, h, sm_scale=0.05).numpy(), ref,
                               atol=1e-5, rtol=0)


def test_fused_backward_runs_the_plain_backward_on_cpu():
    """On CPU tensors the fused function's backward runs the plain backward
    and agrees with autograd through the plain version (f32, 1e-5: the same
    formulas)."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _qkv((2, 17, 128, 4)))
    out = ac.fused_attention(q, k, v, 4)
    assert out.requires_grad
    out.square().sum().backward()
    fused = [x.grad.clone() for x in (q, k, v)]
    for x in (q, k, v):
        x.grad = None
    attention_reference(q, k, v, 4).square().sum().backward()
    for g, x in zip(fused, (q, k, v)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), x.grad.numpy(), atol=1e-5, rtol=0)


def test_wrapper_counts_no_launch_on_cpu_and_rejects_bad_shapes():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 17, 128, 4)))
    before = dict(ac.LAUNCHES)
    ac.fused_attention(q, k, v, 4)
    assert ac.LAUNCHES == before
    with pytest.raises(ValueError, match="divisible"):
        ac.fused_attention(q, k, v, 3)
    with pytest.raises(ValueError):
        ac.fused_attention(q[0], k[0], v[0], 4)
