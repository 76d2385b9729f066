"""Port parity for fused attention: the port's plain version
(ops/attention.attention_reference, what CPU tensors run and what the
CUDA kernel is held against on the card) against the JAX package's XLA
oracle and its Pallas kernel in interpret mode, on the same numpy-seeded
inputs; and the wrapper's contract on the CPU.

Tolerances: f32 atol 1e-5 (the same sums in another order); bf16 atol
0.05 (the two frameworks round the probabilities and the output to bf16
at different places), as tests/test_attention_pallas.py holds the Pallas
kernel to its oracle.

The ring serving kernel's order of work (csrc/attention.cu,
``attention_ring_kernel``) is emulated here too, before any card runs it:
keys in chunks of ``kServeChunk`` with a short last chunk, each warp's row
max moved only when a row outgrows it by ``kRescaleSlack`` (log2 units),
P rounded to bf16 before P V, the row sums of the unrounded P. It is held
to the JAX oracle at the bf16 bar (0.05) and its L to the plain log-sum-exp
at the kernel's bar (1e-4).
"""

import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_gym_simulator_tpu.ops.attention_pallas import attention_oracle
from aerial_gym_simulator_tpu.ops.attention_pallas import fused_attention as j_fused

from aerial_gym_simulator_tpu_torch.ops import attention_cuda as ac
from aerial_gym_simulator_tpu_torch.ops.attention import (attention_lse_reference,
                                                         attention_reference)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


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


def _serving_constants():
    """The ring kernel's chunk, slack and block shape, read from its
    source so that the emulation follows the kernel: (chunk, slack, {head
    size: (warps, row tiles a warp)})."""
    src = (Path(ac.__file__).resolve().parent.parent / "csrc" / "attention.cu").read_text()
    chunk = int(re.search(r"constexpr int kServeChunk = (\d+);", src).group(1))
    slack = float(re.search(r"constexpr float kRescaleSlack = ([\d.]+)f;", src).group(1))
    def per_head(name):                # "kX = HD == 32 ? a : b;" or "kX = a;"
        found = re.search(rf"int {name} = (?:HD == 32 \? (\d+) : )?(\d+);", src).groups()
        return {32: int(found[0] or found[1]), 64: int(found[1])}
    warps, tiles = per_head("kWarps"), per_head("kTiles")
    return chunk, slack, {hd: (warps[hd], tiles[hd]) for hd in (32, 64)}


def _emulated_serving_kernel(q, k, v, heads):
    """The ring kernel's arithmetic on (B, S, D) bf16 tensors in plain
    torch -> (o bf16, L f32 (B, H, S), the largest P seen). Keys in chunks of
    kServeChunk (the last one short); per chunk each row's max in log2 units,
    and the rows of one warp (the kernel's row tiles w, w + warps, ... of a
    block) take new maxima together, only when one of them passed the max in
    use by the slack; p = 2^(s scale log2e - m) in f32, summed unrounded,
    rounded to bf16 for P V."""
    chunk, slack, shape = _serving_constants()
    B, S, D = q.shape
    hd = D // heads
    warps, tiles = shape[hd]
    rows = warps * tiles * 16
    sl2 = math.log2(math.e) / math.sqrt(hd)
    split = lambda x: x.reshape(B, S, heads, hd).transpose(1, 2).float()
    qh, kh, vh = split(q), split(k), split(v)
    r = torch.arange(S)
    warp_of = (r // rows) * warps + (r % rows) // 16 % warps            # (S,)
    n_groups = int(warp_of.max()) + 1
    m = torch.full((B, heads, S), -math.inf)
    l = torch.zeros((B, heads, S))
    o = torch.zeros((B, heads, S, hd))
    p_max = 0.0
    for key0 in range(0, S, chunk):
        kc, vc = kh[:, :, key0:key0 + chunk], vh[:, :, key0:key0 + chunk]
        s = qh @ kc.transpose(-1, -2)
        c = s.amax(-1) * sl2
        grow = (c > m + slack).float()
        warp_grow = torch.zeros((B, heads, n_groups)).index_reduce_(
            2, warp_of, grow, "amax", include_self=True)[..., warp_of] > 0
        new_m = torch.where(warp_grow, torch.maximum(m, c), m)
        alpha = torch.exp2(m - new_m)
        alpha = torch.where(warp_grow, alpha, torch.ones_like(alpha))
        m = new_m
        p = torch.exp2(s * sl2 - m[..., None])
        p_max = max(p_max, float(p.max()))
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + p.to(torch.bfloat16).float() @ vc
    out = (o / l[..., None]).transpose(1, 2).reshape(B, S, D).to(q.dtype)
    return out, (m + torch.log2(l)) * math.log(2.0), p_max


@pytest.mark.parametrize("shape", [(4, 225, 256, 8), (2, 900, 256, 4)], ids=str)
def test_serving_kernel_order_matches_jax_oracle(shape):
    """The emulated ring kernel (the ViT's shape at head size 32, and
    past the old shared-memory limit at head size 64) against the JAX
    oracle at the bf16 bar, its L against the plain log-sum-exp, and P
    never above 2^kRescaleSlack."""
    j, t = _both(shape, "bfloat16")
    want = np.asarray(attention_oracle(*j, shape[3]).astype(jnp.float32))
    out, lse, p_max = _emulated_serving_kernel(*t, shape[3])
    np.testing.assert_allclose(out.float().numpy(), want, atol=0.05, rtol=0.05)
    torch.testing.assert_close(lse, attention_lse_reference(t[0], t[1], shape[3]), atol=1e-4,
                               rtol=1e-4)
    assert p_max <= 2.0 ** _serving_constants()[1]


def test_serving_kernel_computes_scores_of_real_keys_and_row_tiles():
    """At the ViT's S = 225 the ring kernel computes 240 rows (15 tiles of 16:
    a warp skips its tiles past S) x 232 keys (seven 32-key chunks and one
    8-key tile for the last key): 10% more scores than 225^2, where the
    staged kernel computes 240 x 256 (21%)."""
    chunk, _, shape = _serving_constants()
    S = 225
    warps, tiles = shape[32]
    rows = warps * tiles * 16                               # a block's rows
    tiles_run = sum(1 for r0 in range(0, S, rows) for w in range(warps) for i in range(tiles)
                    if r0 + (w + i * warps) * 16 < S)
    keys = (S // chunk) * chunk + -(-(S % chunk) // 8) * 8
    assert (tiles_run * 16, keys) == (240, 232)
    assert tiles_run * 16 * keys / S ** 2 < 1.1
