"""Port parity for the fused attention backward: the port's plain backward
(ops/attention.attention_backward_reference, what CPU tensors run under
autograd and what the CUDA kernel is held against on the card) against
jax.vjp through the JAX package's XLA oracle and through its Pallas kernels
in interpret mode, on the same numpy-seeded inputs.

The kernels' precision scheme is checked here too, before any card runs
it: each f32 product as three TF32 products (3xTF32, emulated in plain
torch by rounding to TF32 with a bit mask), the row log-sum-exp L saved by
the forward, P recomputed from it and delta = rowsum(dO o) in the backward,
against the JAX oracle and jax.grad.

Tolerances: f32 atol = rtol 2e-4, the bar tests/test_attention_pallas.py
holds the Pallas backward to (the same sums in another order); bf16 atol
0.05 + rtol 0.05 (both sides compute in f32 from bf16 inputs, the JAX
oracle rounds P to bf16 before the second product and the results are
rounded to bf16 once more); the adversarial case 1e-3 against autograd
through the port's own plain forward. The emulated 3xTF32 scheme is held
to the kernels' own bars on the card: forward 1e-4 and backward 2e-4, and
1e-2 in the adversarial case (a product of 3xTF32 is good to about 2^-21
of the sum of |q_i k_i|, 3e-3 of a logit of order 1e3 at worst).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from aerial_gym_simulator_tpu.ops.attention_pallas import attention_oracle
from aerial_gym_simulator_tpu.ops.attention_pallas import fused_attention as j_fused

from aerial_gym_simulator_tpu_torch.ops import attention_cuda as ac
from aerial_gym_simulator_tpu_torch.ops.attention import (
    attention_backward_reference, attention_lse_reference, attention_reference)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# (B, S, D, heads): the shapes of tests/test_attention_pallas.py
SHAPES = [
    pytest.param((2, 128, 64, 2), id="2x128x64-h2"),       # no padding on the TPU
    pytest.param((2, 100, 64, 4), id="2x100x64-h4"),       # padded 100 -> 128 there
    pytest.param((1, 225, 128, 4), id="1x225x128-h4"),     # the ViT sequence
    pytest.param((1, 33, 256, 1), id="1x33x256-h1"),       # head 256: the one-pass wide kernels
    pytest.param((1, 17, 512, 2), id="1x17x512-h2"),       # head 256, two heads
    pytest.param((1, 17, 512, 1), id="1x17x512-h1"),       # head 512: the sliced kernels
]


def _inputs(shape, seed=0, n=4):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal(shape[:3]).astype(np.float32) for _ in range(n)]


def _jax_vjp(fn, arrays, heads, dtype=jnp.float32):
    q, k, v, do = (jnp.asarray(a).astype(dtype) for a in arrays)
    _, pull = jax.vjp(lambda q, k, v: fn(q, k, v, heads), q, k, v)
    return [np.asarray(g.astype(jnp.float32)) for g in pull(do)]


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_jax_grad_of_oracle(shape):
    arrays = _inputs(shape)
    want = _jax_vjp(attention_oracle, arrays, shape[3])
    got = attention_backward_reference(*(torch.from_numpy(a) for a in arrays), shape[3])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape[:3]
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=2e-4, err_msg=name)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_backward_interpreted(shape):
    arrays = _inputs(shape, seed=1)
    fused = lambda q, k, v, h: j_fused(q, k, v, h, interpret=True)
    want = _jax_vjp(fused, arrays, shape[3])
    got = attention_backward_reference(*(torch.from_numpy(a) for a in arrays), shape[3])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=2e-4, err_msg=name)


def test_plain_backward_bf16_matches_pallas_backward_interpreted():
    shape = (2, 225, 128, 4)
    arrays = _inputs(shape, seed=2)
    fused = lambda q, k, v, h: j_fused(q, k, v, h, interpret=True)
    want = _jax_vjp(fused, arrays, shape[3], jnp.bfloat16)
    got = attention_backward_reference(*(torch.from_numpy(a).bfloat16() for a in arrays),
                                       shape[3])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=0.05, rtol=0.05, err_msg=name)


def test_plain_backward_bf16_at_head_256_matches_pallas_backward_interpreted():
    """One head of 256 columns in bf16, the one-pass wide kernels' width."""
    shape = (1, 33, 256, 1)
    arrays = _inputs(shape, seed=12)
    fused = lambda q, k, v, h: j_fused(q, k, v, h, interpret=True)
    want = _jax_vjp(fused, arrays, shape[3], jnp.bfloat16)
    got = attention_backward_reference(*(torch.from_numpy(a).bfloat16() for a in arrays),
                                       shape[3])
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        np.testing.assert_allclose(g.float().numpy(), w, atol=0.05, rtol=0.05, err_msg=name)


def test_backward_honours_sm_scale():
    shape = (2, 17, 64, 4)
    arrays = _inputs(shape, seed=3)
    want = _jax_vjp(lambda q, k, v, h: attention_oracle(q, k, v, h, sm_scale=0.05), arrays, 4)
    got = attention_backward_reference(*(torch.from_numpy(a) for a in arrays), 4, sm_scale=0.05)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=2e-4)


def _autograd(fn, arrays, heads, loss):
    q, k, v = (torch.from_numpy(a).clone().requires_grad_(True) for a in arrays[:3])
    loss(fn(q, k, v, heads)).backward()
    return [x.grad for x in (q, k, v)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_attention_differentiates_on_cpu_tensors(shape):
    """The autograd function's backward on CPU tensors is the plain backward
    and agrees with autograd through the plain forward; no kernel launch is
    counted."""
    arrays = _inputs(shape, seed=4)
    target = torch.from_numpy(arrays[3])
    loss = lambda o: ((o - target) ** 2).sum()
    before = dict(ac.LAUNCHES)
    got = _autograd(ac.fused_attention, arrays, shape[3], loss)
    assert ac.LAUNCHES == before
    want = _autograd(attention_reference, arrays, shape[3], loss)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-4, rtol=2e-4, err_msg=name)


def test_fused_attention_gradients_match_jax_grad_of_loss():
    """The whole chain as tests/test_attention_pallas.py::
    test_fused_gradients_match_oracle runs it: sum((attention - target)^2)."""
    shape = (2, 100, 64, 4)
    arrays = _inputs(shape, seed=5)
    tgt = jnp.asarray(arrays[3])
    j_loss = lambda q, k, v: jnp.sum((attention_oracle(q, k, v, 4) - tgt) ** 2)
    want = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays[:3]))
    target = torch.from_numpy(arrays[3])
    got = _autograd(ac.fused_attention, arrays, 4, lambda o: ((o - target) ** 2).sum())
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, rtol=2e-4,
                                   err_msg=name)


def test_backward_survives_adversarial_magnitudes():
    """q and k scaled by 30 (logits of order 1e3 before scaling), the case of
    test_padding_mask_survives_adversarial_magnitudes: gradients finite and
    equal to autograd through the plain forward."""
    shape = (1, 96, 64, 2)
    arrays = _inputs(shape, seed=6)
    arrays[0], arrays[1] = arrays[0] * 30.0, arrays[1] * 30.0
    loss = lambda o: (o ** 2).sum()
    got = _autograd(ac.fused_attention, arrays, 2, loss)
    want = _autograd(attention_reference, arrays, 2, loss)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-3, rtol=1e-3)
    j_loss = lambda q, k, v: jnp.sum(j_fused(q, k, v, 2, interpret=True) ** 2)
    j_grads = jax.grad(j_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in arrays[:3]))
    for g, w in zip(got, j_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3, rtol=1e-3)


def test_fused_attention_works_under_activation_checkpointing():
    shape = (2, 17, 64, 4)
    arrays = _inputs(shape, seed=7)
    loss = lambda o: (o ** 2).sum()
    fused_ckpt = lambda q, k, v, h: checkpoint(ac.fused_attention, q, k, v, h,
                                               use_reentrant=False)
    got = _autograd(fused_ckpt, arrays, 4, loss)
    want = _autograd(ac.fused_attention, arrays, 4, loss)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_backward_takes_a_non_contiguous_output_gradient():
    shape = (3, 17, 64, 4)
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(shape, seed=8))
    strided = do.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    for a, b in zip(ac.attention_backward(q, k, v, strided, 4),
                    attention_backward_reference(q, k, v, do, 4)):
        assert torch.equal(a, b)


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mm3(a, b):
    """a @ b as the kernels run an f32 product: a = a_hi + a_lo, b = b_hi +
    b_lo, all four TF32, and a_lo b_hi + a_hi b_lo + a_hi b_hi summed in
    f32 (a TF32 product is exact in f32)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _split_heads(x, heads):
    b, s, d = x.shape
    return x.reshape(b, s, heads, d // heads).transpose(1, 2)


def _merge_heads(x):
    b, h, s, hd = x.shape
    return x.transpose(1, 2).reshape(b, s, h * hd)


def _emulated_3xtf32(q, k, v, do, heads):
    """The kernels' f32 arithmetic in plain torch -> (o, L, dq, dk, dv): the
    forward keeps L, the backward recomputes P from it and takes delta from
    the forward's output."""
    scale = 1.0 / np.sqrt(q.shape[2] // heads)
    qh, kh, vh, doh = (_split_heads(x, heads) for x in (q, k, v, do))
    s = _mm3(qh, kh.transpose(-1, -2)) * scale
    lse = torch.logsumexp(s, dim=-1)
    o = _mm3(torch.exp(s - lse[..., None]), vh)
    p = torch.exp(_mm3(qh, kh.transpose(-1, -2)) * scale - lse[..., None])
    delta = (doh * o).sum(-1, keepdim=True)
    ds = p * (_mm3(doh, vh.transpose(-1, -2)) - delta)
    dq = _mm3(ds, kh) * scale
    dk = _mm3(ds.transpose(-1, -2), qh) * scale
    dv = _mm3(p.transpose(-1, -2), doh)
    return _merge_heads(o), lse, _merge_heads(dq), _merge_heads(dk), _merge_heads(dv)


def _emulated_wide(q, k, v, do, heads):
    """The one-pass wide kernels' f32 arithmetic in plain torch -> (o, L, dq,
    dk, dv). Forward: two warpgroups each run an online softmax over their
    16 keys of every 32-key tile (keys 0-15 and 16-31), 3xTF32 products, and
    their (m, l, o) states are merged once at the end; a warpgroup that saw
    no key keeps m = -inf and weighs nothing. Backward: P recomputed from the
    merged L, its logits (and dP) summed from the head's two 128-column
    halves (one warp each), dQ summed over 16-key tiles in order, dK and dV
    over 16-query tiles in order."""
    scale = 1.0 / np.sqrt(q.shape[2] // heads)
    qh, kh, vh, doh = (_split_heads(x, heads) for x in (q, k, v, do))
    S = q.shape[1]
    states = []
    for grp in (0, 1):
        m = torch.full(qh.shape[:-1], -np.inf)
        l, o = torch.zeros(qh.shape[:-1]), torch.zeros(qh.shape)
        for k0 in range(16 * grp, S, 32):
            kc, vc = kh[..., k0:k0 + 16, :], vh[..., k0:k0 + 16, :]
            s = _mm3(qh, kc.transpose(-1, -2)) * scale
            m_new = torch.maximum(m, s.amax(-1))
            a, p = torch.exp(m - m_new), torch.exp(s - m_new[..., None])
            l, o, m = l * a + p.sum(-1), o * a[..., None] + _mm3(p, vc), m_new
        states.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = states
    n = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - n), torch.exp(m1 - n)
    l = l0 * a0 + l1 * a1
    o = (o0 * a0[..., None] + o1 * a1[..., None]) / l[..., None]
    lse = n + torch.log(l)
    delta = (doh * o).sum(-1, keepdim=True)
    halves = lambda a, b: (_mm3(a[..., :128], b[..., :128].transpose(-1, -2))
                           + _mm3(a[..., 128:], b[..., 128:].transpose(-1, -2)))
    dq, dk, dv = torch.zeros(qh.shape), torch.zeros(qh.shape), torch.zeros(qh.shape)
    for k0 in range(0, S, 16):
        kc, vc = kh[..., k0:k0 + 16, :], vh[..., k0:k0 + 16, :]
        p = torch.exp(halves(qh, kc) * scale - lse[..., None])
        dq = dq + _mm3(p * (halves(doh, vc) - delta), kc)
    for q0 in range(0, S, 16):
        qc, dc = qh[..., q0:q0 + 16, :], doh[..., q0:q0 + 16, :]
        pt = torch.exp(halves(kh, qc) * scale - lse[..., None, q0:q0 + 16])
        dst = pt * (halves(vh, dc) - delta[..., q0:q0 + 16, 0][..., None, :])
        dv, dk = dv + _mm3(pt, dc), dk + _mm3(dst, qc)
    return (_merge_heads(o), lse, _merge_heads(dq * scale), _merge_heads(dk * scale),
            _merge_heads(dv))


def _slices(a, width):
    """The head's columns in consecutive slices of ``width``: (start, slice)."""
    return [(c0, a[..., c0:c0 + width]) for c0 in range(0, a.shape[-1], width)]


def _emulated_cluster(q, k, v, do, heads):
    """The cluster kernels' f32 arithmetic in plain torch -> (o, L, dq, dk,
    dv). Rank c of a cluster owns head columns [256c, 256c + 256): each
    logit tile is the sum over ranks, in rank order, of the ranks' 3xTF32
    partials over their own columns. A forward partial is one product over
    the rank's 256 columns (a warp's whole slice, as in the wide forward); a
    backward partial is the sum of the slice's two 128-column halves (the
    wide kernels' warp pairs). Otherwise the wide kernels' order: two
    warpgroups on the halves of each 32-key tile merged once, dQ over 16-key
    tiles, dK and dV over 16-query tiles; delta = rowsum(dO o) summed over
    the ranks' slices in order."""
    scale = 1.0 / np.sqrt(q.shape[2] // heads)
    qh, kh, vh, doh = (_split_heads(x, heads) for x in (q, k, v, do))
    S = q.shape[1]

    def ranked(parts):
        total = None
        for x in parts:
            total = x if total is None else total + x
        return total

    fwd_logits = lambda a, b: ranked(_mm3(x, b[..., c0:c0 + 256].transpose(-1, -2))
                                     for c0, x in _slices(a, 256))
    # a slice of 128 columns or fewer has an empty second half: a zero partial
    halves = lambda a, b: (_mm3(a[..., :128], b[..., :128].transpose(-1, -2))
                           + _mm3(a[..., 128:], b[..., 128:].transpose(-1, -2)))
    bwd_logits = lambda a, b: ranked(halves(x, b[..., c0:c0 + 256])
                                     for c0, x in _slices(a, 256))
    states = []
    for grp in (0, 1):
        m = torch.full(qh.shape[:-1], -np.inf)
        l, o = torch.zeros(qh.shape[:-1]), torch.zeros(qh.shape)
        for k0 in range(16 * grp, S, 32):
            kc, vc = kh[..., k0:k0 + 16, :], vh[..., k0:k0 + 16, :]
            s = fwd_logits(qh, kc) * scale
            m_new = torch.maximum(m, s.amax(-1))
            a, p = torch.exp(m - m_new), torch.exp(s - m_new[..., None])
            l, o, m = l * a + p.sum(-1), o * a[..., None] + _mm3(p, vc), m_new
        states.append((m, l, o))
    (m0, l0, o0), (m1, l1, o1) = states
    n = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - n), torch.exp(m1 - n)
    l = l0 * a0 + l1 * a1
    o = (o0 * a0[..., None] + o1 * a1[..., None]) / l[..., None]
    lse = n + torch.log(l)
    delta = ranked((x * o[..., c0:c0 + 256]).sum(-1, keepdim=True)
                   for c0, x in _slices(doh, 256))
    dq, dk, dv = torch.zeros(qh.shape), torch.zeros(qh.shape), torch.zeros(qh.shape)
    for k0 in range(0, S, 16):
        kc, vc = kh[..., k0:k0 + 16, :], vh[..., k0:k0 + 16, :]
        p = torch.exp(bwd_logits(qh, kc) * scale - lse[..., None])
        dq = dq + _mm3(p * (bwd_logits(doh, vc) - delta), kc)
    for q0 in range(0, S, 16):
        qc, dc = qh[..., q0:q0 + 16, :], doh[..., q0:q0 + 16, :]
        pt = torch.exp(bwd_logits(kh, qc) * scale - lse[..., None, q0:q0 + 16])
        dst = pt * (bwd_logits(vh, dc) - delta[..., q0:q0 + 16, 0][..., None, :])
        dv, dk = dv + _mm3(pt, dc), dk + _mm3(dst, qc)
    return (_merge_heads(o), lse, _merge_heads(dq * scale), _merge_heads(dk * scale),
            _merge_heads(dv))


@pytest.mark.parametrize("emulated,shape", [
    pytest.param(_emulated_wide, (1, 225, 256, 1), id="1x225x256-h1"),
    pytest.param(_emulated_wide, (2, 17, 384, 2), id="2x17x384-h2"),
    # the cluster kernels: a cluster of 2; of 3 at a short S; head 257,
    # whose second rank holds one real column
    pytest.param(_emulated_cluster, (1, 225, 512, 1), id="cluster-1x225x512-h1"),
    pytest.param(_emulated_cluster, (2, 17, 768, 1), id="cluster-2x17x768-h1"),
    pytest.param(_emulated_cluster, (1, 33, 514, 2), id="cluster-1x33x514-h2"),
])
def test_wide_kernels_order_matches_jax(emulated, shape):
    """The one-pass wide kernels' order of sums (warpgroup merge, tiled
    backward) and the cluster kernels' (the same, with the logits summed
    over the ranks' column slices in rank order), with 3xTF32 products:
    forward within 1e-4 of the JAX oracle, L within 1e-4 of the plain
    log-sum-exp, gradients within 2e-4 of jax.vjp through the oracle; S = 17
    leaves the second warpgroup one key."""
    arrays = _inputs(shape, seed=11)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse, *grads = emulated(q, k, v, do, shape[3])
    want_o = np.asarray(attention_oracle(*(jnp.asarray(a) for a in arrays[:3]), shape[3]))
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), attention_lse_reference(q, k, shape[3]).numpy(),
                               atol=1e-4, rtol=1e-4)
    for name, g, w in zip(("dq", "dk", "dv"), grads,
                          _jax_vjp(attention_oracle, arrays, shape[3])):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=2e-4, err_msg=name)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11, -(1.0 + 3 * 2 ** -12), 3.0],
                     dtype=torch.float32)
    want = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -9, -(1.0 + 2 ** -10), 3.0])
    assert torch.equal(_tf32(x), want)                 # ties away from zero
    r = torch.from_numpy(np.random.RandomState(0).standard_normal(1000).astype(np.float32))
    hi = _tf32(r)
    assert (hi.view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((r - hi).abs() <= r.abs() * 2.0 ** -11).all()


def test_3xtf32_scheme_matches_jax_at_the_training_heads():
    """One (1, 225, 256, 8) head group, the ViT training layer's: forward
    within 1e-4 of the JAX oracle, L within 1e-4 of the plain log-sum-exp,
    gradients within 2e-4 of jax.vjp through the oracle."""
    shape = (1, 225, 256, 8)
    arrays = _inputs(shape, seed=9)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    o, lse, *grads = _emulated_3xtf32(q, k, v, do, 8)
    want_o = np.asarray(attention_oracle(*(jnp.asarray(a) for a in arrays[:3]), 8))
    np.testing.assert_allclose(o.numpy(), want_o, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lse.numpy(), attention_lse_reference(q, k, 8).numpy(),
                               atol=1e-4, rtol=1e-4)
    for name, g, w in zip(("dq", "dk", "dv"), grads, _jax_vjp(attention_oracle, arrays, 8)):
        np.testing.assert_allclose(g.numpy(), w, atol=2e-4, rtol=2e-4, err_msg=name)


def test_3xtf32_scheme_survives_adversarial_magnitudes():
    """q and k scaled by 30 (logits of order 1e3): the emulated scheme stays
    within the 1e-2 the card's adversarial test holds the kernels to."""
    shape = (1, 96, 64, 2)
    arrays = _inputs(shape, seed=4)
    q, k, v, do = (torch.from_numpy(a) for a in arrays)
    q, k = q * 30.0, k * 30.0
    o, _, *grads = _emulated_3xtf32(q, k, v, do, 2)
    np.testing.assert_allclose(o.numpy(), attention_reference(q, k, v, 2).numpy(),
                               atol=1e-2, rtol=1e-2)
    for g, w in zip(grads, attention_backward_reference(q, k, v, do, 2)):
        assert torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_lse_matches_logsumexp_of_the_plain_logits(shape):
    """L (B, H, S) f32, what the forward kernel saves for the backward, from
    the plain path the CPU runs: the wrapper's want_lse output."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(shape, seed=10, n=3))
    out, lse = ac.attention_forward(q, k, v, shape[3], want_lse=True)
    logits = (_split_heads(q, shape[3]) @ _split_heads(k, shape[3]).transpose(-1, -2)
              / np.sqrt(shape[2] // shape[3]))
    assert lse.shape == (shape[0], shape[3], shape[1]) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(logits, dim=-1), atol=1e-5, rtol=1e-5)
    assert torch.equal(out, attention_reference(q, k, v, shape[3]))


def test_autograd_saves_output_and_lse_not_probabilities():
    """With a gradient wanted the forward saves q, k, v, its output and L,
    B x H x S floats beside the activations and nothing S x S; without one
    it saves nothing."""
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in _inputs((2, 17, 64, 4), n=3))
    out = ac.fused_attention(q, k, v, 4)
    saved = out.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [(2, 17, 64)] * 4 + [(2, 4, 17)]
    torch.testing.assert_close(saved[3], out)
    with torch.no_grad():
        assert not ac.fused_attention(q, k, v, 4).requires_grad
