"""Multi-head attention on the packed (B, S, D) layout, plain PyTorch.

Counterpart of ``attention_oracle`` in the JAX package's
``ops/attention_pallas.py`` and the plain version of the fused kernel in
``ops/attention_cuda.py``: the same function with the (S, S) softmax
written out. The tests use it, CPU tensors run it, and the kernel is held
against it on the card. It is differentiable on its own.
``attention_backward_reference`` is the plain version of the backward
kernel: the gradient formulas of the JAX package's ``_bwd_kernel`` written
out, with the probabilities recomputed from q and k.
``attention_lse_reference`` is the plain version of the row log-sum-exp
the forward kernel leaves for the backward.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                        sm_scale: Optional[float] = None) -> torch.Tensor:
    """q, k, v (B, S, D = num_heads * head_dim) -> (B, S, D) in q's dtype.

    Per head ``softmax(q k^T * sm_scale) v``; products accumulate in f32,
    the softmax is f32, and the probabilities are rounded to v's dtype
    before the second product."""
    b, s, d = q.shape
    if d % num_heads:
        raise ValueError(f"model dim {d} not divisible by heads {num_heads}")
    hd = d // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    split = lambda x: x.reshape(b, s, num_heads, hd).transpose(1, 2)    # (B, H, S, hd)
    qh, kh, vh = split(q), split(k), split(v)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * sm_scale
    p = torch.softmax(logits, dim=-1)
    o = torch.matmul(p.to(v.dtype).float(), vh.float())
    return o.transpose(1, 2).reshape(b, s, d).to(q.dtype)


def attention_lse_reference(q: torch.Tensor, k: torch.Tensor, num_heads: int,
                            sm_scale: Optional[float] = None) -> torch.Tensor:
    """Row log-sum-exp of the scaled logits, (B, H, S) f32:
    L = m + log(sum_j exp(q_i . k_j * sm_scale - m)) with m the row max."""
    b, s, d = q.shape
    if d % num_heads:
        raise ValueError(f"model dim {d} not divisible by heads {num_heads}")
    hd = d // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    split = lambda x: x.reshape(b, s, num_heads, hd).transpose(1, 2).float()
    logits = torch.matmul(split(q), split(k).transpose(-1, -2)) * sm_scale
    m = logits.amax(dim=-1, keepdim=True)
    return (m + torch.log(torch.exp(logits - m).sum(dim=-1, keepdim=True))).squeeze(-1)


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                 do: torch.Tensor, num_heads: int,
                                 sm_scale: Optional[float] = None):
    """Gradients of ``attention_reference`` for the output gradient ``do``
    -> (dq, dk, dv), each (B, S, D) in q's dtype.

    Per head, in f32: P = softmax(q k^T * sm_scale) recomputed,
    dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(P * dP)) * sm_scale,
    dQ = dS K, dK = dS^T Q."""
    b, s, d = q.shape
    if d % num_heads:
        raise ValueError(f"model dim {d} not divisible by heads {num_heads}")
    hd = d // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    split = lambda x: x.reshape(b, s, num_heads, hd).transpose(1, 2).float()
    qh, kh, vh, doh = split(q), split(k), split(v), split(do)
    p = torch.softmax(torch.matmul(qh, kh.transpose(-1, -2)) * sm_scale, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), doh)
    dp = torch.matmul(doh, vh.transpose(-1, -2))
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True)) * sm_scale
    dq = torch.matmul(ds, kh)
    dk = torch.matmul(ds.transpose(-1, -2), qh)
    merge = lambda x: x.transpose(1, 2).reshape(b, s, d).to(q.dtype)
    return merge(dq), merge(dk), merge(dv)
