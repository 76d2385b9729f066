"""Least time of one fused-attention forward call on the card.

A frozen copy of ``chip_smoke.py``'s ``products_ms``, ``bound_of`` and
``attention_bound_ms`` (lines 834-869 at the commit that added this
benchmark): q, k, v in and o out once over the memory bandwidth, against
the two products' operations (2 x 2 x B x H x S x S x head_dim); bf16 over
the tensor-core peak, f32 over the faster of f32 multiply-adds and three
TF32 products each.
"""

from __future__ import annotations

from .peaks import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS, PEAK_TF32_FLOPS


def products_s(ops: float, itemsize: int) -> float:
    if itemsize == 2:
        return ops / PEAK_BF16_FLOPS
    return min(ops / PEAK_F32_FLOPS, 3 * ops / PEAK_TF32_FLOPS)


def attention_bound_s(batch: int, seq: int, dim: int, heads: int, itemsize: int) -> float:
    """Seconds: the larger of the byte and the operation bound."""
    n_bytes = 4 * batch * seq * dim * itemsize
    ops = 4.0 * batch * heads * seq * seq * (dim // heads)
    return max(n_bytes / PEAK_BYTES, products_s(ops, itemsize))
