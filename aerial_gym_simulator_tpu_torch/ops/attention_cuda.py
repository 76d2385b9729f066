"""Fused attention, forward and backward: the kernels' wrappers (CUDA C++
for sm_90a).

The source, ``csrc/attention.cu``, replaces the JAX package's Pallas
kernels (``aerial_gym_simulator_tpu/ops/attention_pallas.py``,
``fused_attention`` -> ``_fwd_call`` and ``_bwd_call``). It is built with
``nvcc`` into ``_build/`` at first use and called through ``ctypes`` on
PyTorch's current stream.

``fused_attention`` is the public function: a ``torch.autograd.Function``
whose forward and backward launch the kernels for CUDA tensors and run the
plain versions (``ops/attention.attention_reference``,
``attention_lse_reference`` and ``attention_backward_reference``) for CPU
tensors. There is no other switch and no fallback: a failed build or launch
raises. When a gradient is wanted the forward also writes the row
log-sum-exp L (B, H, S) f32 and saves the output and L beside q, k, v; the
backward recomputes the probabilities from them, so nothing of size S x S is
kept between the two passes.

Layout: q, k, v, the output and every gradient are (B, S, D = num_heads *
head_dim), contiguous, all bf16 or all f32. Forward: bf16 with head_dim 32
or 64 (and a positive scale) runs a bf16 tensor-core serving kernel: at
head_dim 32 the staged one while one block's shared memory holds the whole
sequence, otherwise the ring kernel, which streams the keys through shared
memory and so takes any sequence length; everything else, f32 above all,
the TF32 tensor-core kernel, with each f32 product
split into three TF32 products (3xTF32) for f32 accuracy. Backward: two
TF32 tensor-core kernels (delta and dQ over query tiles, then dK and dV
over key tiles), 3xTF32 for f32, deterministic, any sequence length. The
TF32 kernels are built for head sizes up to 128. Heads of 129 to 256
columns (``WIDE_HEAD``) run the one-pass wide kernels, whose blocks hold the
whole head of their rows in shared memory and take every product once.
Heads of 257 to 2,048 columns (``CLUSTER_HEAD``) run the cluster kernels: a
thread-block cluster of one wide block per 256-column slice of the head,
which sum their partial logits through distributed shared memory, so every
product is taken once per cluster; a launch the card cannot place raises.
Wider heads (the JAX kernel takes any) run the sliced kernels, which walk
the head in 128-column slices, so every head size runs on the card. Each
family counts its launches apart (``LAUNCHES``, keys from
``kernel_family``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import KernelLibrary
from .attention import (attention_backward_reference, attention_lse_reference,
                        attention_reference)

LIBRARY = KernelLibrary("attention")
MMA_HEAD_DIMS = (32, 64)           # head sizes the bf16 serving kernels are built for
WIDE_HEAD = 256                    # the widest head the one-pass wide kernels take
CLUSTER_HEAD = 2048                # the widest head the cluster kernels take
FAMILIES = ("", "_wide", "_cluster", "_sliced")

# calls of each kernel's wrapper that launched it, counted where it launches
# and by the family of kernels that ran (kernel_family): one per forward, one
# per backward (whose two kernels launch together)
LAUNCHES = {f"attention_{d}{f}": 0 for f in FAMILIES for d in ("fwd", "bwd")}

_lib = None


def kernel_family(head_dim: int) -> str:
    """The suffix of the kernels ``csrc/attention.cu`` dispatches a head size
    to: "" (the narrow kernels, up to 128 columns), "_wide" (the one-pass
    wide kernels, up to ``WIDE_HEAD``), "_cluster" (the cluster kernels, up
    to ``CLUSTER_HEAD``) or "_sliced" (wider)."""
    if head_dim <= 128:
        return ""
    return "_wide" if head_dim <= WIDE_HEAD else "_cluster" if head_dim <= CLUSTER_HEAD \
        else "_sliced"


def _load():
    global _lib
    if _lib is None:
        lib = LIBRARY.load()
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attention_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, f, i, i, p]
        lib.attention_fwd_launch.restype = i
        lib.attention_bwd_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, f, i, i,
                                             p]
        lib.attention_bwd_launch.restype = i
        lib.attention_cluster_occupancy.argtypes = [i, i, p]
        lib.attention_cluster_occupancy.restype = i
        lib.attention_error_string.argtypes = [i]
        lib.attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, like: torch.Tensor, shape=None, dtype=None):
    shape = like.shape if shape is None else shape
    dtype = like.dtype if dtype is None else dtype
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def _prepare(q: torch.Tensor, num_heads: int, sm_scale: Optional[float]):
    """Checks shared by both directions -> (head_dim, scale, on_cpu)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, S, D), got {tuple(q.shape)}")
    D = q.shape[2]
    if D % num_heads:
        raise ValueError(f"model dim {D} not divisible by heads {num_heads}")
    hd = D // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {q.device}")
    if q.device.type == "cuda" and q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {q.dtype}: the kernel takes bf16 or f32")
    return hd, sm_scale, q.device.type == "cpu"


def _raise_on(rc: int, lib, what: str):
    if rc != 0:
        raise RuntimeError(f"attention {what} launch failed: "
                           + lib.attention_error_string(rc).decode())


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                      sm_scale: Optional[float] = None, use_mma: Optional[bool] = None,
                      want_lse: bool = False, sliced: bool = False, ring: bool = False):
    """The forward without autograd -> o, or (o, L) with ``want_lse`` (L the
    row log-sum-exp, (B, H, S) f32): kernel on CUDA tensors, plain version
    on CPU tensors. ``use_mma`` overrides the choice between the bf16
    serving kernels and the TF32 kernel (a debug switch; None picks by dtype
    and head size). ``sliced`` runs the sliced kernel at a head size of
    129-2,048 as well, where the one-pass wide or the cluster kernel would
    run, and ``ring`` the ring serving kernel where the staged one would
    (debug switches, to time one kernel against the other on the same
    tensors)."""
    hd, sm_scale, on_cpu = _prepare(q, num_heads, sm_scale)
    if on_cpu:
        out = attention_reference(q, k, v, num_heads, sm_scale)
        return (out, attention_lse_reference(q, k, num_heads, sm_scale)) if want_lse else out
    B, S, _ = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    is_bf16 = q.dtype == torch.bfloat16
    mma_takes_it = is_bf16 and hd in MMA_HEAD_DIMS and sm_scale > 0
    if use_mma is None:
        use_mma = mma_takes_it
    elif use_mma and not mma_takes_it:
        raise ValueError(f"the bf16 serving kernel takes bf16 with head_dim in {MMA_HEAD_DIMS} "
                         "and a positive scale")
    if sliced and hd <= 128:
        raise ValueError(f"the sliced kernel takes head sizes above 128, not {hd}")
    if ring and not (use_mma and mma_takes_it):
        raise ValueError(f"the ring kernel takes bf16 with head_dim in {MMA_HEAD_DIMS} and a "
                         "positive scale")
    out = torch.empty_like(q)
    lse = torch.empty((B, num_heads, S), device=q.device, dtype=torch.float32) if want_lse else None
    if B == 0 or S == 0:
        return (out, lse) if want_lse else out
    lib = _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.attention_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      lse.data_ptr() if want_lse else None, B, S, num_heads, hd,
                                      float(sm_scale), int(is_bf16),
                                      2 if sliced else 3 if ring else int(use_mma), stream)
    _raise_on(rc, lib, "forward")
    LAUNCHES["attention_fwd" + ("_sliced" if sliced else kernel_family(hd))] += 1
    return (out, lse) if want_lse else out


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       grad_out: torch.Tensor, num_heads: int,
                       sm_scale: Optional[float] = None, out: Optional[torch.Tensor] = None,
                       lse: Optional[torch.Tensor] = None, sliced: bool = False):
    """The backward without autograd -> (dq, dk, dv): kernels on CUDA
    tensors, plain version on CPU tensors. ``out`` and ``lse`` are the
    forward's output and row log-sum-exp (``attention_forward(...,
    want_lse=True)``); where either is missing one forward launch makes
    both. ``grad_out`` may arrive with any strides (autograd often hands
    over a view); it is made contiguous here. ``sliced`` runs the sliced
    kernels at a head size of 129-2,048 as well (a debug switch, as the
    forward's)."""
    hd, sm_scale, on_cpu = _prepare(q, num_heads, sm_scale)
    if sliced and hd <= 128:
        raise ValueError(f"the sliced kernels take head sizes above 128, not {hd}")
    if on_cpu:
        return attention_backward_reference(q, k, v, grad_out, num_heads, sm_scale)
    B, S, _ = q.shape
    grad_out = grad_out.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("grad_out", grad_out)):
        _check(name, t, q)
    if out is None or lse is None:
        out, lse = attention_forward(q, k, v, num_heads, sm_scale, want_lse=True)
    _check("out", out, q)
    _check("lse", lse, q, shape=(B, num_heads, S), dtype=torch.float32)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    if B == 0 or S == 0:
        return dq, dk, dv
    delta = torch.empty_like(lse)
    lib = _load()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.attention_bwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      grad_out.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S,
                                      num_heads, hd, float(sm_scale),
                                      int(q.dtype == torch.bfloat16), 2 if sliced else 0, stream)
    _raise_on(rc, lib, "backward")
    LAUNCHES["attention_bwd" + ("_sliced" if sliced else kernel_family(hd))] += 1
    return dq, dk, dv


def cluster_occupancy(head_dim: int, dtype: torch.dtype, device=None) -> dict:
    """The most clusters of each cluster kernel that the card holds at once
    for a head of ``head_dim`` columns (257 to ``CLUSTER_HEAD``), as
    ``cudaOccupancyMaxActiveClusters`` finds them: a launcher refuses a
    kernel with none."""
    if kernel_family(head_dim) != "_cluster":
        raise ValueError(f"head size {head_dim} does not run the cluster kernels")
    lib = _load()
    found = (ctypes.c_int * 4)()
    with torch.cuda.device(device if device is not None else torch.cuda.current_device()):
        rc = lib.attention_cluster_occupancy(head_dim, int(dtype == torch.bfloat16), found)
    _raise_on(rc, lib, "cluster occupancy")
    return dict(zip(("fwd", "fwd_lse", "bwd_dq", "bwd_dkdv"), found))


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, sm_scale, want_grad):
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        if not want_grad:
            return attention_forward(q, k, v, num_heads, sm_scale)
        out, lse = attention_forward(q, k, v, num_heads, sm_scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, grad_out, ctx.num_heads, ctx.sm_scale,
                                        out=out, lse=lse)
        return dq, dk, dv, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Fused short-sequence multi-head attention on packed (B, S, D)
    tensors; returns (B, S, D) in q's dtype. Differentiable in q, k, v."""
    want_grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                             or v.requires_grad)
    return _FusedAttention.apply(q, k, v, num_heads, sm_scale, want_grad)
