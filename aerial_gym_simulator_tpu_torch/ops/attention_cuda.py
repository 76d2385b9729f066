"""Fused attention, forward and backward: the kernels' wrappers (CUDA C++
for sm_90a).

The source, ``csrc/attention.cu``, replaces the JAX package's Pallas
kernels (``aerial_gym_simulator_tpu/ops/attention_pallas.py``,
``fused_attention`` -> ``_fwd_call`` and ``_bwd_call``). It is built with
``nvcc`` into ``_build/`` at first use and called through ``ctypes`` on
PyTorch's current stream.

``fused_attention`` is the public function: a ``torch.autograd.Function``
whose forward and backward launch the kernels for CUDA tensors and run the
plain versions (``ops/attention.attention_reference`` and
``attention_backward_reference``) for CPU tensors. There is no other switch
and no fallback: a failed build or launch raises. As in the JAX package the
backward keeps q, k and v only and recomputes the probabilities, so nothing
of size S x S is saved between the two passes.

Layout: q, k, v, the output and every gradient are (B, S, D = num_heads *
head_dim), contiguous, all bf16 or all f32. Forward: bf16 with head_dim 32
or 64 (and a positive scale) runs the tensor-core kernel, everything else
the f32-accurate one. Backward: one multiply-add kernel with f32 arithmetic
for both types; it stages a head's q, k, v and output gradient in shared
memory, all four where they fit one block and two at a time where they do
not (f32 with head_dim 64 beyond S = 177), and refuses what fits neither way
(f32 with head_dim 64 beyond S = 273).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import KernelLibrary
from .attention import attention_backward_reference, attention_reference

LIBRARY = KernelLibrary("attention")
MAX_SHARED_BYTES = 232448          # what one block may use on sm_90
MMA_HEAD_DIMS = (32, 64)           # head sizes the tensor-core kernel is built for

# launches of each kernel, counted where its wrapper launches it
LAUNCHES = {"attention_fwd": 0, "attention_bwd": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = LIBRARY.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.attention_fwd_launch.argtypes = [p, p, p, p, i, i, i, i, ctypes.c_float, i, i, p]
        lib.attention_fwd_launch.restype = i
        lib.attention_shared_bytes.argtypes = [i, i, i]
        lib.attention_shared_bytes.restype = ctypes.c_longlong
        lib.attention_bwd_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i, ctypes.c_float,
                                             i, p]
        lib.attention_bwd_launch.restype = i
        lib.attention_bwd_shared_bytes.argtypes = [i, i, i]
        lib.attention_bwd_shared_bytes.restype = ctypes.c_longlong
        lib.attention_error_string.argtypes = [i]
        lib.attention_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(name: str, t: torch.Tensor, like: torch.Tensor):
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, expected {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {like.dtype}")
    if t.shape != like.shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(like.shape)}")
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


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                      sm_scale: Optional[float] = None,
                      use_mma: Optional[bool] = None) -> torch.Tensor:
    """The forward without autograd: kernel on CUDA tensors, plain version
    on CPU tensors. ``use_mma`` overrides the choice between the two
    kernels in the source (a debug switch; None picks by dtype and head
    size)."""
    hd, sm_scale, on_cpu = _prepare(q, num_heads, sm_scale)
    if on_cpu:
        return attention_reference(q, k, v, num_heads, sm_scale)
    B, S, _ = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q)
    is_bf16 = q.dtype == torch.bfloat16
    mma_takes_it = is_bf16 and hd in MMA_HEAD_DIMS and sm_scale > 0
    if use_mma is None:
        use_mma = mma_takes_it
    elif use_mma and not mma_takes_it:
        raise ValueError(f"the tensor-core kernel takes bf16 with head_dim in {MMA_HEAD_DIMS} "
                         "and a positive scale")
    out = torch.empty_like(q)
    if B == 0 or S == 0:
        return out
    lib = _load()
    need = lib.attention_shared_bytes(S, hd, int(use_mma))
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"sequence {S} x head_dim {hd} needs {need} bytes of shared memory, "
                         f"a block has {MAX_SHARED_BYTES}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.attention_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      B, S, num_heads, hd, float(sm_scale), int(is_bf16),
                                      int(use_mma), stream)
    if rc != 0:
        raise RuntimeError("attention kernel launch failed: "
                           + lib.attention_error_string(rc).decode())
    LAUNCHES["attention_fwd"] += 1
    return out


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       grad_out: torch.Tensor, num_heads: int,
                       sm_scale: Optional[float] = None):
    """The backward without autograd -> (dq, dk, dv): kernel on CUDA
    tensors, plain version on CPU tensors. ``grad_out`` may arrive with any
    strides (autograd often hands over a view); it is made contiguous
    here."""
    hd, sm_scale, on_cpu = _prepare(q, num_heads, sm_scale)
    if on_cpu:
        return attention_backward_reference(q, k, v, grad_out, num_heads, sm_scale)
    B, S, _ = q.shape
    grad_out = grad_out.contiguous()
    for name, t in (("q", q), ("k", k), ("v", v), ("grad_out", grad_out)):
        _check(name, t, q)
    is_bf16 = q.dtype == torch.bfloat16
    if is_bf16 and hd % 2:
        raise ValueError(f"the backward kernel takes bf16 with an even head_dim, got {hd}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(q), torch.empty_like(q)
    if B == 0 or S == 0:
        return dq, dk, dv
    lib = _load()
    need = lib.attention_bwd_shared_bytes(S, hd, int(is_bf16))
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"the backward of sequence {S} x head_dim {hd} ({q.dtype}) needs {need} "
                         f"bytes of shared memory, a block has {MAX_SHARED_BYTES}")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.attention_bwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      grad_out.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                                      dv.data_ptr(), B, S, num_heads, hd, float(sm_scale),
                                      int(is_bf16), stream)
    if rc != 0:
        raise RuntimeError("attention backward kernel launch failed: "
                           + lib.attention_error_string(rc).decode())
    LAUNCHES["attention_bwd"] += 1
    return dq, dk, dv


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, sm_scale):
        ctx.save_for_backward(q, k, v)
        ctx.num_heads, ctx.sm_scale = num_heads, sm_scale
        return attention_forward(q, k, v, num_heads, sm_scale)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, grad_out, ctx.num_heads, ctx.sm_scale)
        return dq, dk, dv, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Fused short-sequence multi-head attention on packed (B, S, D)
    tensors; returns (B, S, D) in q's dtype. Differentiable in q, k, v."""
    return _FusedAttention.apply(q, k, v, num_heads, sm_scale)
