"""Fused attention forward: the kernel's wrapper (CUDA C++ for sm_90a).

The kernel, ``csrc/attention.cu``, replaces the forward of the JAX
package's Pallas kernel (``aerial_gym_simulator_tpu/ops/attention_pallas.py``,
``fused_attention`` -> ``_fwd_call``). It is built with ``nvcc`` into
``_build/`` at first use and called through ``ctypes`` on PyTorch's current
stream.

``fused_attention`` is the public function: a ``torch.autograd.Function``
whose forward launches the kernel for CUDA tensors and runs the plain
version (``ops/attention.attention_reference``) for CPU tensors. There is
no other switch and no fallback: a failed build or launch raises. Its
backward is the kernel that is not ported yet and raises
``NotImplementedError``; to differentiate, call ``attention_reference``.

Layout: q, k, v and the output are (B, S, D = num_heads * head_dim),
contiguous, all bf16 or all f32. bf16 with head_dim 32 or 64 (and a
positive scale) runs the tensor-core kernel, everything else the
f32-accurate one.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from ._build import KernelLibrary
from .attention import attention_reference

LIBRARY = KernelLibrary("attention")
MAX_SHARED_BYTES = 232448          # what one block may use on sm_90
MMA_HEAD_DIMS = (32, 64)           # head sizes the tensor-core kernel is built for

# launches of the kernel, counted where the wrapper launches it
LAUNCHES = {"attention_fwd": 0}

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


def attention_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                      sm_scale: Optional[float] = None,
                      use_mma: Optional[bool] = None) -> torch.Tensor:
    """The forward without autograd: kernel on CUDA tensors, plain version
    on CPU tensors. ``use_mma`` overrides the choice between the two
    kernels in the source (a debug switch; None picks by dtype and head
    size)."""
    if q.dim() != 3:
        raise ValueError(f"q must be (B, S, D), got {tuple(q.shape)}")
    B, S, D = q.shape
    if D % num_heads:
        raise ValueError(f"model dim {D} not divisible by heads {num_heads}")
    hd = D // num_heads
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(hd)
    if q.device.type == "cpu":
        return attention_reference(q, k, v, num_heads, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"unsupported dtype {q.dtype}: the kernel takes bf16 or f32")
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


class _FusedAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, num_heads, sm_scale):
        return attention_forward(q, k, v, num_heads, sm_scale)

    @staticmethod
    def backward(ctx, grad_out):
        raise NotImplementedError(
            "the fused attention backward kernel (K6, dq/dk/dv with the probabilities "
            "recomputed) is not ported yet, see ROADMAP.md; differentiate "
            "ops.attention.attention_reference instead")


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """Fused short-sequence multi-head attention on packed (B, S, D)
    tensors; returns (B, S, D) in q's dtype."""
    return _FusedAttention.apply(q, k, v, num_heads, sm_scale)
