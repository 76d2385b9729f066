"""Differentiable ray-cast depth: the kernel's forward, the oracle's backward.

Counterpart of ``aerial_gym_simulator_tpu/ops/raycast_diff.py``. The
ray-cast kernel (``ops/raycast_cuda.py``, K1) has no backward, but the
plain oracle (``ops/raycast.py``) computes the same ranges under autograd.
``raycast_depth_diff`` is a ``torch.autograd.Function`` that runs the
kernel forward and, in the backward, recomputes the oracle on detached
copies of the four pose tensors and returns its vector-Jacobian product,
as the JAX package's ``jax.custom_vjp`` returns the oracle's. In "oracle"
mode the oracle is the forward, and autograd differentiates it directly.

The forward value is the kernel's, bit-equal to ``raycast_reference``,
which orders its operations as the kernel does; the gradient is the
oracle's, whose ranges differ from it in the last bits (the two agree
within 1e-4 m, as in the JAX package). Gradients flow to the poses:
obstacle positions and orientations and the sensor origin and
orientation. The ray table gets a zero gradient, the scene and the range
none. Range is smooth in pose except on silhouette edges (measure zero),
the usual caveat of depth-based differentiable rendering.

No backward kernel is written: the JAX package has none either.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from ..utils.math import quat_rotate
from . import raycast
from . import raycast_cuda as rc

# "auto" is the kernel on CUDA tensors and the oracle on CPU tensors;
# "kernel" runs raycast_cuda.raycast (its plain version on CPU tensors),
# and the JAX package's names "pallas" and "interpret" mean the same
MODES = ("auto", "kernel", "pallas", "interpret", "oracle")


def _oracle_depth(scene, obstacle_pos, obstacle_quat, origin, quat, dirs, max_range):
    rd_world = quat_rotate(quat[:, None, :], dirs.reshape(-1, 3)[None, :, :])
    t, _ = raycast.raycast_batched(scene, obstacle_pos, obstacle_quat, origin, rd_world,
                                   max_range)
    return t


def _resolve(mode: str, device: torch.device) -> str:
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}; one of {MODES}")
    if mode == "auto":
        return "kernel" if device.type == "cuda" else "oracle"
    return "oracle" if mode == "oracle" else "kernel"


def _kernel_depth(scene, obstacle_pos, obstacle_quat, origin, quat, dirs, max_range):
    prims = rc.pack_prims_world(scene, obstacle_pos, obstacle_quat)
    ones = torch.ones(dirs.shape[:-1], dtype=torch.float32, device=dirs.device)
    t, _ = rc.raycast(rc.pack_pose(origin, quat), prims, dirs.contiguous(), ones, scene.n_box,
                      scene.n_cyl, scene.n_sph, float(max_range), want_seg=False,
                      n_tri=scene.n_tri)
    return t


class _RaycastDepth(torch.autograd.Function):

    @staticmethod
    def forward(ctx, scene, obstacle_pos, obstacle_quat, origin, quat, dirs, max_range):
        ctx.scene, ctx.max_range = scene, max_range
        ctx.save_for_backward(obstacle_pos, obstacle_quat, origin, quat, dirs)
        return _kernel_depth(scene, obstacle_pos, obstacle_quat, origin, quat, dirs, max_range)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        *poses, dirs = ctx.saved_tensors
        with torch.enable_grad():
            poses = [p.detach().requires_grad_(True) for p in poses]
            t = _oracle_depth(ctx.scene, *poses, dirs, ctx.max_range)
            grads = torch.autograd.grad(t, poses, g, allow_unused=True)
        grads = [torch.zeros_like(p) if d is None else d for p, d in zip(poses, grads)]
        return (None, *grads, torch.zeros_like(dirs), None)


def raycast_depth_diff(scene, obstacle_pos, obstacle_quat, origin, quat, dirs, max_range,
                       mode: str = "auto"):
    """Range image (N, R) with gradients w.r.t. the pose arguments.

    scene: SceneParams; obstacle_pos / obstacle_quat (N, A, 3 / 4); origin
    (N, 3) and quat (N, 4) the sensor's world pose; dirs (R, 3) the
    sensor-frame ray table, or a sensor's (H, W, 3) ray grid, which the
    kernel tiles in 2-D (R = H * W rays in row-major order either way).
    Misses read ``raycast.NO_HIT_RAY_VAL``.
    mode: "auto" (the kernel on CUDA tensors, the oracle on CPU tensors),
    "kernel" (``raycast_cuda.raycast``: the kernel on CUDA tensors, its
    plain version on CPU tensors; "pallas" and "interpret" are accepted
    for it) or "oracle" (``raycast.raycast_batched``). The backward is the
    oracle's in every mode: in "oracle" mode autograd differentiates the
    forward itself, with nothing to recompute."""
    if _resolve(mode, origin.device) == "oracle":
        return _oracle_depth(scene, obstacle_pos, obstacle_quat, origin, quat, dirs, max_range)
    return _RaycastDepth.apply(scene, obstacle_pos, obstacle_quat, origin, quat, dirs,
                               max_range)
