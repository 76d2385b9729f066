"""Ray-cast kernel wrapper (CUDA C++ for sm_90a) and its plain version.

The kernel, ``csrc/raycast.cu``, replaces the depth-only and depth+seg
modes of the JAX package's Pallas kernel
(``aerial_gym_simulator_tpu/ops/raycast_pallas.py``, ``raycast_pallas`` /
``_make_kernel``). It is built with ``nvcc`` into ``_build/`` at first use
and called through ``ctypes`` on PyTorch's current stream.

``raycast`` is the one entry point: a CUDA tensor launches the kernel, a
CPU tensor runs ``raycast_reference``, the plain PyTorch version built on
``ops/raycast.py``. There is no other switch and no fallback: a failed
build or launch raises.

Table layouts (shared by both versions):
  pose  (N, 8)      [ox oy oz qx qy qz qw pad]   sensor origin + world quat
  prims (N, P, 16)  [sx sy sz px py pz r00..r22 sem] world-frame prims,
                    sorted box | cylinder | sphere | triangle
  dirs  (R, 3)      sensor-frame unit ray directions (shared by all envs)
  mult  (R,)        per-ray depth multiplier
  out   depth (N, R) f32, seg (N, R) int32 (seg mode only)
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import raycast as oracle
from ._build import KernelLibrary
from ..utils.math import quat_to_rotation_matrix

# every multiply and add rounds on its own, as in the plain version, so the
# two agree bit for bit (fma contraction off)
LIBRARY = KernelLibrary("raycast", ["-fmad=false"])
THREADS = 256          # rays per block (one thread per ray), see raycast.cu
# the plain version casts this many rays per pass, bounding its temporaries
# (~40 live (rays,) f32 tensors) to a few GB at the main path's width
REFERENCE_CHUNK_RAYS = 1 << 24

# launches of the kernel per mode, counted where the wrapper launches it
LAUNCHES = {"raycast_depth": 0, "raycast_seg": 0}

_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = LIBRARY.load()
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.raycast_launch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i,
                                       ctypes.c_float, i, i, p]
        lib.raycast_launch.restype = i
        lib.raycast_error_string.argtypes = [i]
        lib.raycast_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------


def pack_pose(origin: torch.Tensor, quat: torch.Tensor) -> torch.Tensor:
    """(N,3),(N,4) -> (N,8) f32 pose table."""
    pad = torch.zeros_like(origin[:, :1])
    return torch.cat([origin, quat, pad], dim=-1).contiguous()


def pack_prims_world(scene, obstacle_pos, obstacle_quat) -> torch.Tensor:
    """Compose asset poses with the local prim transforms -> (N, P, 16)
    world table [sx sy sz px py pz r00 r01 r02 r10 r11 r12 r20 r21 r22 sem]."""
    slot = scene.env_prim_slot                                         # (N, P)
    a_pos = torch.gather(obstacle_pos, 1, slot[..., None].expand(-1, -1, 3))
    a_quat = torch.gather(obstacle_quat, 1, slot[..., None].expand(-1, -1, 4))
    R_a = quat_to_rotation_matrix(a_quat)                              # (N, P, 3, 3)
    p_world = a_pos + (R_a @ scene.env_prim_pos[..., None])[..., 0]
    R_w = R_a @ scene.env_prim_rot
    N, P = slot.shape
    return torch.cat([
        scene.env_prim_size,
        p_world,
        R_w.reshape(N, P, 9),
        scene.env_prim_semantic[..., None].to(torch.float32),
    ], dim=-1).contiguous()


def rotate_dirs(quat: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """Sensor-frame dirs (R, 3) to world per env: (N, 4) -> (N, R, 3).
    quat_rotate written out in the kernel's operation order."""
    qx, qy, qz, qw = (quat[:, k, None] for k in range(4))
    dx, dy, dz = dirs[None, :, 0], dirs[None, :, 1], dirs[None, :, 2]
    w2 = 2.0 * qw * qw - 1.0
    cx = qy * dz - qz * dy
    cy = qz * dx - qx * dz
    cz = qx * dy - qy * dx
    td = 2.0 * (qx * dx + qy * dy + qz * dz)
    tw = 2.0 * qw
    return torch.stack([dx * w2 + cx * tw + qx * td,
                        dy * w2 + cy * tw + qy * td,
                        dz * w2 + cz * tw + qz * td], dim=-1)


def _kind_of(p: int, n_box: int, n_cyl: int, n_sph: int) -> int:
    if p < n_box:
        return 0
    if p < n_box + n_cyl:
        return 1
    return 2 if p < n_box + n_cyl + n_sph else 3


def tile_visibility(pose, prims, dirs, n_box: int, n_cyl: int, n_sph: int,
                    max_range: float) -> torch.Tensor:
    """The kernel's broad phase in plain PyTorch: (N, T, P) bool, whether
    primitive p is tested for the rays of tile t (THREADS rays each).

    A primitive is skipped only when its bounding sphere lies beyond
    max_range or outside the tile's cone of world ray directions, each
    test widened by a margin, so skipping never changes an output."""
    N, R = pose.shape[0], dirs.shape[0]
    T = -(-R // THREADS)
    dw = rotate_dirs(pose[:, 3:7], dirs)                               # (N, R, 3)
    unit = dw / torch.linalg.norm(dw, dim=-1, keepdim=True)
    pad = T * THREADS - R
    valid = torch.ones(R, dtype=torch.bool, device=dirs.device)
    if pad:
        unit = torch.cat([unit, torch.zeros_like(unit[:, :pad])], dim=1)
        valid = torch.cat([valid, torch.zeros(pad, dtype=torch.bool, device=dirs.device)])
    unit = unit.reshape(N, T, THREADS, 3)
    axis = unit.sum(dim=2)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)        # (N, T, 3)
    dots = torch.where(valid.reshape(T, THREADS)[None],
                       torch.sum(unit * axis[:, :, None], dim=-1),
                       torch.ones((), device=dirs.device))
    cos_h = torch.clamp(dots.amin(dim=2) - 1e-5, -1.0, 1.0)            # (N, T)
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    # bounding-sphere radius about the table position: box half-diagonal,
    # cylinder corner radius, sphere radius, triangle's longest edge from v0
    sx, sy, sz = prims[..., 0], prims[..., 1], prims[..., 2]
    kind = torch.tensor([_kind_of(p, n_box, n_cyl, n_sph) for p in range(prims.shape[1])],
                        device=prims.device)
    bound = torch.where(kind == 0, 0.5 * torch.sqrt(sx * sx + sy * sy + sz * sz),
                        torch.where(kind == 1, torch.sqrt(sx * sx + 0.25 * sy * sy),
                                    torch.where(kind == 3,
                                                torch.maximum(sx, torch.sqrt(sy * sy + sz * sz)),
                                                sx)))                   # (N, P)
    u = prims[..., 3:6] - pose[:, None, 0:3]                           # (N, P, 3)
    dist = torch.linalg.norm(u, dim=-1)
    margin = 1e-3 * (1.0 + dist + bound)
    in_range = dist < max_range + bound + margin                       # (N, P)
    a = [axis[:, :, None, k] for k in range(3)]                        # (N, T, 1)
    v = [u[:, None, :, k] for k in range(3)]                           # (N, 1, P)
    along = a[0] * v[0] + a[1] * v[1] + a[2] * v[2]                    # (N, T, P)
    perp = torch.sqrt((a[1] * v[2] - a[2] * v[1]) ** 2 + (a[2] * v[0] - a[0] * v[2]) ** 2
                      + (a[0] * v[1] - a[1] * v[0]) ** 2)
    in_cone = (perp * cos_h[..., None] - along * sin_h[..., None]
               <= (bound + margin)[:, None, :])
    return in_range[:, None, :] & in_cone


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def raycast_reference(pose, prims, dirs, mult, n_box: int, n_cyl: int, n_sph: int,
                      max_range: float, want_seg: bool = True, n_tri: int = 0,
                      cull: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of the kernel, same signature and outputs.

    Casts every ray against every primitive (``cull`` only matters to the
    kernel, whose broad phase never changes an output). Envs are processed
    in chunks of about REFERENCE_CHUNK_RAYS rays to bound memory."""
    N, R = pose.shape[0], dirs.shape[0]
    P = prims.shape[1]
    if P != n_box + n_cyl + n_sph + n_tri:
        raise ValueError(f"prims has {P} columns, counts sum to "
                         f"{n_box + n_cyl + n_sph + n_tri}")
    depth = torch.empty((N, R), dtype=torch.float32, device=pose.device)
    seg = (torch.empty((N, R), dtype=torch.int32, device=pose.device)
           if want_seg else None)
    step = max(1, REFERENCE_CHUNK_RAYS // max(R, 1))
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        ps, pr = pose[lo:hi], prims[lo:hi]
        o = ps[:, 0:3]
        dw = rotate_dirs(ps[:, 3:7], dirs)                             # (n, R, 3)
        dxw, dyw, dzw = dw[..., 0], dw[..., 1], dw[..., 2]
        t_best = torch.full(dxw.shape, oracle.BIG, dtype=torch.float32,
                            device=pose.device)
        s_best = torch.full(dxw.shape, oracle.NO_HIT_SEGMENTATION_VAL,
                            dtype=torch.int32, device=pose.device)
        for p in range(P):
            kind = _kind_of(p, n_box, n_cyl, n_sph)
            size = pr[:, p, 0:3][:, None, :]                           # (n, 1, 3)
            ux = o[:, 0] - pr[:, p, 3]
            uy = o[:, 1] - pr[:, p, 4]
            uz = o[:, 2] - pr[:, p, 5]
            if kind == 2:
                # spheres are rotation-invariant: world frame
                ro = torch.stack([ux, uy, uz], dim=-1)[:, None, :]
                t = oracle.ray_sphere(ro, dw, size[..., 0])
            else:
                r = [pr[:, p, 6 + k, None] for k in range(9)]          # row-major R
                ro = torch.stack([r[0][:, 0] * ux + r[3][:, 0] * uy + r[6][:, 0] * uz,
                                  r[1][:, 0] * ux + r[4][:, 0] * uy + r[7][:, 0] * uz,
                                  r[2][:, 0] * ux + r[5][:, 0] * uy + r[8][:, 0] * uz],
                                 dim=-1)[:, None, :]
                rd = torch.stack([r[0] * dxw + r[3] * dyw + r[6] * dzw,
                                  r[1] * dxw + r[4] * dyw + r[7] * dzw,
                                  r[2] * dxw + r[5] * dyw + r[8] * dzw], dim=-1)
                if kind == 0:
                    t = oracle.ray_box(ro, rd, 0.5 * size)
                elif kind == 1:
                    t = oracle.ray_cylinder(ro, rd, size[..., 0], size[..., 1])
                else:
                    t = oracle.ray_triangle(ro, rd, size)
            closer = t < t_best
            t_best = torch.where(closer, t, t_best)
            if want_seg:
                s_best = torch.where(closer, pr[:, p, 15, None].to(torch.int32), s_best)
        miss = t_best >= min(max_range, 0.5 * oracle.BIG)
        t_best = torch.where(miss, torch.full_like(t_best, oracle.NO_HIT_RAY_VAL), t_best)
        depth[lo:hi] = t_best * mult[None, :]
        if want_seg:
            seg[lo:hi] = torch.where(
                miss, torch.full_like(s_best, oracle.NO_HIT_SEGMENTATION_VAL), s_best)
    return depth, seg


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def raycast(pose, prims, dirs, mult, n_box: int, n_cyl: int, n_sph: int,
            max_range: float, want_seg: bool = True, n_tri: int = 0,
            cull: bool = True) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Nearest hit of every (env, ray) -> depth (N, R) f32 = t * mult
    (NO_HIT_RAY_VAL * mult on a miss) and, when want_seg, the winner's
    semantic id (N, R) int32 (NO_HIT_SEGMENTATION_VAL on a miss).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    ``cull=False`` turns the kernel's broad phase off (a debug switch:
    outputs are identical either way)."""
    if pose.device.type == "cpu":
        return raycast_reference(pose, prims, dirs, mult, n_box, n_cyl, n_sph,
                                 max_range, want_seg=want_seg, n_tri=n_tri, cull=cull)
    if pose.device.type != "cuda":
        raise ValueError(f"unsupported device {pose.device}")
    N, R, P = pose.shape[0], dirs.shape[0], prims.shape[1]
    if P != n_box + n_cyl + n_sph + n_tri:
        raise ValueError(f"prims has {P} columns, counts sum to "
                         f"{n_box + n_cyl + n_sph + n_tri}")
    dev = pose.device
    _check("pose", pose, torch.float32, (N, 8), dev)
    _check("prims", prims, torch.float32, (N, P, 16), dev)
    _check("dirs", dirs, torch.float32, (R, 3), dev)
    _check("mult", mult, torch.float32, (R,), dev)
    if -(-R // THREADS) > 65535:
        raise ValueError(f"{R} rays exceed the kernel's grid limit")
    lib = _load()
    depth = torch.empty((N, R), dtype=torch.float32, device=dev)
    seg = torch.empty((N, R), dtype=torch.int32, device=dev) if want_seg else None
    if N == 0 or R == 0:
        return depth, seg
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.raycast_launch(pose.data_ptr(), prims.data_ptr(), dirs.data_ptr(),
                            mult.data_ptr(), depth.data_ptr(),
                            seg.data_ptr() if want_seg else None,
                            N, R, P, n_box, n_cyl, n_sph, n_tri, float(max_range),
                            int(bool(cull)), int(bool(want_seg)), stream)
    if rc != 0:
        raise RuntimeError("raycast kernel launch failed: "
                           + lib.raycast_error_string(rc).decode())
    LAUNCHES["raycast_seg" if want_seg else "raycast_depth"] += 1
    return depth, seg
