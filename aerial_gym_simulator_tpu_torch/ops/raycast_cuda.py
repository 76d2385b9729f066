"""Ray-cast kernel wrapper (CUDA C++ for sm_90a) and its plain version.

The kernel, ``csrc/raycast.cu``, replaces the four modes of the JAX
package's Pallas kernel (``aerial_gym_simulator_tpu/ops/raycast_pallas.py``,
``raycast_pallas`` / ``_make_kernel``): depth only, depth + seg, + normal
and face id, and in-kernel RGB shading. It is built with ``nvcc`` into
``_build/`` at first use and called through ``ctypes`` on PyTorch's
current stream.

``raycast`` is the one entry point: a CUDA tensor launches the kernel, a
CPU tensor runs ``raycast_reference``, the plain PyTorch version built on
``ops/raycast.py``. There is no other switch and no fallback: a failed
build or launch raises.

Table layouts (shared by both versions):
  pose  (N, 8)      [ox oy oz qx qy qz qw pad]   sensor origin + world quat
  prims (N, P, 16)  [sx sy sz px py pz r00..r22 sem] world-frame prims,
                    sorted box | cylinder | sphere | triangle
  dirs  (H, W, 3)   sensor-frame unit ray directions on the sensor's grid,
                    row-major (shared by all envs); an (R, 3) table is a
                    grid of one row
  mult  (H, W)      per-ray depth multiplier, or (R,)
  out   depth (N, R) f32, seg (N, R) int32 (every mode but depth only),
        normal (N, R, 3) f32 + face (N, R) int32 (normal mode),
        rgb (N, R, 3) f32 (RGB mode)
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import raycast as oracle
from ._build import KernelLibrary
from ..utils.math import quat_to_rotation_matrix, rowwise_matmul

# every multiply and add rounds on its own, as in the plain version, so the
# two agree bit for bit (fma contraction off)
LIBRARY = KernelLibrary("raycast", ["-fmad=false"])
PATCH = (16, 32)       # a block's rays on the (H, W) grid, see raycast.cu
WARP_PATCH = (8, 8)    # a warp's rays, the unit of the broad phase
# the plain version casts this many rays per pass, bounding its temporaries
# (~40 live (rays,) f32 tensors) to a few GB at the main path's width
REFERENCE_CHUNK_RAYS = 1 << 24

# the kernel's modes (template argument of raycast_kernel in raycast.cu)
MODE_DEPTH, MODE_SEG, MODE_NORMALS, MODE_RGB = 0, 1, 2, 3
MODE_NAMES = ("raycast_depth", "raycast_seg", "raycast_normals", "raycast_rgb")

# launches of the kernel per mode, counted where the wrapper launches it
LAUNCHES = {name: 0 for name in MODE_NAMES}

# the RGB mode's constants, copied into the kernel's constant memory once
# per device: palette (10 x 3), sun (3), sky (3), ambient, 1 - ambient
SHADING = np.concatenate([
    oracle.SEG_ALBEDO.reshape(-1), oracle.SUN_DIR, oracle.SKY_RGB,
    np.array([oracle.RGB_AMBIENT, 1.0 - oracle.RGB_AMBIENT], np.float32)]).astype(np.float32)

_lib = None
_shading_devices = set()


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of a build of csrc/raycast.cu."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.raycast_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                                   ctypes.c_float, i, i, p]
    lib.raycast_launch.restype = i
    lib.raycast_set_shading.argtypes = [p, i]
    lib.raycast_set_shading.restype = i
    lib.raycast_error_string.argtypes = [i]
    lib.raycast_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(LIBRARY.load())
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
    p_world = a_pos + rowwise_matmul(R_a, scene.env_prim_pos[..., None])[..., 0]
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


def ray_grid(dirs: torch.Tensor):
    """(H, W) of a ray table: (H, W, 3) as it is, (R, 3) one row."""
    if dirs.dim() == 3:
        return dirs.shape[0], dirs.shape[1]
    return 1, dirs.shape[0]


def warp_groups(H: int, W: int, device=None) -> torch.Tensor:
    """The kernel's broad-phase unit of each ray: (R,) long, the index of
    the 8 x 8 warp patch on the (H, W) grid that holds it, row-major over
    the patches (the last row and column of patches are ragged)."""
    rows = torch.arange(H, device=device) // WARP_PATCH[0]
    cols = torch.arange(W, device=device) // WARP_PATCH[1]
    return (rows[:, None] * -(-W // WARP_PATCH[1]) + cols[None, :]).reshape(-1)


def bounding_radius(prims, n_box: int, n_cyl: int, n_sph: int) -> torch.Tensor:
    """Bounding-sphere radius of each primitive about its table position,
    (N, P): box half-diagonal, cylinder corner radius, sphere radius,
    triangle's longest edge from its first vertex."""
    sx, sy, sz = prims[..., 0], prims[..., 1], prims[..., 2]
    kind = torch.tensor([_kind_of(p, n_box, n_cyl, n_sph) for p in range(prims.shape[1])],
                        device=prims.device)
    return torch.where(kind == 0, 0.5 * torch.sqrt(sx * sx + sy * sy + sz * sz),
                       torch.where(kind == 1, torch.sqrt(sx * sx + 0.25 * sy * sy),
                                   torch.where(kind == 3,
                                               torch.maximum(sx, torch.sqrt(sy * sy + sz * sz)),
                                               sx)))


def tile_visibility(pose, prims, dirs, n_box: int, n_cyl: int, n_sph: int,
                    max_range: float, groups=None) -> torch.Tensor:
    """The kernel's broad phase in plain PyTorch: (N, G, P) bool, whether
    primitive p is tested for the rays of group g.

    ``groups`` (R,) long assigns each ray to a group; the default is the
    kernel's, ``warp_groups`` of the ray grid. A primitive is skipped only
    when its bounding sphere lies beyond max_range or outside the group's
    cone of world ray directions, each test widened by a margin, so
    skipping never changes an output."""
    N = pose.shape[0]
    if groups is None:
        groups = warp_groups(*ray_grid(dirs), device=dirs.device)
    dirs = dirs.reshape(-1, 3)
    G = int(groups.max()) + 1
    dw = rotate_dirs(pose[:, 3:7], dirs)                               # (N, R, 3)
    unit = dw / torch.linalg.norm(dw, dim=-1, keepdim=True)
    axis = torch.zeros((N, G, 3), device=dirs.device).index_add_(1, groups, unit)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)        # (N, G, 3)
    dots = torch.sum(unit * axis[:, groups], dim=-1)                   # (N, R)
    widest = torch.ones((N, G), device=dirs.device).scatter_reduce_(
        1, groups.expand(N, -1), dots, "amin")
    cos_h = torch.clamp(widest - 1e-5, -1.0, 1.0)                      # (N, G)
    sin_h = torch.sqrt(torch.clamp(1.0 - cos_h * cos_h, min=0.0))
    bound = bounding_radius(prims, n_box, n_cyl, n_sph)               # (N, P)
    u = prims[..., 3:6] - pose[:, None, 0:3]                           # (N, P, 3)
    dist = torch.linalg.norm(u, dim=-1)
    margin = 1e-3 * (1.0 + dist + bound)
    in_range = dist < max_range + bound + margin                       # (N, P)
    a = [axis[:, :, None, k] for k in range(3)]                        # (N, G, 1)
    v = [u[:, None, :, k] for k in range(3)]                           # (N, 1, P)
    along = a[0] * v[0] + a[1] * v[1] + a[2] * v[2]                    # (N, G, P)
    perp = torch.sqrt((a[1] * v[2] - a[2] * v[1]) ** 2 + (a[2] * v[0] - a[0] * v[2]) ** 2
                      + (a[0] * v[1] - a[1] * v[0]) ** 2)
    in_cone = (perp * cos_h[..., None] - along * sin_h[..., None]
               <= (bound + margin)[:, None, :])
    return in_range[:, None, :] & in_cone


def bounding_sphere_hits(pose, prims, dirs, n_box: int, n_cyl: int, n_sph: int,
                         max_range: float) -> torch.Tensor:
    """(N, P) float: for each primitive, the number of rays whose half-line
    meets its bounding sphere (``bounding_radius``, no margin) at a distance
    below max_range. These are the (ray, primitive) tests that a broad
    phase on these bounding spheres could not skip, whatever its tiling (a
    tighter bounding volume could skip more)."""
    dirs = dirs.reshape(-1, 3)
    N, P, R = pose.shape[0], prims.shape[1], dirs.shape[0]
    b = bounding_radius(prims, n_box, n_cyl, n_sph)[:, None, :]        # (N, 1, P)
    v = prims[..., 3:6] - pose[:, None, 0:3]                           # (N, P, 3)
    vv = torch.sum(v * v, dim=-1)[:, None, :]                          # (N, 1, P)
    counts = torch.zeros((N, P), device=pose.device)
    chunk_rays = max(1, (1 << 25) // max(N * P, 1))       # ~32M (ray, primitive) pairs a pass
    for lo in range(0, R, chunk_rays):
        dw = rotate_dirs(pose[:, 3:7], dirs[lo:lo + chunk_rays])
        unit = dw / torch.linalg.norm(dw, dim=-1, keepdim=True)        # (N, r, 3)
        along = torch.einsum("nrk,npk->nrp", unit, v)                  # (N, r, P)
        perp2 = torch.clamp(vv - along * along, min=0.0)
        inside = vv <= b * b
        entry = along - torch.sqrt(torch.clamp(b * b - perp2, min=0.0))
        meets = inside | ((along >= 0.0) & (perp2 <= b * b) & (entry < max_range))
        counts += meets.sum(dim=1).float()
    return counts


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------


def _mode(want_seg: bool, want_normals: bool, want_rgb: bool) -> int:
    if want_normals and want_rgb:
        raise ValueError("want_normals and want_rgb are exclusive modes")
    if want_rgb:
        return MODE_RGB
    if want_normals:
        return MODE_NORMALS
    return MODE_SEG if want_seg else MODE_DEPTH


def _sign(x):
    return torch.where(x > 0.0, torch.ones_like(x),
                       torch.where(x < 0.0, -torch.ones_like(x), torch.zeros_like(x)))


def winner_normal(pr, o, dw, t, p_best, n_box: int, n_cyl: int, n_sph: int):
    """World normal of each ray's winning primitive, oriented against the
    ray, in the kernel's operation order (winner_normal in raycast.cu).
    pr (n, P, 16), o (n, 3), dw (n, R, 3), t (n, R), p_best (n, R) long
    (any valid index where the ray missed: those rays are garbage)."""
    rec = torch.gather(pr, 1, p_best[..., None].expand(-1, -1, 16))    # (n, R, 16)
    kind = ((p_best >= n_box).int() + (p_best >= n_box + n_cyl).int()
            + (p_best >= n_box + n_cyl + n_sph).int())
    dxw, dyw, dzw = dw[..., 0], dw[..., 1], dw[..., 2]
    ux = o[:, 0, None] - rec[..., 3]
    uy = o[:, 1, None] - rec[..., 4]
    uz = o[:, 2, None] - rec[..., 5]
    # sphere: radial, in the world frame
    sx, sy, sz = ux + t * dxw, uy + t * dyw, uz + t * dzw
    s_len = torch.clamp(torch.sqrt(sx * sx + sy * sy + sz * sz), min=1e-9)
    n_sph = (sx / s_len, sy / s_len, sz / s_len)
    # the other kinds: the hit point in the primitive's frame, as the sweep
    # computes origin and direction there
    r = [rec[..., 6 + k] for k in range(9)]                             # row-major R
    rox = r[0] * ux + r[3] * uy + r[6] * uz
    roy = r[1] * ux + r[4] * uy + r[7] * uz
    roz = r[2] * ux + r[5] * uy + r[8] * uz
    rdx = r[0] * dxw + r[3] * dyw + r[6] * dzw
    rdy = r[1] * dxw + r[4] * dyw + r[7] * dzw
    rdz = r[2] * dxw + r[5] * dyw + r[8] * dzw
    hx, hy, hz = rox + t * rdx, roy + t * rdy, roz + t * rdz
    zero, one = torch.zeros_like(hx), torch.ones_like(hx)
    # box: dominant axis of |p| / half; x wins ties, then y
    qx = torch.abs(hx) / torch.clamp(0.5 * rec[..., 0], min=1e-9)
    qy = torch.abs(hy) / torch.clamp(0.5 * rec[..., 1], min=1e-9)
    qz = torch.abs(hz) / torch.clamp(0.5 * rec[..., 2], min=1e-9)
    pick_x = (qx >= qy) & (qx >= qz)
    pick_y = ~pick_x & (qy >= qz)
    pick_z = ~pick_x & ~pick_y
    n_box = (torch.where(pick_x, _sign(hx), zero), torch.where(pick_y, _sign(hy), zero),
             torch.where(pick_z, _sign(hz), zero))
    # cylinder: the cap within 1e-4 of |z| = h/2, else radial
    on_cap = torch.abs(torch.abs(hz) - 0.5 * rec[..., 1]) < 1e-4
    c_len = torch.clamp(torch.sqrt(hx * hx + hy * hy), min=1e-9)
    n_cyl = (torch.where(on_cap, zero, hx / c_len), torch.where(on_cap, zero, hy / c_len),
             torch.where(on_cap, _sign(hz), zero))
    # triangle: +z of its frame
    n_p = [torch.where(kind == 0, b, torch.where(kind == 1, c, tri))
           for b, c, tri in zip(n_box, n_cyl, (zero, zero, one))]
    n_w = (r[0] * n_p[0] + r[1] * n_p[1] + r[2] * n_p[2],
           r[3] * n_p[0] + r[4] * n_p[1] + r[5] * n_p[2],
           r[6] * n_p[0] + r[7] * n_p[1] + r[8] * n_p[2])
    n = torch.stack([torch.where(kind == 2, a, b) for a, b in zip(n_sph, n_w)], dim=-1)
    flip = (n[..., 0] * dxw + n[..., 1] * dyw + n[..., 2] * dzw) > 0.0
    return torch.where(flip[..., None], -n, n)


def raycast_reference(pose, prims, dirs, mult, n_box: int, n_cyl: int, n_sph: int,
                      max_range: float, want_seg: bool = True, n_tri: int = 0,
                      cull: bool = True, want_normals: bool = False, want_rgb: bool = False):
    """Plain PyTorch version of the kernel, same signature and outputs.

    Casts every ray against every primitive (``cull`` only matters to the
    kernel, whose broad phase never changes an output). Envs are processed
    in chunks of about REFERENCE_CHUNK_RAYS rays to bound memory."""
    mode = _mode(want_seg, want_normals, want_rgb)
    dirs, mult = dirs.reshape(-1, 3), mult.reshape(-1)
    N, R = pose.shape[0], dirs.shape[0]
    P = prims.shape[1]
    if P != n_box + n_cyl + n_sph + n_tri:
        raise ValueError(f"prims has {P} columns, counts sum to "
                         f"{n_box + n_cyl + n_sph + n_tri}")
    dev = pose.device
    depth = torch.empty((N, R), dtype=torch.float32, device=dev)
    seg = (torch.empty((N, R), dtype=torch.int32, device=dev)
           if mode != MODE_DEPTH else None)
    face = torch.empty((N, R), dtype=torch.int32, device=dev) if mode == MODE_NORMALS else None
    vec = (torch.empty((N, R, 3), dtype=torch.float32, device=dev)
           if mode >= MODE_NORMALS else None)
    step = max(1, REFERENCE_CHUNK_RAYS // max(R, 1))
    for lo in range(0, N, step):
        hi = min(N, lo + step)
        ps, pr = pose[lo:hi], prims[lo:hi]
        o = ps[:, 0:3]
        dw = rotate_dirs(ps[:, 3:7], dirs)                             # (n, R, 3)
        dxw, dyw, dzw = dw[..., 0], dw[..., 1], dw[..., 2]
        t_best = torch.full(dxw.shape, oracle.BIG, dtype=torch.float32, device=dev)
        s_best = torch.full(dxw.shape, oracle.NO_HIT_SEGMENTATION_VAL,
                            dtype=torch.int32, device=dev)
        p_best = torch.full(dxw.shape, oracle.NO_HIT_FACE_VAL, dtype=torch.int32, device=dev)
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
            if mode != MODE_DEPTH:
                s_best = torch.where(closer, pr[:, p, 15, None].to(torch.int32), s_best)
            if mode >= MODE_NORMALS:
                p_best = torch.where(closer, torch.full_like(p_best, p), p_best)
        miss = t_best >= min(max_range, 0.5 * oracle.BIG)
        if mode != MODE_DEPTH:
            seg[lo:hi] = torch.where(
                miss, torch.full_like(s_best, oracle.NO_HIT_SEGMENTATION_VAL), s_best)
        if mode >= MODE_NORMALS:
            normal = (winner_normal(pr, o, dw, t_best, p_best.clamp(min=0).long(),
                                    n_box, n_cyl, n_sph) if P else torch.zeros_like(dw))
            p_best = torch.where(miss, torch.full_like(p_best, oracle.NO_HIT_FACE_VAL), p_best)
        if mode == MODE_RGB:
            # the true depth (range x multiplier) fades the shade
            depth_px = t_best * mult[None, :]
            depth[lo:hi] = torch.where(miss, torch.full_like(depth_px, oracle.NO_HIT_RAY_VAL),
                                       depth_px)
            vec[lo:hi] = oracle.shade_rgb(depth_px, normal, p_best, seg[lo:hi], max_range)
            continue
        t_best = torch.where(miss, torch.full_like(t_best, oracle.NO_HIT_RAY_VAL), t_best)
        depth[lo:hi] = t_best * mult[None, :]
        if mode == MODE_NORMALS:
            face[lo:hi] = p_best
            vec[lo:hi] = torch.where(miss[..., None], torch.zeros_like(normal), normal)
    return _outputs(mode, depth, seg, face, vec)


def _outputs(mode: int, depth, seg, face, vec):
    if mode == MODE_NORMALS:
        return depth, seg, vec, face
    if mode == MODE_RGB:
        return depth, seg, vec
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


def _set_shading(lib, dev: torch.device):
    """Copy the RGB mode's constants into the kernel's constant memory of
    ``dev`` (once per device)."""
    if dev.index in _shading_devices:
        return
    with torch.cuda.device(dev):
        rc = lib.raycast_set_shading(SHADING.ctypes.data, SHADING.size)
    if rc != 0:
        raise RuntimeError("raycast shading constants: " + lib.raycast_error_string(rc).decode())
    _shading_devices.add(dev.index)


def raycast(pose, prims, dirs, mult, n_box: int, n_cyl: int, n_sph: int,
            max_range: float, want_seg: bool = True, n_tri: int = 0,
            cull: bool = True, want_normals: bool = False, want_rgb: bool = False):
    """Nearest hit of every (env, ray).

    ``dirs`` is the sensor's (H, W, 3) ray grid or an (R, 3) table (a grid
    of one row), ``mult`` (H, W) or (R,); R = H * W rays in row-major
    order either way, and the outputs are the same for both.

    Returns (depth, seg): depth (N, R) f32 = t * mult (NO_HIT_RAY_VAL *
    mult on a miss) and, when want_seg, the winner's semantic id (N, R)
    int32 (NO_HIT_SEGMENTATION_VAL on a miss), else None.
    want_normals: (depth, seg, normal (N, R, 3), face (N, R) int32) with
    the winner's world normal oriented against the ray (0 on a miss) and
    its index in the table (-1 on a miss).
    want_rgb (exclusive with want_normals): (depth, seg, rgb (N, R, 3))
    with depth = t * mult, exactly NO_HIT_RAY_VAL on a miss, and the
    Lambert shade of ops/raycast.shade_rgb on that depth (sky on a miss).

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    ``cull=False`` turns the kernel's broad phase off (a debug switch:
    outputs are identical either way)."""
    mode = _mode(want_seg, want_normals, want_rgb)
    if pose.device.type == "cpu":
        return raycast_reference(pose, prims, dirs, mult, n_box, n_cyl, n_sph, max_range,
                                 want_seg=want_seg, n_tri=n_tri, cull=cull,
                                 want_normals=want_normals, want_rgb=want_rgb)
    if pose.device.type != "cuda":
        raise ValueError(f"unsupported device {pose.device}")
    if dirs.dim() not in (2, 3):
        raise ValueError(f"dirs must be (H, W, 3) or (R, 3), got {tuple(dirs.shape)}")
    H, W = ray_grid(dirs)
    N, R, P = pose.shape[0], H * W, prims.shape[1]
    if P != n_box + n_cyl + n_sph + n_tri:
        raise ValueError(f"prims has {P} columns, counts sum to "
                         f"{n_box + n_cyl + n_sph + n_tri}")
    dev = pose.device
    _check("pose", pose, torch.float32, (N, 8), dev)
    _check("prims", prims, torch.float32, (N, P, 16), dev)
    _check("dirs", dirs, torch.float32, tuple(dirs.shape[:-1]) + (3,), dev)
    _check("mult", mult, torch.float32, tuple(dirs.shape[:-1]) if mult.dim() > 1 else (R,), dev)
    if N * -(-H // PATCH[0]) * -(-W // PATCH[1]) > 2 ** 31 - 1:
        raise ValueError(f"{N} envs x {H}x{W} rays exceed the kernel's grid limit")
    lib = _load()
    if mode == MODE_RGB:
        _set_shading(lib, dev)
    depth = torch.empty((N, R), dtype=torch.float32, device=dev)
    seg = torch.empty((N, R), dtype=torch.int32, device=dev) if mode != MODE_DEPTH else None
    face = torch.empty((N, R), dtype=torch.int32, device=dev) if mode == MODE_NORMALS else None
    vec = (torch.empty((N, R, 3), dtype=torch.float32, device=dev)
           if mode >= MODE_NORMALS else None)
    if N == 0 or R == 0:
        return _outputs(mode, depth, seg, face, vec)
    ptr = lambda t: None if t is None else t.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.raycast_launch(pose.data_ptr(), prims.data_ptr(), dirs.data_ptr(),
                            mult.data_ptr(), depth.data_ptr(), ptr(seg), ptr(face), ptr(vec),
                            N, H, W, P, n_box, n_cyl, n_sph, n_tri, float(max_range),
                            int(bool(cull)), mode, stream)
    if rc != 0:
        raise RuntimeError("raycast kernel launch failed: "
                           + lib.raycast_error_string(rc).decode())
    LAUNCHES[MODE_NAMES[mode]] += 1
    return _outputs(mode, depth, seg, face, vec)
