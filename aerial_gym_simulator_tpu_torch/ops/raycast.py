"""Analytic primitive ray casting in plain PyTorch.

Counterpart of ``aerial_gym_simulator_tpu/ops/raycast.py``: every ray
intersects every primitive of its env's soup (box, cylinder, sphere,
triangle) and keeps the nearest hit; the normal/face-id variant also
returns the winner's index and its world surface normal, and
``shade_rgb`` turns that into a Lambert-shaded RGB image. This module is
the oracle of the ray-cast kernel (``ops/raycast_cuda.py``) and holds the
shading constants both share.

The intersection functions take (..., 3) origins and directions already
in the primitive's frame. Each sum is written out in a fixed left-to-right
order, the same order the CUDA kernel uses, so the two agree to the last
bit wherever both round every operation (the kernel is built without
fused multiply-add).
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from ..utils.math import quat_rotate, quat_rotate_inverse, safe_sqrt

NO_HIT_RAY_VAL = 1000.0
NO_HIT_SEGMENTATION_VAL = -2
NO_HIT_FACE_VAL = -1

BIG = 1e10
TRI_EPS = 1e-6

# RGB shading (the JAX package's ops/raycast.py constants): albedo palette
# indexed by |segmentation id| % 10, a sun direction normalized in f32 at
# import, the sky colour of a miss and the ambient share of the shade
SEG_ALBEDO = np.array([
    [0.91, 0.30, 0.24], [0.18, 0.80, 0.44], [0.20, 0.60, 0.86],
    [0.95, 0.77, 0.06], [0.61, 0.35, 0.71], [0.10, 0.74, 0.61],
    [0.90, 0.49, 0.13], [0.52, 0.58, 0.65], [0.93, 0.94, 0.95],
    [0.75, 0.22, 0.17],
], np.float32)
SUN_DIR = np.array([0.35, -0.25, 0.90], np.float32)
SUN_DIR /= np.linalg.norm(SUN_DIR)
SKY_RGB = np.array([0.70, 0.80, 0.92], np.float32)
RGB_AMBIENT = 0.35


def _guard(b):
    """b with |b| < 1e-12 replaced by +-1e-12 (sign of b, +0 -> +)."""
    tiny = torch.where(b < 0, torch.full_like(b, -1e-12), torch.full_like(b, 1e-12))
    return torch.where(torch.abs(b) < 1e-12, tiny, b)


def safe_div(a, b):
    return a / _guard(b)


def _big(like):
    return torch.full_like(like, BIG)


def ray_box(ro, rd, half):
    """Slab test in the box frame. Returns t > 0 (entry, or exit if the
    origin is inside) or BIG."""
    ix = safe_div(1.0, rd[..., 0])
    iy = safe_div(1.0, rd[..., 1])
    iz = safe_div(1.0, rd[..., 2])
    hx, hy, hz = half[..., 0], half[..., 1], half[..., 2]
    t1x, t2x = (-hx - ro[..., 0]) * ix, (hx - ro[..., 0]) * ix
    t1y, t2y = (-hy - ro[..., 1]) * iy, (hy - ro[..., 1]) * iy
    t1z, t2z = (-hz - ro[..., 2]) * iz, (hz - ro[..., 2]) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                         torch.maximum(t1z, t2z))
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(tmin > 0.0, tmin, tmax)
    return torch.where(hit & (t > 0.0), t, _big(t))


def ray_sphere(ro, rd, r):
    """Sphere of radius r at the origin of ro's frame."""
    b = ro[..., 0] * rd[..., 0] + ro[..., 1] * rd[..., 1] + ro[..., 2] * rd[..., 2]
    c = (ro[..., 0] * ro[..., 0] + ro[..., 1] * ro[..., 1] + ro[..., 2] * ro[..., 2]) - r * r
    disc = b * b - c
    # safe_sqrt: the backward of sqrt(max(disc, 0)) is NaN where disc is
    # exactly 0, as rays against a parked obstacle's zero-size primitive
    # give; the forward is the same number (a +-0 root only reaches t where
    # disc >= 0, and there -b -+ 0 is -b)
    sq = safe_sqrt(disc)
    t0 = -b - sq
    t1 = -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    return torch.where((disc >= 0.0) & (t > 0.0), t, _big(t))


def ray_cylinder(ro, rd, r, h):
    """Capped z-aligned cylinder of radius r, full length h."""
    rox, roy, roz = ro[..., 0], ro[..., 1], ro[..., 2]
    rdx, rdy, rdz = rd[..., 0], rd[..., 1], rd[..., 2]
    a = rdx * rdx + rdy * rdy
    b = rox * rdx + roy * rdy
    c = (rox * rox + roy * roy) - r * r
    disc = b * b - a * c
    sq = safe_sqrt(disc)           # a finite gradient at disc = 0, as in ray_sphere
    inv_a = safe_div(1.0, a)
    ts0 = (-b - sq) * inv_a
    ts1 = (-b + sq) * inv_a
    half = 0.5 * h

    def side(t):
        z = roz + t * rdz
        ok = (disc >= 0.0) & (t > 0.0) & (torch.abs(z) <= half) & (a > 1e-12)
        return torch.where(ok, t, _big(t))

    def cap(zc):
        t = safe_div(zc - roz, rdz)
        x = rox + t * rdx
        y = roy + t * rdy
        ok = (t > 0.0) & (x * x + y * y <= r * r) & (torch.abs(rdz) > 1e-12)
        return torch.where(ok, t, _big(t))

    return torch.minimum(torch.minimum(side(ts0), side(ts1)),
                         torch.minimum(cap(half), cap(-half)))


def ray_triangle(ro, rd, size):
    """Two-sided triangle in its own frame: z = 0 plane, vertices (0,0),
    (a,0), (b,c) with (a, b, c) = size."""
    a, b, c = size[..., 0], size[..., 1], size[..., 2]
    t = safe_div(-ro[..., 2], rd[..., 2])
    x = ro[..., 0] + t * rd[..., 0]
    y = ro[..., 1] + t * rd[..., 1]
    v = safe_div(y, c)
    u = safe_div(x - v * b, a)
    ok = ((t > 0.0) & (torch.abs(rd[..., 2]) > 1e-9) & (u >= -TRI_EPS)
          & (v >= -TRI_EPS) & (u + v <= 1.0 + TRI_EPS) & (a > 0.0))
    return torch.where(ok, t, _big(t))


def ray_primitive(kind, size, ro, rd):
    """Dispatch on kind: 0 box, 1 cylinder, 2 sphere, 3 triangle, -1 pad."""
    t_box = ray_box(ro, rd, 0.5 * size)
    t_cyl = ray_cylinder(ro, rd, size[..., 0], size[..., 1])
    t_sph = ray_sphere(ro, rd, size[..., 0])
    t_tri = ray_triangle(ro, rd, size)
    t = torch.where(kind == 0, t_box,
                    torch.where(kind == 1, t_cyl,
                                torch.where(kind == 3, t_tri, t_sph)))
    return torch.where(kind < 0, _big(t), t)


def raycast_env(prim_kind, prim_size, prim_pos, prim_rot, prim_sem, prim_slot,
                asset_pos, asset_quat, ro, rd, max_range):
    """One env: prim tables (P, ...), asset poses (A, 3/4), origin (3,),
    world dirs (R, 3) -> t (R,), semantic id (R,)."""
    scene = SimpleNamespace(env_prim_kind=prim_kind[None], env_prim_size=prim_size[None],
                            env_prim_pos=prim_pos[None], env_prim_rot=prim_rot[None],
                            env_prim_semantic=prim_sem[None], env_prim_slot=prim_slot[None])
    t, sem = raycast_batched(scene, asset_pos[None], asset_quat[None], ro[None],
                             rd[None], max_range)
    return t[0], sem[0]


def raycast_batched(scene, obstacle_pos, obstacle_quat, ro, rd, max_range):
    """Cast (N, R) world rays from origins ro (N, 3) with dirs rd (N, R, 3)
    against each env's primitive soup, primitive by primitive in table
    order. Returns t (N, R) and semantic id (N, R) int32."""
    N, R = rd.shape[0], rd.shape[1]
    t_best = torch.full((N, R), BIG, dtype=torch.float32, device=rd.device)
    s_best = torch.full((N, R), NO_HIT_SEGMENTATION_VAL, dtype=torch.int32,
                        device=rd.device)
    ar = torch.arange(N, device=rd.device)
    for p in range(scene.env_prim_kind.shape[1]):
        slot = scene.env_prim_slot[:, p]
        a_pos, a_quat = obstacle_pos[ar, slot], obstacle_quat[ar, slot]   # (N, 3/4)
        prot = scene.env_prim_rot[:, p]                                   # (N, 3, 3)
        # world -> asset -> primitive frame (R^T (x - p))
        ro_a = quat_rotate_inverse(a_quat, ro - a_pos) - scene.env_prim_pos[:, p]
        rd_a = quat_rotate_inverse(a_quat[:, None, :], rd)
        ro_p = torch.sum(prot * ro_a[:, :, None], dim=1)                  # (N, 3)
        rd_p = torch.sum(prot[:, None] * rd_a[..., :, None], dim=2)       # (N, R, 3)
        t = ray_primitive(scene.env_prim_kind[:, p, None],
                          scene.env_prim_size[:, p, None, :], ro_p[:, None, :], rd_p)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        s_best = torch.where(closer, scene.env_prim_semantic[:, p, None], s_best)
    miss = t_best >= min(max_range, BIG * 0.5)
    t_best = torch.where(miss, torch.full_like(t_best, NO_HIT_RAY_VAL), t_best)
    s_best = torch.where(miss, torch.full_like(s_best, NO_HIT_SEGMENTATION_VAL), s_best)
    return t_best, s_best


# ---------------------------------------------------------------------------
# normal + face-id variant (the reference's NormalFaceID cameras and lidars:
# per-pixel surface normal + face id; the primitive index is the face id)
# ---------------------------------------------------------------------------


def primitive_normal(kind, size, hit_p):
    """Surface normal at a point on the primitive, in the primitive frame.
    kind (...), size (..., 3), hit_p (..., 3)."""
    half = 0.5 * size
    # box: dominant axis of |p| / half (argmax: x wins ties, then y)
    q = torch.abs(hit_p) / torch.clamp(half, min=1e-9)
    axis = torch.argmax(q, dim=-1)
    n_box = torch.sign(hit_p) * torch.nn.functional.one_hot(axis, 3).to(hit_p.dtype)
    # sphere: radial
    n_sph = hit_p / torch.clamp(torch.linalg.norm(hit_p, dim=-1, keepdim=True), min=1e-9)
    # cylinder: side vs cap
    h = size[..., 1:2]
    on_cap = torch.abs(torch.abs(hit_p[..., 2:3]) - 0.5 * h) < 1e-4
    side = torch.cat([hit_p[..., 0:2], torch.zeros_like(hit_p[..., 2:3])], dim=-1)
    side = side / torch.clamp(torch.linalg.norm(side, dim=-1, keepdim=True), min=1e-9)
    cap = torch.cat([torch.zeros_like(hit_p[..., 0:2]), torch.sign(hit_p[..., 2:3])], dim=-1)
    n_cyl = torch.where(on_cap, cap, side)
    # triangle: +z of its own frame
    n_tri = torch.zeros_like(hit_p)
    n_tri[..., 2] = 1.0
    k = kind[..., None]
    return torch.where(k == 0, n_box,
                       torch.where(k == 1, n_cyl, torch.where(k == 3, n_tri, n_sph)))


def raycast_env_normals(prim_kind, prim_size, prim_pos, prim_rot, prim_sem, prim_slot,
                        asset_pos, asset_quat, ro, rd, max_range):
    """One env: like raycast_env, also returning the world normal (R, 3)
    and the winning primitive index (R,) int32 (-1 on a miss)."""
    scene = SimpleNamespace(env_prim_kind=prim_kind[None], env_prim_size=prim_size[None],
                            env_prim_pos=prim_pos[None], env_prim_rot=prim_rot[None],
                            env_prim_semantic=prim_sem[None], env_prim_slot=prim_slot[None])
    out = raycast_batched_normals(scene, asset_pos[None], asset_quat[None], ro[None],
                                  rd[None], max_range)
    return tuple(x[0] for x in out)


def raycast_batched_normals(scene, obstacle_pos, obstacle_quat, ro, rd, max_range):
    """raycast_batched that also tracks the winning primitive ("face id")
    and then recomputes the hit point in the winner's frame for its
    normal, rotated to world and oriented against the ray. Returns t
    (N, R), semantic id (N, R) int32, normal (N, R, 3) (0 on a miss) and
    face id (N, R) int32 (-1 on a miss)."""
    N, R = rd.shape[0], rd.shape[1]
    dev = rd.device
    t_best = torch.full((N, R), BIG, dtype=torch.float32, device=dev)
    s_best = torch.full((N, R), NO_HIT_SEGMENTATION_VAL, dtype=torch.int32, device=dev)
    i_best = torch.full((N, R), NO_HIT_FACE_VAL, dtype=torch.int32, device=dev)
    ar = torch.arange(N, device=dev)
    for p in range(scene.env_prim_kind.shape[1]):
        slot = scene.env_prim_slot[:, p]
        a_pos, a_quat = obstacle_pos[ar, slot], obstacle_quat[ar, slot]
        prot = scene.env_prim_rot[:, p]
        ro_a = quat_rotate_inverse(a_quat, ro - a_pos) - scene.env_prim_pos[:, p]
        rd_a = quat_rotate_inverse(a_quat[:, None, :], rd)
        ro_p = torch.sum(prot * ro_a[:, :, None], dim=1)
        rd_p = torch.sum(prot[:, None] * rd_a[..., :, None], dim=2)
        t = ray_primitive(scene.env_prim_kind[:, p, None],
                          scene.env_prim_size[:, p, None, :], ro_p[:, None, :], rd_p)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        s_best = torch.where(closer, scene.env_prim_semantic[:, p, None], s_best)
        i_best = torch.where(closer, torch.full_like(i_best, p), i_best)

    # the winner's tables per ray; the hit point recomputed in its frame
    fi = torch.clamp(i_best, min=0).long()                              # (N, R)
    take = lambda table: table[ar[:, None], fi]
    kind, size, ppos, prot = (take(scene.env_prim_kind), take(scene.env_prim_size),
                              take(scene.env_prim_pos), take(scene.env_prim_rot))
    slot = take(scene.env_prim_slot)
    a_pos, a_quat = obstacle_pos[ar[:, None], slot], obstacle_quat[ar[:, None], slot]
    ro_a = quat_rotate_inverse(a_quat, ro[:, None, :] - a_pos) - ppos
    rd_a = quat_rotate_inverse(a_quat, rd)
    ro_p = torch.einsum("nrji,nrj->nri", prot, ro_a)
    rd_p = torch.einsum("nrji,nrj->nri", prot, rd_a)
    hit_p = ro_p + t_best[..., None] * rd_p
    n_w = quat_rotate(a_quat, torch.einsum("nrij,nrj->nri", prot,
                                           primitive_normal(kind, size, hit_p)))
    n_w = torch.where(torch.sum(n_w * rd, dim=-1, keepdim=True) > 0, -n_w, n_w)

    miss = t_best >= min(max_range, BIG * 0.5)
    t_best = torch.where(miss, torch.full_like(t_best, NO_HIT_RAY_VAL), t_best)
    s_best = torch.where(miss, torch.full_like(s_best, NO_HIT_SEGMENTATION_VAL), s_best)
    i_best = torch.where(miss, torch.full_like(i_best, NO_HIT_FACE_VAL), i_best)
    n_w = torch.where(miss[..., None], torch.zeros_like(n_w), n_w)
    return t_best, s_best, n_w, i_best


def shade_rgb(depth, normals, face_id, seg, max_range):
    """Lambert shading of a render -> (..., 3) f32 in [0, 1]: albedo from
    the segmentation palette, double-sided diffuse |n . sun| with an
    ambient floor, a fade to half brightness at max_range, sky where
    nothing was hit. depth, face_id, seg (...); normals (..., 3). The
    ray-cast kernel's RGB mode evaluates the same expressions in the same
    order."""
    sun = [float(x) for x in SUN_DIR]
    lam = torch.abs(normals[..., 0] * sun[0] + normals[..., 1] * sun[1]
                    + normals[..., 2] * sun[2])
    shade = RGB_AMBIENT + (1.0 - RGB_AMBIENT) * lam
    # divide by a tensor: a CUDA tensor divided by a Python float is
    # multiplied by its reciprocal, which is not the kernel's division
    ratio = depth / torch.full_like(depth, max_range)
    lit = shade * (1.0 - 0.5 * torch.clamp(ratio, 0.0, 1.0))
    k = (torch.abs(seg) % SEG_ALBEDO.shape[0]).long()
    albedo = torch.as_tensor(SEG_ALBEDO, device=depth.device)[k]       # (..., 3)
    sky = torch.as_tensor(SKY_RGB, device=depth.device)
    return torch.where((face_id >= 0)[..., None], albedo * lit[..., None], sky)
