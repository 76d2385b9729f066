"""Least time of one ray-cast call on the card, counted from its work.

A frozen copy of ``chip_smoke.py``'s ray-cast count (``FLOPS_PER_TEST``,
``STAGE_FLOPS``, ``FLOPS_PER_RAY``, ``OUT_BYTES_PER_RAY``: lines 589-612;
``sweep_counts`` and ``bound_ms``: lines 771-830, depth and segmentation
modes) at the commit that added this benchmark, with the broad-phase count
of ``ops/raycast_cuda.bounding_radius`` / ``bounding_sphere_hits`` (lines
154-235) rewritten here in plain torch, so that no edit of the port moves
it.

The least time is the larger of the bytes the call must move (tables in
once, images out once) over the memory bandwidth and, over the f32 peak,
the operations that a sweep culled by the primitives' bounding spheres
cannot avoid: each ray's world rotation, every (ray, primitive) test whose
bounding sphere the ray's half-line meets within max_range, and the staged
constants of each (env, primitive) pair among them. Operation counts were
read off ``csrc/raycast.cu``: multiplies, adds, divides, square roots and
min/max; compares and selects are not counted.
"""

from __future__ import annotations

import torch

from ..reference.raycast import rotate_dirs
from .peaks import PEAK_BYTES, PEAK_F32_FLOPS

FLOPS_PER_TEST = {0: 35, 1: 54, 2: 11, 3: 25}   # box, cylinder, sphere, triangle
STAGE_FLOPS = {0: 30, 1: 26, 2: 10, 3: 18}
FLOPS_PER_RAY = 31
OUT_BYTES_PER_RAY = {"depth": 4, "seg": 8}


def kinds_of(counts, device):
    """(P,) kind of each column of a table sorted box | cylinder | sphere |
    triangle with ``counts`` = (n_box, n_cyl, n_sph, n_tri)."""
    return torch.cat([torch.full((n,), k, dtype=torch.long, device=device)
                      for k, n in enumerate(counts)])


def bounding_radius(prims, kinds):
    """(N, P) bounding-sphere radius about each primitive's table position:
    box half-diagonal, cylinder corner radius, sphere radius, triangle's
    longest edge from its first vertex."""
    sx, sy, sz = prims[..., 0], prims[..., 1], prims[..., 2]
    return torch.where(kinds == 0, 0.5 * torch.sqrt(sx * sx + sy * sy + sz * sz),
                       torch.where(kinds == 1, torch.sqrt(sx * sx + 0.25 * sy * sy),
                                   torch.where(kinds == 3,
                                               torch.maximum(sx, torch.sqrt(sy * sy + sz * sz)),
                                               sx)))


def sphere_hits(pose, prims, dirs, kinds, max_range, pairs_per_pass: int = 1 << 25):
    """(N, P) float: for each primitive, the rays whose half-line meets its
    bounding sphere (no margin) at a distance below max_range. ``pose``
    (N, 8) [origin, quat, pad], ``prims`` (N, P, 16) world table, ``dirs``
    (R, 3) or (H, W, 3) sensor-frame rays."""
    dirs = dirs.reshape(-1, 3)
    N, P, R = pose.shape[0], prims.shape[1], dirs.shape[0]
    b = bounding_radius(prims, kinds)[:, None, :]
    v = prims[..., 3:6] - pose[:, None, 0:3]
    vv = torch.sum(v * v, dim=-1)[:, None, :]
    counts = torch.zeros((N, P), device=pose.device)
    step = max(1, pairs_per_pass // max(N * P, 1))
    for lo in range(0, R, step):
        dw = rotate_dirs(pose[:, 3:7], dirs[lo:lo + step])
        unit = dw / torch.linalg.norm(dw, dim=-1, keepdim=True)
        along = torch.einsum("nrk,npk->nrp", unit, v)
        perp2 = torch.clamp(vv - along * along, min=0.0)
        entry = along - torch.sqrt(torch.clamp(b * b - perp2, min=0.0))
        meets = (vv <= b * b) | ((along >= 0.0) & (perp2 <= b * b) & (entry < max_range))
        counts += meets.sum(dim=1).float()
    return counts


def least_time_s(pose, prims, dirs, counts, max_range, mode: str, env_chunk: int = 512):
    """-> (seconds, "bytes" or "operations", operations) for one call in
    ``mode`` "depth" or "seg" on these inputs."""
    N, R = pose.shape[0], dirs.numel() // 3
    kinds = kinds_of(counts, pose.device)
    per_test = torch.tensor([float(FLOPS_PER_TEST[int(k)]) for k in kinds], device=pose.device)
    per_stage = torch.tensor([float(STAGE_FLOPS[int(k)]) for k in kinds], device=pose.device)
    ops = float(FLOPS_PER_RAY) * N * R
    for lo in range(0, N, env_chunk):
        need = sphere_hits(pose[lo:lo + env_chunk], prims[lo:lo + env_chunk], dirs, kinds,
                           max_range)
        ops += float((need * per_test).sum() + ((need > 0) * per_stage).sum())
    n_bytes = (4 * (pose.numel() + prims.numel() + dirs.numel() + R)
               + N * R * OUT_BYTES_PER_RAY[mode])
    t_ops, t_bytes = ops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops
