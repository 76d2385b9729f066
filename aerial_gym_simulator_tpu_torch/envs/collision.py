"""Robot-obstacle contact proxy via signed-distance queries.

Counterpart of ``aerial_gym_simulator_tpu/envs/collision.py``: the robot is
its bounding sphere, obstacles are primitive soups, and penetration depth
becomes a stiff penalty-force magnitude that the crash test thresholds.
"""

from __future__ import annotations

import torch

from ..sim.structs import SimParams, SimState
from ..utils.math import quat_rotate_inverse, safe_norm, safe_sqrt

STIFFNESS = 1000.0  # N/m


def _sd_box(p, half):
    q = torch.abs(p) - half
    outside = safe_norm(torch.clamp(q, min=0.0), dim=-1)
    inside = torch.clamp(torch.amax(q, dim=-1), max=0.0)
    return outside + inside


def _sd_cylinder(p, r, h):
    """Z-aligned capped cylinder at origin; h = full length."""
    d_xy = safe_norm(p[..., :2], dim=-1) - r
    d_z = torch.abs(p[..., 2]) - 0.5 * h
    outside = safe_norm(torch.stack([torch.clamp(d_xy, min=0.0),
                                     torch.clamp(d_z, min=0.0)], dim=-1), dim=-1)
    inside = torch.clamp(torch.maximum(d_xy, d_z), max=0.0)
    return outside + inside


def _sd_sphere(p, r):
    return safe_norm(p, dim=-1) - r


def _sd_triangle(p, size):
    """Unsigned distance to a triangle in its own frame (z = 0 plane,
    vertices (0,0), (a,0), (b,c))."""
    a, b, c = size[..., 0], size[..., 1], size[..., 2]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zeros = torch.zeros_like(a)

    def seg_dist2(px, py, ax_, ay, bx, by):
        dx_, dy_ = bx - ax_, by - ay
        tt = torch.clamp(((px - ax_) * dx_ + (py - ay) * dy_)
                         / torch.clamp(dx_ * dx_ + dy_ * dy_, min=1e-12), 0.0, 1.0)
        cx, cy = ax_ + tt * dx_, ay + tt * dy_
        return (px - cx) ** 2 + (py - cy) ** 2

    v = y / torch.clamp(c, min=1e-12)
    u = (x - v * b) / torch.clamp(a, min=1e-12)
    inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    d_edge2 = torch.minimum(
        torch.minimum(seg_dist2(x, y, zeros, zeros, a, zeros),
                      seg_dist2(x, y, a, zeros, b, c)),
        seg_dist2(x, y, b, c, zeros, zeros))
    d2_plane = torch.where(inside, torch.zeros_like(d_edge2), d_edge2)
    return safe_sqrt(d2_plane + z * z)


def primitive_sdf(kind, size, p):
    """Dispatch on kind: 0 box, 1 cylinder, 2 sphere, 3 triangle, -1 pad."""
    d_box = _sd_box(p, 0.5 * size)
    d_cyl = _sd_cylinder(p, size[..., 0], size[..., 1])
    d_sph = _sd_sphere(p, size[..., 0])
    d_tri = _sd_triangle(p, size)
    d = torch.where(kind == 0, d_box,
                    torch.where(kind == 1, d_cyl,
                                torch.where(kind == 3, d_tri, d_sph)))
    return torch.where(kind < 0, torch.full_like(d, 1e6), d)


def gather_slots(slot: torch.Tensor, per_slot: torch.Tensor) -> torch.Tensor:
    """(N, P) slot indices into (N, A, D) per-slot rows -> (N, P, D)."""
    idx = slot[..., None].expand(slot.shape + (per_slot.shape[-1],))
    return torch.gather(per_slot, 1, idx)


def scene_sdf_point(params: SimParams, state: SimState, p_world: torch.Tensor):
    """Min signed distance from world points (N, 3) to each env's obstacles."""
    sc = params.scene
    a_pos = gather_slots(sc.env_prim_slot, state.obstacle_pos)     # (N, P, 3)
    a_quat = gather_slots(sc.env_prim_slot, state.obstacle_quat)   # (N, P, 4)
    rel = p_world[:, None, :] - a_pos
    p_asset = quat_rotate_inverse(a_quat, rel)
    rel_p = p_asset - sc.env_prim_pos
    local = torch.sum(sc.env_prim_rot * rel_p[..., :, None], dim=-2)  # R^T @ rel
    d = primitive_sdf(sc.env_prim_kind, sc.env_prim_size, local)   # (N, P)
    return torch.amin(d, dim=1)


def obstacle_contact_forces(params: SimParams, state: SimState) -> torch.Tensor:
    """Penalty contact-force magnitude per env (robot bounding sphere)."""
    d = scene_sdf_point(params, state, state.pos)
    penetration = torch.clamp(params.robot.collision_radius - d, min=0.0)
    return STIFFNESS * penetration
