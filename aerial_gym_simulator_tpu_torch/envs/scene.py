"""Obstacle scene compilation + obstacle state management.

Counterpart of ``aerial_gym_simulator_tpu/envs/scene.py``. URDF assets are
compiled once into padded primitive tables (SceneParams); per-(env, slot)
poses live in SimState, so the render and collision code read poses
directly.
"""

from __future__ import annotations

import glob
import os
from typing import List

import numpy as np
import torch

from ..assets import urdf as urdflib
from ..sim.structs import SceneParams, SimParams, SimState, replace
from ..utils.env_rng import env_rand
from ..utils.math import interpolate_ratio, quat_from_euler_xyz_tensor, quat_integrate

_KIND = {"box": 0, "cylinder": 1, "sphere": 2, "triangle": 3}

# Teleport target for culled obstacles
CULL_POSITION = -1000.0


def build_scene_params(env_cfg, num_envs: int, device, max_prims: int = 16,
                       seed: int = 1234) -> SceneParams:
    """Compile the env's asset catalog into device tables.

    Takes the same random draws, in the same order, as the JAX builder and
    gives the same tables; the per-env primitive soup is assembled with
    numpy instead of a Python loop over envs x slots x prims. An asset
    type's ``asset_folder`` adds every ``*.urdf`` in it, sorted, as a
    variant, compiled by the native batch loader (each variant keeps its
    first ``max_prims`` primitives: pass a larger ``max_prims`` for a whole
    mesh).
    """
    asset_types = getattr(env_cfg, "asset_types", [])
    variants_urdf: List[str] = []        # URDF text, or None for a file's model
    variant_models: dict = {}            # variant index -> model loaded from a file
    variant_type_index: List[int] = []
    type_variant_ranges = []
    for t_idx, at in enumerate(asset_types):
        start = len(variants_urdf)
        folder = getattr(at, "asset_folder", "")
        if folder:
            files = sorted(glob.glob(os.path.join(folder, "*.urdf")))
            from ..assets import native_loader
            models = native_loader.load_urdf_batch(files) if files else None
            if models is None:
                models = [urdflib.load_urdf(f) for f in files]
            for m in models:
                variant_models[len(variants_urdf)] = m
                variants_urdf.append(None)
                variant_type_index.append(t_idx)
        for v in at.urdf_variants:
            variants_urdf.append(v)
            variant_type_index.append(t_idx)
        type_variant_ranges.append((start, len(variants_urdf)))

    V = max(len(variants_urdf), 1)
    P = max_prims
    prim_kind = -np.ones((V, P), np.int32)
    prim_size = np.zeros((V, P, 3), np.float32)
    prim_pos = np.zeros((V, P, 3), np.float32)
    prim_rot = np.tile(np.eye(3, dtype=np.float32), (V, P, 1, 1))
    prim_semantic = np.zeros((V, P), np.int32)
    variant_radius = np.zeros((V,), np.float32)

    sem_counter = 100  # incremental ids for semantic_id == -1 assets
    for v_idx, text in enumerate(variants_urdf):
        at = asset_types[variant_type_index[v_idx]]
        model = (variant_models[v_idx] if text is None else
                 urdflib.load_urdf_string(text, name=f"variant_{v_idx}"))
        for p_idx, pr in enumerate(model.primitives[:P]):
            prim_kind[v_idx, p_idx] = _KIND[pr.kind]
            prim_size[v_idx, p_idx] = pr.size
            prim_pos[v_idx, p_idx] = pr.xyz
            prim_rot[v_idx, p_idx] = pr.rot
            prim_semantic[v_idx, p_idx] = (
                at.semantic_id if at.semantic_id >= 0 else sem_counter)
        variant_radius[v_idx] = model.bound_radius
        sem_counter += 1

    # one slot per asset instance; keep_in_env slots come first so the
    # curriculum's "first num_obstacles slots stay" culling never removes
    # walls or panels (stable sort keeps the catalog order otherwise)
    slot_entries = []
    for t_idx, at in enumerate(asset_types):
        for _ in range(at.num_assets):
            slot_entries.append((0 if at.keep_in_env else 1, t_idx, at))
    slot_entries.sort(key=lambda s: s[0])
    slots_min = [at.min_state_ratio for _, _, at in slot_entries]
    slots_max = [at.max_state_ratio for _, _, at in slot_entries]
    slots_keep = [1.0 if keep == 0 else 0.0 for keep, _, _ in slot_entries]
    slots_sem = [at.semantic_id for _, _, at in slot_entries]
    slot_type = [t_idx for _, t_idx, _ in slot_entries]
    A = len(slots_min)

    # random variant pick per (env, slot)
    rng = np.random.RandomState(seed)
    env_asset_variant = np.zeros((num_envs, A), np.int32)
    for a_idx in range(A):
        lo, hi = type_variant_ranges[slot_type[a_idx]]
        env_asset_variant[:, a_idx] = rng.randint(lo, hi, size=num_envs)

    # ---- flattened per-env primitive soup --------------------------------
    # Prims sorted by kind (box, cylinder, sphere, triangle), each kind
    # padded to its max count across envs; within a kind, slot then prim
    # order. Padding prims keep their kind, zero size, at CULL_POSITION.
    kinds = prim_kind[env_asset_variant]                       # (N, A, P)
    e_idx, a_idx, p_idx = np.nonzero(kinds >= 0)               # row-major order
    v_idx = env_asset_variant[e_idx, a_idx]
    k_idx = kinds[e_idx, a_idx, p_idx]
    counts = np.zeros((4, num_envs), np.int64)
    np.add.at(counts, (k_idx, e_idx), 1)
    kind_max = counts.max(axis=1) if num_envs > 0 else np.zeros(4, np.int64)
    offsets = np.concatenate([[0], np.cumsum(kind_max)[:-1]])
    col = np.zeros_like(e_idx)
    for k in range(4):
        sel = np.nonzero(k_idx == k)[0]
        e_k = e_idx[sel]
        # rank within (env, kind): position minus the env's first position
        first = np.searchsorted(e_k, e_k, side="left")
        col[sel] = offsets[k] + np.arange(len(sel)) - first

    P_env = max(int(kind_max.sum()), 1)
    col_kind = np.repeat(np.arange(4, dtype=np.int32), kind_max)
    ep_kind = np.tile(col_kind if len(col_kind) else -np.ones(1, np.int32),
                      (num_envs, 1))
    ep_slot = np.zeros((num_envs, P_env), np.int64)
    ep_size = np.zeros((num_envs, P_env, 3), np.float32)
    ep_pos = np.full((num_envs, P_env, 3), CULL_POSITION, np.float32)
    ep_rot = np.tile(np.eye(3, dtype=np.float32), (num_envs, P_env, 1, 1))
    ep_sem = np.zeros((num_envs, P_env), np.int32)
    ep_slot[e_idx, col] = a_idx
    ep_size[e_idx, col] = prim_size[v_idx, p_idx]
    ep_pos[e_idx, col] = prim_pos[v_idx, p_idx]
    ep_rot[e_idx, col] = prim_rot[v_idx, p_idx]
    ep_sem[e_idx, col] = prim_semantic[v_idx, p_idx]

    # per-env culling priority: keep slots first, the rest in a per-env
    # random order
    keep_idx = [i for i, k in enumerate(slots_keep) if k > 0]
    free_idx = [i for i, k in enumerate(slots_keep) if k == 0]
    cull_rank = np.zeros((num_envs, A), np.int32)
    ranks = np.arange(A, dtype=np.int32)
    for e in range(num_envs):
        order = keep_idx + list(rng.permutation(free_idx))
        cull_rank[e, order] = ranks

    t = lambda x, dtype=torch.float32: torch.as_tensor(np.asarray(x), dtype=dtype,
                                                       device=device)
    i32 = lambda x: t(x, torch.int32)
    return SceneParams(
        prim_kind=i32(prim_kind),
        prim_size=t(prim_size),
        prim_pos=t(prim_pos),
        prim_rot=t(prim_rot),
        prim_semantic=i32(prim_semantic),
        variant_radius=t(variant_radius),
        env_asset_variant=i32(env_asset_variant),
        min_state_ratio=t(np.asarray(slots_min, np.float32).reshape(A, 13)),
        max_state_ratio=t(np.asarray(slots_max, np.float32).reshape(A, 13)),
        keep_in_env=t(slots_keep),
        semantic_id=i32(np.asarray(slots_sem, np.int32)),
        env_prim_slot=t(ep_slot, torch.int64),
        env_prim_kind=i32(ep_kind),
        env_prim_size=t(ep_size),
        env_prim_pos=t(ep_pos),
        env_prim_rot=t(ep_rot),
        env_prim_semantic=i32(ep_sem),
        cull_rank=i32(cull_rank),
        num_assets=A,
        max_prims=P,
        num_env_prims=P_env,
        n_box=int(kind_max[0]),
        n_cyl=int(kind_max[1]),
        n_sph=int(kind_max[2]),
        n_tri=int(kind_max[3]),
    )


def reset_obstacles(params: SimParams, state: SimState, mask: torch.Tensor) -> SimState:
    """Resample obstacle poses for envs in mask.

    Pose ratios ~ U[min_state_ratio, max_state_ratio] interpolated into the
    env bounds. With probability 0.15 an env gets half its obstacle count
    this episode; culled non-keep_in_env obstacles are parked at -1000.
    """
    sc = params.scene
    N, A = state.obstacle_pos.shape[0], sc.num_assets
    dev, g = state.device, state.rng

    u = env_rand(g, (N, A, 13), device=dev)
    ratios = sc.min_state_ratio + (sc.max_state_ratio - sc.min_state_ratio) * u
    pos = interpolate_ratio(state.bounds_lo[:, None, :], state.bounds_hi[:, None, :],
                            ratios[..., 0:3])
    quat = quat_from_euler_xyz_tensor(ratios[..., 3:6])

    n_keep = torch.sum(sc.keep_in_env)
    num = torch.maximum(state.num_obstacles.to(torch.float32), n_keep)     # (N,)
    half = env_rand(g, (N,), device=dev) < 0.15
    num = torch.where(half, torch.maximum(torch.floor(num / 2.0), n_keep), num)
    culled = ((sc.cull_rank.to(torch.float32) >= num[:, None]).to(torch.float32)
              * (1.0 - sc.keep_in_env[None, :]))
    pos = torch.where(culled[..., None] > 0, torch.full_like(pos, CULL_POSITION), pos)

    m = mask.to(torch.bool)[:, None, None]
    zeros = torch.zeros_like(state.obstacle_linvel)
    return replace(
        state,
        obstacle_pos=torch.where(m, pos, state.obstacle_pos),
        obstacle_quat=torch.where(m, quat, state.obstacle_quat),
        obstacle_linvel=torch.where(m, zeros, state.obstacle_linvel),
        obstacle_angvel=torch.where(m, zeros, state.obstacle_angvel),
    )


def apply_env_actions(params: SimParams, state: SimState,
                      env_actions: torch.Tensor) -> SimState:
    """Dynamic obstacles: env actions -> obstacle twists. (N, W) applies to
    every slot, (N, A, W) per slot; [..., 0:3] is the linear velocity,
    [..., 3:6] the angular one (zero when W < 6). The twists stay until the
    next env actions or the env's reset."""
    if env_actions.dim() == 2:
        env_actions = env_actions[:, None, :].expand(
            state.obstacle_linvel.shape[:2] + (env_actions.shape[-1],))
    linvel = env_actions[..., 0:3]
    angvel = env_actions[..., 3:6] if env_actions.shape[-1] >= 6 else torch.zeros_like(linvel)
    return replace(state, obstacle_linvel=linvel.contiguous(),
                   obstacle_angvel=angvel.contiguous())


def integrate_obstacles(params: SimParams, state: SimState) -> SimState:
    """Kinematic obstacle motion (velocities set by env actions)."""
    dt = params.dt
    pos = state.obstacle_pos + dt * state.obstacle_linvel
    quat = quat_integrate(state.obstacle_quat, state.obstacle_angvel, dt)
    return replace(state, obstacle_pos=pos, obstacle_quat=quat)
