"""Environment-object asset types: panels, objects, walls, thin rods,
tiles, trees, the dynamic objects and the lidar-nav catalog.

Copied from the JAX package's ``config/asset_config/env_object_config.py``.
Each type's geometry is a set of procedural URDF variants, plus every
``*.urdf`` of ``asset_folder`` when one is set; one variant is picked per
(env, slot) at build time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from ...assets import procedural

FRONT_WALL_SEMANTIC_ID = 9
BACK_WALL_SEMANTIC_ID = 10
LEFT_WALL_SEMANTIC_ID = 11
RIGHT_WALL_SEMANTIC_ID = 12
BOTTOM_WALL_SEMANTIC_ID = 13
TOP_WALL_SEMANTIC_ID = 14

_pi = np.pi


@dataclass
class AssetTypeConfig:
    name: str
    num_assets: int
    urdf_variants: List[str]             # candidate URDF strings
    min_state_ratio: List[float]
    max_state_ratio: List[float]
    # on-disk variants: every *.urdf in this folder is a candidate too,
    # compiled by the native batch loader (assets/native_loader.py)
    asset_folder: str = ""
    keep_in_env: bool = False
    semantic_id: int = -1                # -1 => per-variant incremental id
    per_link_semantic: bool = False
    collision_mask: int = 1


def _ratio(x, y, z, roll=0.0, pitch=0.0, yaw=0.0):
    return [x, y, z, roll, pitch, yaw, 1.0, 0, 0, 0, 0, 0, 0]


def panel_asset_params(num_assets: int = 3) -> AssetTypeConfig:
    return AssetTypeConfig(
        name="panels",
        num_assets=num_assets,
        urdf_variants=[procedural.box_urdf("panel", (0.1, 1.2, 3.0))],
        min_state_ratio=_ratio(0.3, 0.05, 0.05, 0.0, 0.0, -_pi / 3.0),
        max_state_ratio=_ratio(0.85, 0.95, 0.95, 0.0, 0.0, _pi / 3.0),
        keep_in_env=True,
        semantic_id=-1,
    )


def object_asset_params(num_assets: int = 35) -> AssetTypeConfig:
    rng = np.random.RandomState(7)
    variants = []
    for i in range(12):
        kind = i % 3
        if kind == 0:
            s = rng.uniform(0.2, 0.7, size=3)
            variants.append(procedural.box_urdf(f"obj_cube_{i}", tuple(s)))
        elif kind == 1:
            variants.append(
                procedural.box_urdf(f"obj_rod_{i}",
                                    (rng.uniform(0.05, 0.12), rng.uniform(0.05, 0.12),
                                     rng.uniform(0.8, 2.0))))
        else:
            variants.append(
                procedural.cylinder_urdf(f"obj_cyl_{i}", rng.uniform(0.08, 0.3),
                                         rng.uniform(0.3, 1.5)))
    return AssetTypeConfig(
        name="objects",
        num_assets=num_assets,
        urdf_variants=variants,
        min_state_ratio=_ratio(0.30, 0.05, 0.05, -_pi, -_pi, -_pi),
        max_state_ratio=_ratio(0.85, 0.90, 0.90, _pi, _pi, _pi),
        keep_in_env=False,
        semantic_id=-1,
    )


def thin_asset_params(num_assets: int = 0) -> AssetTypeConfig:
    return AssetTypeConfig(
        name="thin",
        num_assets=num_assets,
        urdf_variants=[procedural.box_urdf("thin_rod", (0.05, 0.05, 2.0))],
        min_state_ratio=_ratio(0.3, 0.05, 0.05, -_pi, -_pi, -_pi),
        max_state_ratio=_ratio(0.85, 0.95, 0.95, _pi, _pi, _pi),
        semantic_id=-1,
    )


def tile_asset_params(num_assets: int = 1) -> AssetTypeConfig:
    """Flat tile panels at a fixed, centred pose."""
    return AssetTypeConfig(
        name="tiles",
        num_assets=num_assets,
        urdf_variants=[procedural.box_urdf("tile", (1.0, 1.0, 0.05))],
        min_state_ratio=_ratio(0.5, 0.5, 0.5),
        max_state_ratio=_ratio(0.5, 0.5, 0.5),
        keep_in_env=True,
        semantic_id=-1,
    )


def tree_asset_params(num_assets: int = 1) -> AssetTypeConfig:
    """Eight procedural trees. ``per_link_semantic`` is set, but the scene
    builder loads variants with one id each (as the JAX package does)."""
    return AssetTypeConfig(
        name="trees",
        num_assets=num_assets,
        urdf_variants=[
            procedural.tree_urdf(f"tree_{i}", trunk_radius=0.05 + 0.02 * (i % 4),
                                 trunk_height=2.0 + 0.5 * (i % 3),
                                 crown_radius=0.5 + 0.15 * (i % 3), seed=i)
            for i in range(8)
        ],
        min_state_ratio=_ratio(0.1, 0.1, 0.0, 0.0, -_pi / 6.0, -_pi),
        max_state_ratio=_ratio(0.9, 0.9, 0.0, 0.0, _pi / 6.0, _pi),
        keep_in_env=True,
        semantic_id=-1,
        per_link_semantic=True,
    )


def _wall(name: str, size, ratio, semantic_id: int) -> AssetTypeConfig:
    return AssetTypeConfig(
        name=name,
        num_assets=1,
        urdf_variants=[procedural.box_urdf(name, size)],
        min_state_ratio=_ratio(*ratio),
        max_state_ratio=_ratio(*ratio),
        keep_in_env=True,
        semantic_id=semantic_id,
    )


def left_wall():
    return _wall("left_wall", (20.0, 0.2, 20.0), (0.5, 1.0, 0.5), LEFT_WALL_SEMANTIC_ID)


def right_wall():
    return _wall("right_wall", (20.0, 0.2, 20.0), (0.5, 0.0, 0.5), RIGHT_WALL_SEMANTIC_ID)


def front_wall():
    return _wall("front_wall", (0.2, 20.0, 20.0), (1.0, 0.5, 0.5), FRONT_WALL_SEMANTIC_ID)


def back_wall():
    return _wall("back_wall", (0.2, 20.0, 20.0), (0.0, 0.5, 0.5), BACK_WALL_SEMANTIC_ID)


def bottom_wall():
    return _wall("bottom_wall", (20.0, 20.0, 0.2), (0.5, 0.5, 0.0), BOTTOM_WALL_SEMANTIC_ID)


def top_wall():
    return _wall("top_wall", (20.0, 20.0, 0.2), (0.5, 0.5, 1.0), TOP_WALL_SEMANTIC_ID)


# the lidar-navigation catalog: a denser scene (15 panels, 70 objects),
# pose ratios reaching the env faces, and no keep_in_env anywhere, walls
# included, so that the task's curriculum may cull every slot


def lidar_nav_panel_asset_params(num_assets: int = 15) -> AssetTypeConfig:
    cfg = panel_asset_params(num_assets)
    cfg.min_state_ratio = _ratio(0.35, 0.0, 0.0, 0.0, 0.0, -_pi / 3.0)
    cfg.max_state_ratio = _ratio(1.0, 1.0, 1.0, 0.0, 0.0, _pi / 3.0)
    cfg.keep_in_env = False
    return cfg


def lidar_nav_object_asset_params(num_assets: int = 70) -> AssetTypeConfig:
    cfg = object_asset_params(num_assets)
    cfg.min_state_ratio = _ratio(0.30, 0.0, 0.0, -_pi, -_pi, -_pi)
    cfg.max_state_ratio = _ratio(1.0, 1.0, 1.0, _pi, _pi, _pi)
    return cfg


def lidar_nav_wall(factory) -> AssetTypeConfig:
    """A wall of the lidar-nav catalog: not kept in the env."""
    cfg = factory()
    cfg.keep_in_env = False
    return cfg


def dynamic_object_asset_params(num_assets: int = 40) -> AssetTypeConfig:
    """The dynamic env's objects: the object catalog, moved by the twists
    of the env actions."""
    return object_asset_params(num_assets)
