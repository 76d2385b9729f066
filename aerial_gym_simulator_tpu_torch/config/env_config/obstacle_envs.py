"""Obstacle environment configs, copied from the JAX package's
``config/env_config/obstacle_envs.py``: ``env_with_obstacles``,
``env_with_lidar_nav_obstacles``, ``forest_env`` and ``dynamic_env``."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

from ..asset_config import env_object_config as eoc
from .base_env_config import EnvConfig


def _obstacle_assets():
    return [
        eoc.panel_asset_params(3),
        eoc.object_asset_params(35),
        eoc.left_wall(),
        eoc.right_wall(),
        eoc.back_wall(),
        eoc.front_wall(),
        eoc.top_wall(),
        eoc.bottom_wall(),
    ]


@dataclass
class ObstacleEnvConfig(EnvConfig):
    asset_types: List[eoc.AssetTypeConfig] = field(default_factory=list)


@dataclass
class EnvWithObstaclesConfig(ObstacleEnvConfig):
    name: str = "env_with_obstacles"
    num_envs: int = 64
    num_env_actions: int = 4
    env_spacing: float = 5.0
    num_physics_steps_per_env_step_mean: int = 10
    num_physics_steps_per_env_step_std: float = 0.0
    collision_force_threshold: float = 0.05
    reset_on_collision: bool = True
    lower_bound_min: Tuple[float, float, float] = (-2.0, -4.0, -3.0)
    lower_bound_max: Tuple[float, float, float] = (-1.0, -2.5, -2.0)
    upper_bound_min: Tuple[float, float, float] = (9.0, 2.5, 2.0)
    upper_bound_max: Tuple[float, float, float] = (10.0, 4.0, 3.0)
    asset_types: List[eoc.AssetTypeConfig] = field(default_factory=_obstacle_assets)

    def __post_init__(self):
        self.asset_counts = {t.name: t.num_assets for t in self.asset_types}


def _lidar_nav_assets():
    return [
        eoc.lidar_nav_panel_asset_params(15),
        eoc.lidar_nav_object_asset_params(70),
        eoc.lidar_nav_wall(eoc.left_wall),
        eoc.lidar_nav_wall(eoc.right_wall),
        eoc.lidar_nav_wall(eoc.back_wall),
        eoc.lidar_nav_wall(eoc.front_wall),
        eoc.lidar_nav_wall(eoc.top_wall),
        eoc.lidar_nav_wall(eoc.bottom_wall),
    ]


@dataclass
class LidarNavObstaclesConfig(EnvWithObstaclesConfig):
    """The lidar-nav catalog (15 panels, 70 objects, cullable walls) in a
    larger arena with wider random bounds."""
    name: str = "env_with_lidar_nav_obstacles"
    collision_force_threshold: float = 0.05
    lower_bound_min: Tuple[float, float, float] = (-7.5, -7.5, -5.0)
    lower_bound_max: Tuple[float, float, float] = (-5.0, -5.0, -3.0)
    upper_bound_min: Tuple[float, float, float] = (5.0, 5.0, 3.0)
    upper_bound_max: Tuple[float, float, float] = (7.5, 7.5, 5.0)
    asset_types: List[eoc.AssetTypeConfig] = field(default_factory=_lidar_nav_assets)


@dataclass
class ForestEnvConfig(ObstacleEnvConfig):
    """A tree, 35 objects and the floor in a 10 m arena; the 4-wide env
    actions give the obstacles linear velocities only."""
    name: str = "forest_env"
    num_envs: int = 64
    num_env_actions: int = 4
    env_spacing: float = 5.0
    num_physics_steps_per_env_step_mean: int = 10
    num_physics_steps_per_env_step_std: float = 0.0
    collision_force_threshold: float = 0.005
    lower_bound_min: Tuple[float, float, float] = (-5.0, -5.0, -1.0)
    lower_bound_max: Tuple[float, float, float] = (-5.0, -5.0, -1.0)
    upper_bound_min: Tuple[float, float, float] = (5.0, 5.0, 3.0)
    upper_bound_max: Tuple[float, float, float] = (5.0, 5.0, 3.0)
    asset_types: List[eoc.AssetTypeConfig] = field(
        default_factory=lambda: [
            eoc.tree_asset_params(1),
            eoc.object_asset_params(35),
            eoc.bottom_wall(),
        ])

    def __post_init__(self):
        self.asset_counts = {t.name: t.num_assets for t in self.asset_types}


@dataclass
class DynamicEnvironmentConfig(EnvWithObstaclesConfig):
    """40 free objects (no panels or walls) over a ground plane, moved by
    6-wide twist env actions [vx vy vz wx wy wz]."""
    name: str = "dynamic_env"
    num_env_actions: int = 6
    create_ground_plane: bool = True
    lower_bound_min: Tuple[float, float, float] = (-2.0, -4.0, 0.0)
    lower_bound_max: Tuple[float, float, float] = (-1.0, -2.5, 0.0)
    upper_bound_min: Tuple[float, float, float] = (9.0, 2.5, 4.0)
    upper_bound_max: Tuple[float, float, float] = (10.0, 4.0, 5.0)
    asset_types: List[eoc.AssetTypeConfig] = field(
        default_factory=lambda: [eoc.dynamic_object_asset_params(40)])
