"""Environment config base (bounds, substep schedule, collision policy),
copied from the JAX package's ``config/env_config/base_env_config.py``."""

from dataclasses import dataclass, field
from typing import Dict, Tuple


@dataclass
class EnvConfig:
    name: str = "base_env"
    num_envs: int = 64
    num_env_actions: int = 0        # actions consumed by env entities (obstacles)
    env_spacing: float = 1.0
    # physics substeps per env step ~ floor(N(mean, std))
    num_physics_steps_per_env_step_mean: int = 1
    num_physics_steps_per_env_step_std: float = 0.0
    collision_force_threshold: float = 0.010   # [N]
    reset_on_collision: bool = True
    create_ground_plane: bool = False
    # per-env bounds are sampled in [lower_bound_min, lower_bound_max] and
    # [upper_bound_min, upper_bound_max] at every reset
    lower_bound_min: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    lower_bound_max: Tuple[float, float, float] = (-1.0, -1.0, -1.0)
    upper_bound_min: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    upper_bound_max: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # obstacle asset catalog: {asset_type_name: num_assets}; empty = no obstacles
    asset_counts: Dict[str, int] = field(default_factory=dict)


@dataclass
class EmptyEnvConfig(EnvConfig):
    """No obstacles, one physics step per env step: the position task's
    environment (num_envs is always overridden by the task or by SimBuilder)."""
    name: str = "empty_env"
    num_envs: int = 3
    num_physics_steps_per_env_step_mean: int = 1
    num_physics_steps_per_env_step_std: float = 0.0
    collision_force_threshold: float = 0.010
    reset_on_collision: bool = True


@dataclass
class EmptyEnv2MsConfig(EmptyEnvConfig):
    """Five physics substeps per env step: a 10 ms control interval at the
    2 ms sim dt."""
    name: str = "empty_env_2ms"
    num_physics_steps_per_env_step_mean: int = 5
    num_physics_steps_per_env_step_std: float = 0.0
