"""Config copies of the slice and their registration by name."""

from __future__ import annotations


def register_all():
    from ..registry.registries import (
        controller_registry,
        env_config_registry,
        robot_registry,
        sim_config_registry,
    )
    from .controller_config.lee_controller_config import (
        lee_controller_config,
        lmf2_controller_config,
    )
    from .env_config.base_env_config import EmptyEnvConfig
    from .env_config.obstacle_envs import EnvWithObstaclesConfig
    from .robot_config import catalog as robot_catalog
    from .sim_config.base_sim_config import BaseSimConfig

    sim_config_registry.register("base_sim", BaseSimConfig)
    env_config_registry.register("empty_env", EmptyEnvConfig)
    env_config_registry.register("env_with_obstacles", EnvWithObstaclesConfig)
    robot_catalog.register_robots(robot_registry)
    for name in ("lee_position_control", "lee_velocity_control",
                 "lee_attitude_control"):
        controller_registry.register(
            name, (lambda n: (lambda: lee_controller_config(n)))(name))

    def lmf2_velocity_control():
        cfg = lmf2_controller_config("lmf2_velocity_control")
        cfg.base_controller = "lee_velocity_control"
        return cfg

    controller_registry.register("lmf2_velocity_control", lmf2_velocity_control)
