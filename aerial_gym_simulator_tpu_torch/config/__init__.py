"""Config copies of the slice and their registration by name."""

from __future__ import annotations

# the Lee controller modes the port has; "rates" waits for its controller,
# so its names stay unregistered and asking for one raises
CONTROL_MODES = ("position", "velocity", "attitude", "acceleration")


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
        magpie_controller_config,
    )
    from .env_config.base_env_config import EmptyEnvConfig
    from .env_config.obstacle_envs import EnvWithObstaclesConfig, LidarNavObstaclesConfig
    from .robot_config import catalog as robot_catalog
    from .sim_config.base_sim_config import BaseSimConfig

    sim_config_registry.register("base_sim", BaseSimConfig)
    env_config_registry.register("empty_env", EmptyEnvConfig)
    env_config_registry.register("env_with_obstacles", EnvWithObstaclesConfig)
    env_config_registry.register("env_with_lidar_nav_obstacles", LidarNavObstaclesConfig)
    robot_catalog.register_robots(robot_registry)
    for mode in CONTROL_MODES:
        name = f"lee_{mode}_control"
        controller_registry.register(
            name, (lambda n: (lambda: lee_controller_config(n)))(name))

    # robot-specific gain sets, "{robot}_{mode}_control" on the Lee base
    # controller of that mode
    def robot_controller(factory, name, base):
        cfg = factory(name)
        cfg.base_controller = base
        return cfg

    for robot, factory in (("magpie", magpie_controller_config),
                           ("lmf2", lmf2_controller_config)):
        for mode in CONTROL_MODES:
            name = f"{robot}_{mode}_control"
            controller_registry.register(
                name, (lambda f, n, b: (lambda: robot_controller(f, n, b)))(
                    factory, name, f"lee_{mode}_control"))
