"""Config copies of the slice and their registration by name."""

from __future__ import annotations

# the Lee controller modes of the robot gain families
CONTROL_MODES = ("position", "velocity", "attitude", "rates", "acceleration")


def register_all():
    from ..registry.registries import (
        controller_registry,
        env_config_registry,
        robot_registry,
        sim_config_registry,
    )
    from .controller_config.lee_controller_config import (
        NoControlConfig,
        lee_controller_config,
        lmf2_controller_config,
        magpie_controller_config,
        octarotor_controller_config,
        rov_fully_actuated_controller_config,
    )
    from .env_config.base_env_config import EmptyEnv2MsConfig, EmptyEnvConfig
    from .env_config.obstacle_envs import (
        DynamicEnvironmentConfig,
        EnvWithObstaclesConfig,
        ForestEnvConfig,
        LidarNavObstaclesConfig,
    )
    from .robot_config import catalog as robot_catalog
    from .sim_config.base_sim_config import (
        BaseSimConfig,
        BaseSimHeadlessConfig,
        BaseSimNoGravityConfig,
        SimConfig2Ms,
        SimConfig4Ms,
    )

    sim_config_registry.register("base_sim", BaseSimConfig)
    sim_config_registry.register("base_sim_headless", BaseSimHeadlessConfig)
    sim_config_registry.register("base_sim_2ms", SimConfig2Ms)
    sim_config_registry.register("base_sim_4ms", SimConfig4Ms)
    sim_config_registry.register("base_sim_no_gravity", BaseSimNoGravityConfig)
    env_config_registry.register("empty_env", EmptyEnvConfig)
    env_config_registry.register("empty_env_2ms", EmptyEnv2MsConfig)
    env_config_registry.register("env_with_obstacles", EnvWithObstaclesConfig)
    env_config_registry.register("env_with_lidar_nav_obstacles", LidarNavObstaclesConfig)
    env_config_registry.register("forest_env", ForestEnvConfig)
    env_config_registry.register("dynamic_env", DynamicEnvironmentConfig)
    robot_catalog.register_robots(robot_registry)
    for name in ("lee_position_control", "lee_velocity_control", "lee_attitude_control",
                 "lee_rates_control", "lee_acceleration_control",
                 "lee_velocity_steering_angle_control"):
        controller_registry.register(
            name, (lambda n: (lambda: lee_controller_config(n)))(name))
    # the 6-DoF pose controller takes 7 actions [x, y, z, qx, qy, qz, qw]
    controller_registry.register(
        "fully_actuated_control", lambda: lee_controller_config("fully_actuated_control", 7))
    controller_registry.register("no_control", NoControlConfig)

    # robot-specific gain sets, "{robot}_{mode}_control" on the Lee base
    # controller of that mode
    def robot_controller(factory, name, base):
        cfg = factory(name)
        cfg.base_controller = base
        return cfg

    for robot, factory in (("magpie", magpie_controller_config),
                           ("lmf2", lmf2_controller_config),
                           ("octarotor", octarotor_controller_config)):
        for mode in CONTROL_MODES:
            name = f"{robot}_{mode}_control"
            controller_registry.register(
                name, (lambda f, n, b: (lambda: robot_controller(f, n, b)))(
                    factory, name, f"lee_{mode}_control"))

    def rov_controller():
        cfg = rov_fully_actuated_controller_config()
        cfg.base_controller = "fully_actuated_control"
        return cfg

    controller_registry.register("rov_fully_actuated_control", rov_controller)
