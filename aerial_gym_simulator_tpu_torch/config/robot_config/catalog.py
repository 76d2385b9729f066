"""Robot catalog entries of the slice, copied from the JAX package's
``config/robot_config/catalog.py``."""

from __future__ import annotations

from .base_quad_config import RobotConfig


def base_quadrotor() -> RobotConfig:
    return RobotConfig(name="base_quadrotor")


def base_quadrotor_with_camera() -> RobotConfig:
    cfg = RobotConfig(name="base_quadrotor_with_camera")
    cfg.sensor_config.enable_camera = True
    return cfg


def register_robots(robot_registry):
    robot_registry.register("base_quadrotor", base_quadrotor)
    robot_registry.register("base_quadrotor_with_camera", base_quadrotor_with_camera)
