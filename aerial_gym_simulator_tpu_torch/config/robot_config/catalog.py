"""Robot catalog entries of the slices, copied from the JAX package's
``config/robot_config/catalog.py``."""

from __future__ import annotations

import math

from .base_quad_config import (
    ControlAllocatorConfig,
    DisturbanceConfig,
    InitConfig,
    MotorModelConfig,
    RobotConfig,
)


def base_quadrotor() -> RobotConfig:
    return RobotConfig(name="base_quadrotor")


def base_quadrotor_with_camera() -> RobotConfig:
    cfg = RobotConfig(name="base_quadrotor_with_camera")
    cfg.sensor_config.enable_camera = True
    return cfg


def base_quadrotor_with_lidar() -> RobotConfig:
    cfg = RobotConfig(name="base_quadrotor_with_lidar")
    cfg.sensor_config.enable_lidar = True
    return cfg


def base_quadrotor_with_faceid_normal_camera() -> RobotConfig:
    """The base quad with the normal + face-id dataset camera."""
    from ..sensor_config.sensor_configs import BaseNormalFaceIDCameraConfig
    cfg = RobotConfig(name="base_quadrotor_with_faceid_normal_camera")
    cfg.sensor_config.enable_camera = True
    cfg.sensor_config.camera_config = BaseNormalFaceIDCameraConfig()
    return cfg


def _motors(use_rps=True, kt_min=0.00000926312, kt_max=0.00001826312,
            tau_inc=(0.04, 0.04), tau_dec=(0.04, 0.04), max_thrust=2.0,
            min_thrust=0.0, max_rate=100000.0, cq=0.01,
            discrete=True) -> MotorModelConfig:
    return MotorModelConfig(
        use_rps=use_rps,
        motor_thrust_constant_min=kt_min,
        motor_thrust_constant_max=kt_max,
        motor_time_constant_increasing_min=tau_inc[0],
        motor_time_constant_increasing_max=tau_inc[1],
        motor_time_constant_decreasing_min=tau_dec[0],
        motor_time_constant_decreasing_max=tau_dec[1],
        max_thrust=max_thrust,
        min_thrust=min_thrust,
        max_thrust_rate=max_rate,
        thrust_to_torque_ratio=cq,
        use_discrete_approximation=discrete,
    )


_LMF2_DIST = lambda: DisturbanceConfig(
    enable_disturbance=True, prob_apply_disturbance=0.05,
    max_force_and_torque_disturbance=[4.75, 4.75, 4.75, 0.03, 0.03, 0.03])


def _init(pos_min, pos_max, rp=0.0, yaw=math.pi, v=0.2, w=0.2,
          pos_ratio_quad=False) -> InitConfig:
    """Init-state ranges [ratio_xyz, roll, pitch, yaw, 1, v, w]."""
    if pos_ratio_quad:
        lo, hi = [0.1, 0.15, 0.15], [0.2, 0.85, 0.85]
    else:
        lo, hi = list(pos_min), list(pos_max)
    return InitConfig(
        min_init_state=lo + [-rp, -rp, -yaw, 1.0] + [-v] * 3 + [-w] * 3,
        max_init_state=hi + [rp, rp, yaw, 1.0] + [v] * 3 + [w] * 3,
    )


def _mass_props(cfg: RobotConfig, mass: float, inertia_diag) -> RobotConfig:
    """Override the URDF's mass properties with the named robot's own."""
    cfg.robot_asset.mass = mass
    cfg.robot_asset.inertia = [[inertia_diag[0], 0.0, 0.0],
                               [0.0, inertia_diag[1], 0.0],
                               [0.0, 0.0, inertia_diag[2]]]
    return cfg


def _quad(name, tx, ty, tz, directions, motors: MotorModelConfig,
          application_mask=None) -> RobotConfig:
    alloc = [
        [0.0, 0.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 0.0],
        [1.0, 1.0, 1.0, 1.0],
        list(tx), list(ty), list(tz),
    ]
    ca = ControlAllocatorConfig(
        num_motors=4,
        application_mask=application_mask or [5, 6, 7, 8],
        motor_directions=list(directions),
        allocation_matrix=alloc,
        motor_model_config=motors,
    )
    return RobotConfig(name=name, control_allocator_config=ca)


def lmf2() -> RobotConfig:
    """The navigation task's platform: a 1.24 kg quad with the depth
    camera, the wrench applied at the root link and a random wrench
    disturbance."""
    cfg = _quad("lmf2",
                [-0.13, -0.13, 0.13, 0.13], [-0.13, 0.13, 0.13, -0.13],
                [-0.07, 0.07, -0.07, 0.07], [1, -1, 1, -1],
                _motors(tau_inc=(0.05, 0.08), tau_dec=(0.005, 0.005),
                        max_thrust=10.0, min_thrust=0.1, cq=0.07))
    cfg.control_allocator_config.force_application_level = "root_link"
    cfg.disturbance = _LMF2_DIST()
    cfg.sensor_config.enable_camera = True
    return _mass_props(cfg, 1.240, [0.0134, 0.0134, 0.0138])


def lmf2_radar() -> RobotConfig:
    """lmf2 with the fake-radar cone in place of the camera."""
    from ..sensor_config.sensor_configs import FakeRadarConfig
    cfg = lmf2()
    cfg.name = "lmf2_radar"
    cfg.sensor_config.enable_camera = False
    cfg.sensor_config.enable_lidar = True
    cfg.sensor_config.lidar_config = FakeRadarConfig()
    return cfg


def magpie() -> RobotConfig:
    """A quad with the Robosense Airy dome lidar (48x120 world-frame
    pointcloud), the wrench applied at the root link."""
    from ..sensor_config.sensor_configs import RSLidarAiryConfig
    cfg = _quad("magpie",
                [-0.13, -0.13, 0.13, 0.13], [-0.13, 0.13, 0.13, -0.13],
                [-0.02, 0.02, -0.02, 0.02], [1, -1, 1, -1],
                _motors(tau_inc=(0.01, 0.02), tau_dec=(0.005, 0.015),
                        max_thrust=12.0, min_thrust=0.1,
                        max_rate=1000000.0, cq=0.02))
    cfg.control_allocator_config.force_application_level = "root_link"
    cfg.init_config = _init(None, None, pos_ratio_quad=True, yaw=math.pi)
    cfg.disturbance = _LMF2_DIST()
    cfg.sensor_config.enable_lidar = True
    cfg.sensor_config.lidar_config = RSLidarAiryConfig()
    return _mass_props(cfg, 1.240, [0.0134, 0.0134, 0.0138])


def register_robots(robot_registry):
    robot_registry.register("base_quadrotor", base_quadrotor)
    robot_registry.register("base_quadrotor_with_camera", base_quadrotor_with_camera)
    robot_registry.register("base_quadrotor_with_lidar", base_quadrotor_with_lidar)
    robot_registry.register("base_quadrotor_with_faceid_normal_camera",
                            base_quadrotor_with_faceid_normal_camera)
    robot_registry.register("lmf2", lmf2)
    robot_registry.register("lmf2_radar", lmf2_radar)
    robot_registry.register("magpie", magpie)
