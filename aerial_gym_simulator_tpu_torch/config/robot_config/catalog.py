"""Robot catalog entries of the slices, copied from the JAX package's
``config/robot_config/catalog.py``."""

from __future__ import annotations

import math

from .base_quad_config import (
    ControlAllocatorConfig,
    DampingConfig,
    DisturbanceConfig,
    InitConfig,
    MotorModelConfig,
    ReconfigurationConfig,
    RobotAssetConfig,
    RobotConfig,
)


def base_quadrotor() -> RobotConfig:
    return RobotConfig(name="base_quadrotor")


def base_quadrotor_with_imu() -> RobotConfig:
    cfg = RobotConfig(name="base_quadrotor_with_imu")
    cfg.sensor_config.enable_imu = True
    return cfg


def base_quadrotor_with_camera() -> RobotConfig:
    cfg = RobotConfig(name="base_quadrotor_with_camera")
    cfg.sensor_config.enable_camera = True
    return cfg


def base_quadrotor_with_camera_imu() -> RobotConfig:
    cfg = RobotConfig(name="base_quadrotor_with_camera_imu")
    cfg.sensor_config.enable_camera = True
    cfg.sensor_config.enable_imu = True
    return cfg


def base_quadrotor_with_lidar() -> RobotConfig:
    cfg = RobotConfig(name="base_quadrotor_with_lidar")
    cfg.sensor_config.enable_lidar = True
    return cfg


def base_quadrotor_with_stereo_camera() -> RobotConfig:
    from ..sensor_config.sensor_configs import StereoCameraConfig
    cfg = RobotConfig(name="base_quadrotor_with_stereo_camera")
    cfg.sensor_config.enable_camera = True
    cfg.sensor_config.camera_config = StereoCameraConfig()
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
_AGGRESSIVE_DIST = lambda: DisturbanceConfig(
    enable_disturbance=True, prob_apply_disturbance=0.05,
    max_force_and_torque_disturbance=[1.5, 1.5, 1.5, 0.25, 0.25, 0.25])
_NO_DIST = lambda: DisturbanceConfig(
    enable_disturbance=False, prob_apply_disturbance=0.0,
    max_force_and_torque_disturbance=[0.0] * 6)


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


_FULLBOX_INIT = lambda: _init([0.0, 0.0, 0.0], [1.0, 1.0, 1.0])


def base_quadrotor_root_link_control() -> RobotConfig:
    """The base quad with its wrench applied at the root link and a fixed
    thrust constant."""
    cfg = RobotConfig(name="base_quad_root_link_control")
    cfg.control_allocator_config.force_application_level = "root_link"
    cfg.control_allocator_config.motor_model_config = _motors(
        kt_min=1.826312e-05, kt_max=1.826312e-05, tau_inc=(0.01, 0.03),
        tau_dec=(0.005, 0.005), max_thrust=10.0)
    return cfg


# 8 motors on the corners of a cube, shared by base_octarotor and base_rov:
# a full-rank 6x8 allocation (fully actuated)
_CUBE_ALLOCATION = [
    [-0.78867513, 0.21132487, -0.21132487, 0.78867513,
     0.78867513, -0.21132487, 0.21132487, -0.78867513],
    [0.21132487, 0.78867513, -0.78867513, -0.21132487,
     -0.21132487, -0.78867513, 0.78867513, 0.21132487],
    [0.57735027, -0.57735027, -0.57735027, 0.57735027,
     0.57735027, -0.57735027, -0.57735027, 0.57735027],
    [0.14226497, -0.21547005, 0.25773503, 0.01547005,
     -0.01547005, -0.25773503, 0.21547005, -0.14226497],
    [-0.25773503, 0.01547005, 0.14226497, 0.21547005,
     -0.21547005, -0.14226497, -0.01547005, 0.25773503],
    [0.11547005, -0.23094010, -0.11547005, 0.23094010,
     -0.23094010, 0.11547005, 0.23094010, -0.11547005],
]


def _reversible_motors(max_thrust: float) -> MotorModelConfig:
    """Thrust in [-max, max], commanded as thrust (use_rps=False)."""
    return _motors(use_rps=False, tau_inc=(0.01, 0.03), tau_dec=(0.005, 0.005),
                   max_thrust=max_thrust, min_thrust=-max_thrust)


def _cube_allocator() -> ControlAllocatorConfig:
    return ControlAllocatorConfig(
        num_motors=8,
        application_mask=[9, 10, 11, 12, 13, 14, 15, 16],
        motor_directions=[1, -1, 1, -1, 1, -1, 1, -1],
        allocation_matrix=[row[:] for row in _CUBE_ALLOCATION],
        motor_model_config=_reversible_motors(6.25),
    )


def base_octarotor() -> RobotConfig:
    """8 reversible-thrust motors in the cube arrangement (fully actuated)."""
    cfg = RobotConfig(name="base_octarotor", control_allocator_config=_cube_allocator(),
                      init_config=_FULLBOX_INIT(), disturbance=_AGGRESSIVE_DIST())
    return _mass_props(cfg, 1.1, [0.096, 0.096, 0.096])


def base_rov() -> RobotConfig:
    """A fully actuated underwater ROV on the cube allocation. The shipped
    hydrodynamic damping coefficients are zero, and gravity stays on: the
    controller's gravity compensation plays the buoyancy's part. The asset
    names ``rov.urdf`` with no folder, so the URDF is built from the
    allocation geometry as for every robot without a file on disk."""
    cfg = RobotConfig(name="base_rov", control_allocator_config=_cube_allocator(),
                      damping=DampingConfig(),
                      robot_asset=RobotAssetConfig(name="base_rov", file="rov.urdf"),
                      init_config=_FULLBOX_INIT(), disturbance=_AGGRESSIVE_DIST())
    return _mass_props(cfg, 1.1, [0.096, 0.096, 0.096])


def base_random() -> RobotConfig:
    """8 reversible motors on a randomized, non-planar, full-rank allocation."""
    alloc = [
        [5.55111512e-17, -0.321393805, -0.454519478, -0.342020143,
         0.96984631, 0.342020143, 0.866025404, -0.754406507],
        [1.0, -0.342020143, -0.707106781, 0.0,
         -0.173648178, 0.939692621, 0.5, -0.173648178],
        [1.66533454e-16, -0.883022222, 0.54167522, 0.939692621,
         0.171010072, 1.11022302e-16, 1.11022302e-16, 0.633022222],
        [0.175, 0.123788742, -0.0569783368, 0.134977168,
         0.0336959042, -0.266534135, -0.078839746, -0.0206893989],
        [0.01, 0.278845133, -0.0432852308, -0.272061766,
         -0.197793856, 0.0863687139, 0.156554446, -0.17126129],
        [0.282487373, -0.14173549, -0.0858541103, 0.0384858939,
         -0.333468026, 0.0836741468, 0.00846777988, -0.0874336259],
    ]
    ca = ControlAllocatorConfig(
        num_motors=8,
        application_mask=[9, 10, 11, 12, 13, 14, 15, 16],
        motor_directions=[-1, 1, -1, 1, -1, 1, -1, 1],
        allocation_matrix=alloc,
        motor_model_config=_reversible_motors(5.0),
    )
    cfg = RobotConfig(name="base_random", control_allocator_config=ca,
                      init_config=_FULLBOX_INIT(), disturbance=_AGGRESSIVE_DIST())
    return _mass_props(cfg, 0.25, [0.00285, 0.00359, 0.00348])


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


def lmf1() -> RobotConfig:
    """A 1.235 kg quad with the continuous motor model."""
    cfg = _quad("lmf1",
                [-0.13, 0.13, 0.13, -0.13], [-0.13, 0.13, -0.13, 0.13],
                [-0.05, 0.05, -0.05, 0.05], [1, 1, -1, -1],
                _motors(kt_min=5.487e-6, kt_max=5.487e-6,
                        tau_inc=(0.025, 0.025), tau_dec=(0.025, 0.025),
                        max_thrust=20.0, cq=0.05, discrete=False),
                application_mask=[4, 1, 3, 2])
    cfg.init_config = _init([0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                            rp=math.pi / 6.0, v=0.5, w=0.2)
    cfg.disturbance = _NO_DIST()
    return _mass_props(cfg, 1.235, [0.0134, 0.0134, 0.0138])


def x500() -> RobotConfig:
    """The PX4 x500 frame, 1.656 kg, with the continuous motor model."""
    cfg = _quad("x500",
                [-0.13, 0.13, 0.13, -0.13], [-0.13, 0.13, -0.13, 0.13],
                [-0.025, 0.025, -0.025, 0.025], [1, 1, -1, -1],
                _motors(kt_min=8.54858e-6, kt_max=8.54858e-6,
                        tau_inc=(0.0125, 0.0125), tau_dec=(0.025, 0.025),
                        max_thrust=20.0, cq=0.025, discrete=False),
                application_mask=[4, 1, 3, 2])
    cfg.init_config = _init([0.0, 0.0, 0.0], [1.0, 1.0, 1.0],
                            rp=math.pi / 6.0, v=0.5, w=0.2)
    cfg.disturbance = _NO_DIST()
    return _mass_props(cfg, 1.656, [0.02165, 0.02165, 0.02941])


def tinyprop() -> RobotConfig:
    """A 0.373 kg quad, motor thrust in [0.2, 1.2] N, no disturbance."""
    cfg = _quad("tinyprop",
                [-0.16, -0.16, 0.16, 0.16], [-0.16, 0.16, 0.16, -0.16],
                [-0.01, 0.01, -0.01, 0.01], [1, -1, 1, -1],
                _motors(kt_min=1.286412e-5, kt_max=1.286412e-5,
                        tau_inc=(0.047, 0.047), tau_dec=(0.047, 0.047),
                        max_thrust=1.2, min_thrust=0.2))
    cfg.init_config = _init([-0.7, -0.7, -0.7], [0.7, 0.7, 0.7],
                            rp=math.pi / 6.0, v=0.5, w=0.5)
    cfg.disturbance = DisturbanceConfig(
        enable_disturbance=False, prob_apply_disturbance=0.02,
        max_force_and_torque_disturbance=[0.001, 0.001, 0.001,
                                          4e-05, 4e-05, 4e-05])
    return _mass_props(cfg, 0.373, [0.00293, 0.00293, 0.00426])


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


# ---------------------------------------------------------------------------
# reconfigurable robots: joints, each with an articulation URDF
# ---------------------------------------------------------------------------


def _snakey_dofs(num_segments: int) -> ReconfigurationConfig:
    """Two DOFs (a yaw bend and a pitch bend) per inter-segment joint,
    velocity drives."""
    d = 2 * num_segments
    return ReconfigurationConfig(
        dof_mode="velocity",
        init_state_min=[[-math.pi / 2.0, -0.3] * num_segments, [-0.1] * d],
        init_state_max=[[math.pi / 2.0, 0.3] * num_segments, [0.1] * d],
        stiffness=[0.0] * d,
        damping=[10.0] * d,
        dof_inertia=[1e-3] * d,
        lower_limit=[-math.pi / 2.0, -0.5] * num_segments,
        upper_limit=[math.pi / 2.0, 0.5] * num_segments,
    )


def snakey() -> RobotConfig:
    """A 4-motor articulated serpent: 3 joint pairs (6 DOFs), velocity drives."""
    from .reconfigurable_urdf import snakey_urdf
    cfg = _quad("snakey",
                [-0.13, -0.13, 0.13, 0.13], [-0.13, 0.13, 0.13, -0.13],
                [0.01, -0.01, 0.01, -0.01], [-1, 1, -1, 1],
                _motors(use_rps=False, tau_inc=(0.005, 0.005),
                        tau_dec=(0.005, 0.005), max_thrust=15.0),
                application_mask=[14, 13, 12, 11])
    cfg.dof_config = _snakey_dofs(3)
    cfg.disturbance.enable_disturbance = True
    cfg.init_config = _FULLBOX_INIT()
    cfg.articulation_urdf = snakey_urdf(4)
    return _mass_props(cfg, 1.225, [0.00169, 1.533, 1.533])


def _snakey_n(name: str, num_motors: int) -> RobotConfig:
    """snakey5 / snakey6: one z-thrust motor per segment. The allocation is
    the source's all-ones placeholder: the thrusts act on the motor links."""
    from .reconfigurable_urdf import snakey_urdf
    ca = ControlAllocatorConfig(
        num_motors=num_motors,
        application_mask=list(range(14, 14 + num_motors))[::-1],
        motor_directions=[(-1) ** (i + 1) for i in range(num_motors)],
        allocation_matrix=[[1.0] * num_motors for _ in range(6)],
        motor_model_config=_motors(use_rps=False, tau_inc=(0.005, 0.005),
                                   tau_dec=(0.005, 0.005), max_thrust=15.0),
    )
    cfg = RobotConfig(name=name, control_allocator_config=ca, init_config=_FULLBOX_INIT())
    cfg.dof_config = _snakey_dofs(num_motors - 1)
    cfg.disturbance.enable_disturbance = True
    cfg.articulation_urdf = snakey_urdf(num_motors)
    mass = {5: (1.531, [0.00211, 3.065, 3.065]),
            6: (1.8375, [0.00253, 5.362, 5.362])}[num_motors]
    return _mass_props(cfg, mass[0], mass[1])


def snakey5() -> RobotConfig:
    return _snakey_n("snakey5", 5)


def snakey6() -> RobotConfig:
    return _snakey_n("snakey6", 6)


def _morphy_base(name: str, directions=(-1, 1, -1, 1)) -> RobotConfig:
    # yaw moment row: -0.01 * direction
    tz = [-0.01 * d for d in directions]
    cfg = _quad(name,
                [-0.0785, -0.0785, 0.0785, 0.0785],
                [-0.0785, 0.0785, 0.0785, -0.0785],
                tz, list(directions),
                _motors(use_rps=False, tau_inc=(0.01, 0.03),
                        tau_dec=(0.005, 0.005), max_thrust=2.0),
                application_mask=[3, 6, 9, 12])
    cfg.init_config = _init([0.0, 0.0, 0.0], [1.0, 1.0, 1.0], yaw=math.pi / 6.0)
    return _mass_props(cfg, 0.29, [0.00074, 0.00077, 0.00059])


def morphy() -> RobotConfig:
    """A quadrotor with 4 passive flexible arms (2 DOFs each) and a
    nonlinear spring-damper arm response."""
    from .reconfigurable_urdf import morphy_urdf
    cfg = _morphy_base("morphy")
    cfg.dof_config = ReconfigurationConfig(
        dof_mode="effort",
        arm_response="morphy",
        init_state_min=[[-0.1] * 8, [-0.05] * 8],
        init_state_max=[[0.1] * 8, [0.05] * 8],
        stiffness=[0.2, 1.0] * 4,
        damping=[0.025, 0.02] * 4,
        custom_nonlinear_stiffness=-5834.0,
        custom_linear_damping=-230.0,
        # the 16.25 g arm mass at 7 cm
        dof_inertia=[0.01625 * 0.07 * 0.07] * 8,
        lower_limit=[-math.pi / 4] * 8,
        upper_limit=[math.pi / 4] * 8,
    )
    cfg.disturbance.enable_disturbance = False
    cfg.articulation_urdf = morphy_urdf()
    return cfg


def morphy_stiff() -> RobotConfig:
    """morphy with rigid arms, flipped motor directions and the disturbance on."""
    cfg = _morphy_base("morphy_stiff", directions=(1, -1, 1, -1))
    cfg.disturbance.enable_disturbance = True
    return cfg


def morphy_fixed_base() -> RobotConfig:
    """morphy with its root clamped and the arms started at 0.29 rad: the
    arm system-identification rig."""
    cfg = morphy()
    cfg.name = "morphy_fixed_base"
    cfg.robot_asset.fix_base_link = True
    pinned = [0.29, 0.0] * 4
    cfg.dof_config.init_state_min = [list(pinned), [0.0] * 8]
    cfg.dof_config.init_state_max = [list(pinned), [0.0] * 8]
    return cfg


def register_robots(robot_registry):
    robot_registry.register("base_quadrotor", base_quadrotor)
    robot_registry.register("base_quadrotor_with_imu", base_quadrotor_with_imu)
    robot_registry.register("base_quadrotor_with_camera", base_quadrotor_with_camera)
    robot_registry.register("base_quadrotor_with_camera_imu", base_quadrotor_with_camera_imu)
    robot_registry.register("base_quadrotor_with_lidar", base_quadrotor_with_lidar)
    robot_registry.register("base_quadrotor_with_stereo_camera",
                            base_quadrotor_with_stereo_camera)
    robot_registry.register("base_quadrotor_with_faceid_normal_camera",
                            base_quadrotor_with_faceid_normal_camera)
    robot_registry.register("base_quad_root_link_control", base_quadrotor_root_link_control)
    robot_registry.register("base_octarotor", base_octarotor)
    robot_registry.register("base_rov", base_rov)
    robot_registry.register("base_random", base_random)
    robot_registry.register("lmf1", lmf1)
    robot_registry.register("lmf2", lmf2)
    robot_registry.register("lmf2_radar", lmf2_radar)
    robot_registry.register("x500", x500)
    robot_registry.register("tinyprop", tinyprop)
    robot_registry.register("magpie", magpie)
    robot_registry.register("snakey", snakey)
    robot_registry.register("snakey5", snakey5)
    robot_registry.register("snakey6", snakey6)
    robot_registry.register("morphy", morphy)
    robot_registry.register("morphy_stiff", morphy_stiff)
    robot_registry.register("morphy_fixed_base", morphy_fixed_base)
