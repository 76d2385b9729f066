"""Robot config: init-state ranges, damping, disturbance, motor model and
allocation, the joint (DOF) config of the reconfigurable robots and the
sensors a robot carries.

Copied from the JAX package's ``config/robot_config/base_quad_config.py``.
Mass and inertia come from the robot URDF at build time unless overridden.
"""

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class MotorModelConfig:
    use_rps: bool = True
    motor_thrust_constant_min: float = 0.00000926312
    motor_thrust_constant_max: float = 0.00001826312
    motor_time_constant_increasing_min: float = 0.04
    motor_time_constant_increasing_max: float = 0.04
    motor_time_constant_decreasing_min: float = 0.04
    motor_time_constant_decreasing_max: float = 0.04
    max_thrust: float = 2.0
    min_thrust: float = 0.0
    max_thrust_rate: float = 100000.0
    thrust_to_torque_ratio: float = 0.01
    use_discrete_approximation: bool = True
    integration_scheme: str = "rk4"  # "euler" | "rk4"


@dataclass
class ControlAllocatorConfig:
    num_motors: int = 4
    force_application_level: str = "motor_link"  # or "root_link"
    application_mask: List[int] = field(default_factory=lambda: [5, 6, 7, 8])
    motor_directions: List[int] = field(default_factory=lambda: [1, -1, 1, -1])
    # 6 x num_motors wrench allocation: rows = [fx fy fz tx ty tz]
    allocation_matrix: List[List[float]] = field(
        default_factory=lambda: [
            [0.0, 0.0, 0.0, 0.0],
            [0.0, 0.0, 0.0, 0.0],
            [1.0, 1.0, 1.0, 1.0],
            [-0.13, -0.13, 0.13, 0.13],
            [-0.13, 0.13, 0.13, -0.13],
            [-0.01, 0.01, -0.01, 0.01],
        ]
    )
    motor_model_config: MotorModelConfig = field(default_factory=MotorModelConfig)


@dataclass
class DisturbanceConfig:
    enable_disturbance: bool = False
    prob_apply_disturbance: float = 0.02
    # [fx fy fz tx ty tz] uniform bounds
    max_force_and_torque_disturbance: List[float] = field(
        default_factory=lambda: [0.75, 0.75, 0.75, 0.004, 0.004, 0.004]
    )


@dataclass
class DampingConfig:
    """Aerodynamic drag coefficients along body axes."""
    linvel_linear_damping_coefficient: List[float] = field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    linvel_quadratic_damping_coefficient: List[float] = field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    angular_linear_damping_coefficient: List[float] = field(
        default_factory=lambda: [0.0, 0.0, 0.0])
    angular_quadratic_damping_coefficient: List[float] = field(
        default_factory=lambda: [0.0, 0.0, 0.0])


@dataclass
class InitConfig:
    """Reset sampling ranges, layout [ratio_x, ratio_y, ratio_z, roll, pitch,
    yaw, 1.0, vx, vy, vz, wx, wy, wz]; positions are ratios of the per-env
    bounds."""
    min_init_state: List[float] = field(
        default_factory=lambda: [0.1, 0.15, 0.15, 0.0, 0.0, -np.pi / 6, 1.0,
                                 -0.2, -0.2, -0.2, -0.2, -0.2, -0.2])
    max_init_state: List[float] = field(
        default_factory=lambda: [0.2, 0.85, 0.85, 0.0, 0.0, np.pi / 6, 1.0,
                                 0.2, 0.2, 0.2, 0.2, 0.2, 0.2])


@dataclass
class ReconfigurationConfig:
    """Joint (DOF) config of the reconfigurable robots (snakey, morphy)."""
    dof_mode: str = "position"           # "position" | "velocity" | "effort"
    arm_response: str = "pd"             # "pd" | "morphy"
    # rows: [position state, velocity state] per DOF
    init_state_min: List[List[float]] = field(default_factory=lambda: [[], []])
    init_state_max: List[List[float]] = field(default_factory=lambda: [[], []])
    stiffness: List[float] = field(default_factory=list)
    damping: List[float] = field(default_factory=list)
    # morphy's nonlinear arm spring and damper
    custom_nonlinear_stiffness: float = 0.0
    custom_linear_damping: float = 0.0
    # the decoupled joint path's parameters (robots without an articulation
    # URDF); a URDF's limits override lower/upper_limit and the clamps
    dof_inertia: List[float] = field(default_factory=list)   # default 1e-3 each
    lower_limit: List[float] = field(default_factory=list)   # default -pi
    upper_limit: List[float] = field(default_factory=list)   # default +pi
    max_velocity: float = 20.0
    max_effort: float = 50.0

    @property
    def num_dofs(self) -> int:
        return len(self.init_state_min[0])


@dataclass
class RobotAssetConfig:
    asset_folder: str = ""
    file: str = "quad.urdf"
    name: str = "base_quadrotor"
    base_link_name: str = "base_link"
    disable_gravity: bool = False
    fix_base_link: bool = False
    collision_mask: int = 0
    density: float = 0.000001
    angular_damping: float = 0.01   # engine-level per-body damping
    linear_damping: float = 0.01
    max_angular_velocity: float = 100.0
    max_linear_velocity: float = 100.0
    semantic_id: int = 0
    per_link_semantic: bool = False
    # overrides for mass properties; None => computed from the URDF
    mass: Optional[float] = None
    inertia: Optional[List[List[float]]] = None
    # joint armature added to the joint-space inertia's diagonal
    armature: float = 0.001
    # bounding-sphere contact radius; None => computed from the URDF
    collision_radius: Optional[float] = None


@dataclass
class SensorEnableConfig:
    enable_camera: bool = False
    camera_config: object = None
    enable_lidar: bool = False
    lidar_config: object = None
    enable_imu: bool = False
    imu_config: object = None


@dataclass
class RobotConfig:
    name: str = "base_quadrotor"
    robot_asset: RobotAssetConfig = field(default_factory=RobotAssetConfig)
    init_config: InitConfig = field(default_factory=InitConfig)
    sensor_config: SensorEnableConfig = field(default_factory=SensorEnableConfig)
    disturbance: DisturbanceConfig = field(default_factory=DisturbanceConfig)
    damping: DampingConfig = field(default_factory=DampingConfig)
    control_allocator_config: ControlAllocatorConfig = field(
        default_factory=ControlAllocatorConfig)
    # joint config of a reconfigurable robot (None for a rigid multirotor)
    dof_config: object = None
    # URDF text of the joint tree: the robot then steps on the coupled
    # articulated solver (sim/articulated.py), else on decoupled joints
    articulation_urdf: Optional[str] = None
