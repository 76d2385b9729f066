"""Parameter and state records of the port.

Counterpart of ``aerial_gym_simulator_tpu/sim/structs.py`` with the same
field names and shapes. Each record is a plain dataclass:

  * array leaves are torch tensors on the record's device,
  * 0-d leaves (dt, mass, thresholds, ranges) are Python floats, so the
    step can use them without reading the device,
  * static configuration (flags, counts, names) stays Python data.

``SimState.rng`` is a ``torch.Generator`` on the state's device; it takes
the place of the per-env JAX keys. Every env-batched draw from it goes
through ``utils/env_rng``, so a sharded state (each rank holding a block of
the env axis and the same generator) draws what the unsharded state draws
for its rows.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def replace(obj, **changes):
    """dataclasses.replace: a shallow copy with some fields swapped."""
    return dataclasses.replace(obj, **changes)


@dataclass
class MotorParams:
    allocation_matrix: Tensor            # (6, M)
    allocation_pinv: Tensor              # (M, 6)
    motor_directions: Tensor             # (M,)
    min_thrust: float
    max_thrust: float
    max_thrust_rate: float
    tau_inc_min: float
    tau_inc_max: float
    tau_dec_min: float
    tau_dec_max: float
    thrust_constant_min: float
    thrust_constant_max: float
    thrust_to_torque_ratio: float
    use_rps: bool = True
    use_discrete_approximation: bool = True
    integration_scheme: str = "rk4"
    num_motors: int = 4


@dataclass
class ControllerParams:
    K_pos_min: Tensor                    # (3,)
    K_pos_max: Tensor
    K_vel_min: Tensor
    K_vel_max: Tensor
    K_rot_min: Tensor
    K_rot_max: Tensor
    K_angvel_min: Tensor
    K_angvel_max: Tensor
    max_yaw_rate: float
    max_inclination_angle: float
    randomize_params: bool = False
    name: str = "lee_attitude_control"
    num_actions: int = 4


@dataclass
class RobotParams:
    mass: float
    inertia: Tensor                      # (3, 3)
    inv_inertia: Tensor                  # (3, 3)
    linear_damping: float
    angular_damping: float
    max_linear_velocity: float
    max_angular_velocity: float
    collision_radius: float
    drag_lin_linear: Tensor              # (3,)
    drag_lin_quadratic: Tensor
    drag_ang_linear: Tensor
    drag_ang_quadratic: Tensor
    min_init_state: Tensor               # (13,)
    max_init_state: Tensor
    disturbance_prob: float
    max_force_disturbance: Tensor        # (3,)
    max_torque_disturbance: Tensor       # (3,)
    enable_disturbance: bool = False
    force_application_level: str = "motor_link"
    disable_gravity: bool = False
    fix_base_link: bool = False


@dataclass
class DofParams:
    """Joint (DOF) dynamics of a reconfigurable robot: its drive (position,
    velocity or effort PD, or morphy's nonlinear arm spring), init ranges,
    limits and clamps. ``dof_inertia`` is the joint inertia of the decoupled
    path that robots without an articulation URDF take."""
    stiffness: Tensor                    # (D,) Kp
    damping: Tensor                      # (D,) Kd
    init_pos_min: Tensor                 # (D,)
    init_pos_max: Tensor
    init_vel_min: Tensor
    init_vel_max: Tensor
    dof_inertia: Tensor                  # (D,)
    lower_limit: Tensor                  # (D,)
    upper_limit: Tensor
    max_velocity: Tensor                 # (D,)
    max_effort: Tensor
    nonlinear_stiffness: float           # morphy's arm response
    linear_damping: float
    dof_mode: str = "position"
    arm_response: str = "pd"             # or "morphy"
    num_dofs: int = 0


@dataclass
class ArtParams:
    """Floating-base articulation built from the robot's URDF joint tree
    (assets/articulation.py); one moving body per revolute DOF, fixed
    subtrees merged, indices in URDF joint order. The tree structure stays
    Python data: the solver loops over it on the host."""
    R_tree: Tensor                       # (NB, 3, 3) child->parent at q=0
    t_tree: Tensor                       # (NB, 3) joint origin in the parent frame
    axis: Tensor                         # (NB, 3) joint axis, child frame
    mass: Tensor                         # (NB,)
    com: Tensor                          # (NB, 3) body frame
    inertia: Tensor                      # (NB, 3, 3) about the com, body frame
    base_mass: float
    base_com: Tensor                     # (3,)
    base_inertia: Tensor                 # (3, 3) about the base com
    motor_pos: Tensor                    # (M, 3) in the owning body's frame
    motor_dir: Tensor                    # (M, 3) thrust direction, body frame
    armature: float                      # added to H's joint diagonal
    parent: Tuple[int, ...] = ()         # per body; -1 = base
    motor_body: Tuple[int, ...] = ()     # per motor; -1 = base
    nb: int = 0


@dataclass
class ImuParams:
    """IMU noise model: white noise, bias random walk, bias re-init range,
    mount perturbation, measurement clamps."""
    accel_noise_std: Tensor              # (3,)
    gyro_noise_std: Tensor               # (3,)
    accel_bias_std: Tensor               # (3,) random-walk increment std
    gyro_bias_std: Tensor
    max_accel: float
    max_gyro: float
    accel_bias_init: Tensor              # (3,) bias reset uniform in +-this
    gyro_bias_init: Tensor               # (3,)
    min_mount_euler_rad: Tensor          # (3,)
    max_mount_euler_rad: Tensor          # (3,)
    world_frame: bool = False
    gravity_compensation: bool = False
    enable_noise: bool = True
    enable_bias: bool = True
    randomize_placement: bool = False


@dataclass
class EnvParams:
    lower_bound_min: Tensor              # (3,)
    lower_bound_max: Tensor
    upper_bound_min: Tensor
    upper_bound_max: Tensor
    collision_force_threshold: float
    reset_on_collision: bool = True
    create_ground_plane: bool = False
    substep_mean: int = 1
    substep_std: float = 0.0
    num_envs: int = 64
    num_env_actions: int = 0


@dataclass
class SceneParams:
    """Static obstacle scene as a primitive soup (envs/scene.py builds it).
    The env_prim_* tables are sorted by kind (box, cylinder, sphere,
    triangle) with n_box/n_cyl/n_sph/n_tri columns per kind."""
    prim_kind: Tensor                    # (V, P) int32, -1 pad
    prim_size: Tensor                    # (V, P, 3)
    prim_pos: Tensor                     # (V, P, 3)
    prim_rot: Tensor                     # (V, P, 3, 3)
    prim_semantic: Tensor                # (V, P) int32
    variant_radius: Tensor               # (V,)
    env_asset_variant: Tensor            # (N, A) int32
    min_state_ratio: Tensor              # (A, 13)
    max_state_ratio: Tensor              # (A, 13)
    keep_in_env: Tensor                  # (A,)
    semantic_id: Tensor                  # (A,) int32
    env_prim_slot: Tensor                # (N, P) int64 -> asset slot
    env_prim_kind: Tensor                # (N, P) int32
    env_prim_size: Tensor                # (N, P, 3)
    env_prim_pos: Tensor                 # (N, P, 3)
    env_prim_rot: Tensor                 # (N, P, 3, 3)
    env_prim_semantic: Tensor            # (N, P) int32
    cull_rank: Tensor                    # (N, A) int32
    num_assets: int = 0
    max_prims: int = 0
    num_env_prims: int = 0
    n_box: int = 0
    n_cyl: int = 0
    n_sph: int = 0
    n_tri: int = 0


@dataclass
class RaySensorParams:
    dirs: Tensor                         # (H, W, 3) unit dirs, sensor frame
    depth_multiplier: Tensor             # (H, W)
    data_frame_quat: Tensor              # (4,)
    max_range: float
    min_range: float
    far_out_value: float
    near_out_value: float
    min_translation: Tensor              # (3,)
    max_translation: Tensor
    min_rotation: Tensor                 # (3,) euler rad
    max_rotation: Tensor
    nominal_position: Tensor             # (3,)
    nominal_rotation: Tensor             # (3,)
    std_a: float
    std_b: float
    std_c: float
    mean_offset: float
    pixel_dropout_prob: float
    height: int = 0
    width: int = 0
    sensor_type: str = "camera"
    calculate_depth: bool = True
    return_pointcloud: bool = False
    pointcloud_in_world_frame: bool = False
    segmentation_camera: bool = True
    normalize_range: bool = True
    enable_noise: bool = False
    randomize_placement: bool = True
    stereo_baseline: float = 0.0
    num_sensors: int = 1


@dataclass
class SimParams:
    dt: float
    gravity: Tensor                      # (3,)
    robot: RobotParams
    motor: MotorParams
    controller: ControllerParams
    env: EnvParams
    dof: Optional[DofParams] = None
    art: Optional[ArtParams] = None
    scene: Optional[SceneParams] = None
    camera: Optional[RaySensorParams] = None
    lidar: Optional[RaySensorParams] = None
    imu: Optional[ImuParams] = None

    @property
    def device(self) -> torch.device:
        return self.gravity.device


@dataclass
class SimState:
    """Per-env dynamic state; every tensor has leading dim num_envs."""
    pos: Tensor                          # (N, 3)
    quat: Tensor                         # (N, 4)
    linvel: Tensor                       # (N, 3)
    angvel: Tensor                       # (N, 3)
    motor_thrust: Tensor                 # (N, M)
    motor_tau_inc: Tensor                # (N, M)
    motor_tau_dec: Tensor                # (N, M)
    motor_thrust_constant: Tensor        # (N, M)
    K_pos: Tensor                        # (N, 3)
    K_vel: Tensor
    K_rot: Tensor
    K_angvel: Tensor
    bounds_lo: Tensor                    # (N, 3)
    bounds_hi: Tensor                    # (N, 3)
    collisions: Tensor                   # (N,)
    crashes: Tensor                      # (N,)
    truncations: Tensor                  # (N,)
    sim_steps: Tensor                    # (N,) int32
    rng: torch.Generator                 # on the state's device; replicated across shards
    applied_force_b: Tensor              # (N, 3)
    applied_torque_b: Tensor             # (N, 3)
    obstacle_pos: Tensor                 # (N, A, 3)
    obstacle_quat: Tensor                # (N, A, 4)
    obstacle_linvel: Tensor              # (N, A, 3)
    obstacle_angvel: Tensor              # (N, A, 3)
    cam_mount_pos: Tensor                # (N, 3), or (N, S, 3) for S > 1 sensors
    cam_mount_quat: Tensor               # (N, 4), or (N, S, 4)
    lidar_mount_pos: Tensor              # (N, 3), or (N, S, 3)
    lidar_mount_quat: Tensor             # (N, 4), or (N, S, 4)
    imu_accel_bias: Tensor               # (N, 3)
    imu_gyro_bias: Tensor                # (N, 3)
    imu_mount_quat: Tensor               # (N, 4)
    num_obstacles: Tensor                # (N,) int32
    dof_pos: Tensor                      # (N, D); D = 0 for a rigid robot
    dof_vel: Tensor
    dof_pos_target: Tensor
    dof_vel_target: Tensor

    @property
    def num_envs(self) -> int:
        return self.pos.shape[0]

    @property
    def device(self) -> torch.device:
        return self.pos.device
