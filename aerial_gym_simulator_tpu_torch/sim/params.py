"""Build SimParams / the initial SimState from the config tree: rigid
multirotors, and the reconfigurable robots' joints and articulation.
Counterpart of ``aerial_gym_simulator_tpu/sim/params.py``."""

from __future__ import annotations

import logging
import os
from typing import Optional

import numpy as np
import torch

from ..assets import procedural, urdf
from .structs import (
    ArtParams,
    ControllerParams,
    DofParams,
    EnvParams,
    MotorParams,
    RobotParams,
    SceneParams,
    SimParams,
    SimState,
)

logger = logging.getLogger(__name__)


def f32(x) -> float:
    """A 0-d parameter as a Python float holding the f32-rounded value."""
    return float(np.float32(x))


def tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def resolve_robot_model(robot_cfg) -> urdf.UrdfModel:
    """Load the robot URDF (from disk if configured, else procedural)."""
    asset = robot_cfg.robot_asset
    path = os.path.join(asset.asset_folder, asset.file) if asset.asset_folder else ""
    if path and os.path.exists(path):
        return urdf.load_urdf(path, semantic_id=asset.semantic_id,
                              per_link_semantic=asset.per_link_semantic)
    alloc = robot_cfg.control_allocator_config.allocation_matrix
    positions = procedural.motor_layout_from_allocation(alloc)
    text = procedural.multirotor_urdf(name=robot_cfg.name, motor_positions=positions)
    return urdf.load_urdf_string(text, name=robot_cfg.name)


def build_motor_params(robot_cfg, device) -> MotorParams:
    ca = robot_cfg.control_allocator_config
    mm = ca.motor_model_config
    alloc = np.asarray(ca.allocation_matrix, dtype=np.float32)
    rank = np.linalg.matrix_rank(alloc)
    if rank < 6:
        logger.warning("allocation matrix is not full rank (rank=%d)", rank)
    return MotorParams(
        allocation_matrix=tensor(alloc, device),
        allocation_pinv=tensor(np.linalg.pinv(alloc), device),
        motor_directions=tensor(ca.motor_directions, device),
        min_thrust=f32(mm.min_thrust),
        max_thrust=f32(mm.max_thrust),
        max_thrust_rate=f32(mm.max_thrust_rate),
        tau_inc_min=f32(mm.motor_time_constant_increasing_min),
        tau_inc_max=f32(mm.motor_time_constant_increasing_max),
        tau_dec_min=f32(mm.motor_time_constant_decreasing_min),
        tau_dec_max=f32(mm.motor_time_constant_decreasing_max),
        thrust_constant_min=f32(mm.motor_thrust_constant_min),
        thrust_constant_max=f32(mm.motor_thrust_constant_max),
        thrust_to_torque_ratio=f32(mm.thrust_to_torque_ratio),
        use_rps=mm.use_rps,
        use_discrete_approximation=mm.use_discrete_approximation,
        integration_scheme=mm.integration_scheme,
        num_motors=ca.num_motors,
    )


def build_robot_params(robot_cfg, device) -> RobotParams:
    model = resolve_robot_model(robot_cfg)
    asset = robot_cfg.robot_asset
    mass = asset.mass if asset.mass is not None else model.mass
    inertia = (np.asarray(asset.inertia, dtype=np.float64)
               if asset.inertia is not None else model.inertia)
    radius = (asset.collision_radius if asset.collision_radius is not None
              else model.bound_radius)
    damping = robot_cfg.damping
    dist = robot_cfg.disturbance
    return RobotParams(
        mass=f32(mass),
        inertia=tensor(inertia, device),
        inv_inertia=tensor(np.linalg.inv(inertia), device),
        linear_damping=f32(asset.linear_damping),
        angular_damping=f32(asset.angular_damping),
        max_linear_velocity=f32(asset.max_linear_velocity),
        max_angular_velocity=f32(asset.max_angular_velocity),
        collision_radius=f32(radius),
        drag_lin_linear=tensor(damping.linvel_linear_damping_coefficient, device),
        drag_lin_quadratic=tensor(damping.linvel_quadratic_damping_coefficient, device),
        drag_ang_linear=tensor(damping.angular_linear_damping_coefficient, device),
        drag_ang_quadratic=tensor(damping.angular_quadratic_damping_coefficient, device),
        min_init_state=tensor(robot_cfg.init_config.min_init_state, device),
        max_init_state=tensor(robot_cfg.init_config.max_init_state, device),
        disturbance_prob=f32(dist.prob_apply_disturbance),
        max_force_disturbance=tensor(dist.max_force_and_torque_disturbance[0:3], device),
        max_torque_disturbance=tensor(dist.max_force_and_torque_disturbance[3:6], device),
        enable_disturbance=dist.enable_disturbance,
        force_application_level=robot_cfg.control_allocator_config.force_application_level,
        disable_gravity=asset.disable_gravity,
        fix_base_link=asset.fix_base_link,
    )


def build_controller_params(ctrl_cfg, device) -> ControllerParams:
    t = lambda x: tensor(x, device)
    return ControllerParams(
        K_pos_min=t(ctrl_cfg.K_pos_tensor_min),
        K_pos_max=t(ctrl_cfg.K_pos_tensor_max),
        K_vel_min=t(ctrl_cfg.K_vel_tensor_min),
        K_vel_max=t(ctrl_cfg.K_vel_tensor_max),
        K_rot_min=t(ctrl_cfg.K_rot_tensor_min),
        K_rot_max=t(ctrl_cfg.K_rot_tensor_max),
        K_angvel_min=t(ctrl_cfg.K_angvel_tensor_min),
        K_angvel_max=t(ctrl_cfg.K_angvel_tensor_max),
        max_yaw_rate=f32(ctrl_cfg.max_yaw_rate),
        max_inclination_angle=f32(ctrl_cfg.max_inclination_angle_rad),
        randomize_params=ctrl_cfg.randomize_params,
        name=(ctrl_cfg.base_controller or ctrl_cfg.name),
        num_actions=ctrl_cfg.num_actions,
    )


def build_art_params(robot_cfg, device) -> Optional[ArtParams]:
    """ArtParams from the robot's articulation URDF; None for a rigid robot
    or one without a URDF (its joints, if any, take the decoupled path)."""
    text = getattr(robot_cfg, "articulation_urdf", None)
    if not text:
        return None
    from ..assets.articulation import parse_articulation
    model = parse_articulation(text)
    if model is None:
        return None
    rc = robot_cfg.dof_config
    if rc is not None and rc.num_dofs != model.nb:
        raise ValueError(
            f"articulation URDF has {model.nb} revolute joints but "
            f"dof_config declares {rc.num_dofs} DOFs ({robot_cfg.name})")
    asset = robot_cfg.robot_asset
    if asset.mass is not None and abs(model.total_mass - asset.mass) > 1e-3:
        logger.warning("%s: articulation total mass %.4f != configured %s (the "
                       "articulated path uses the URDF)", robot_cfg.name,
                       model.total_mass, asset.mass)
    M = robot_cfg.control_allocator_config.num_motors
    if len(model.motor_body) != M:
        raise ValueError(
            f"articulation URDF has {len(model.motor_body)} motor links, "
            f"config expects {M} ({robot_cfg.name})")
    t = lambda x: tensor(x, device)
    return ArtParams(
        R_tree=t(model.R_tree), t_tree=t(model.t_tree), axis=t(model.axis),
        mass=t(model.mass), com=t(model.com), inertia=t(model.inertia),
        base_mass=f32(model.base_mass), base_com=t(model.base_com),
        base_inertia=t(model.base_inertia),
        motor_pos=t(model.motor_pos), motor_dir=t(model.motor_dir),
        armature=f32(getattr(asset, "armature", 0.001)),
        parent=tuple(model.parent), motor_body=tuple(model.motor_body), nb=model.nb,
    )


def build_dof_params(robot_cfg, device) -> Optional[DofParams]:
    """DofParams from the robot's ReconfigurationConfig (None when rigid).
    A robot with an articulation URDF takes its joint limits and its
    effort and velocity clamps from the URDF, over the config's."""
    rc = robot_cfg.dof_config
    if rc is None or rc.num_dofs == 0:
        return None
    D = rc.num_dofs
    inertia = rc.dof_inertia if rc.dof_inertia else [1e-3] * D
    lower = rc.lower_limit if rc.lower_limit else [-np.pi] * D
    upper = rc.upper_limit if rc.upper_limit else [np.pi] * D
    max_velocity = [rc.max_velocity] * D
    max_effort = [rc.max_effort] * D
    text = getattr(robot_cfg, "articulation_urdf", None)
    if text:
        from ..assets.articulation import parse_articulation
        model = parse_articulation(text)
        if model is not None and model.nb == D:
            lower, upper = model.lower, model.upper
            max_effort, max_velocity = model.effort, model.velocity
    t = lambda x: tensor(x, device)
    return DofParams(
        stiffness=t(rc.stiffness), damping=t(rc.damping),
        init_pos_min=t(rc.init_state_min[0]), init_pos_max=t(rc.init_state_max[0]),
        init_vel_min=t(rc.init_state_min[1]), init_vel_max=t(rc.init_state_max[1]),
        dof_inertia=t(inertia), lower_limit=t(lower), upper_limit=t(upper),
        max_velocity=t(max_velocity), max_effort=t(max_effort),
        nonlinear_stiffness=f32(rc.custom_nonlinear_stiffness),
        linear_damping=f32(rc.custom_linear_damping),
        dof_mode=rc.dof_mode, arm_response=rc.arm_response, num_dofs=D,
    )


def build_env_params(env_cfg, device, num_envs: Optional[int] = None) -> EnvParams:
    t = lambda x: tensor(x, device)
    return EnvParams(
        lower_bound_min=t(env_cfg.lower_bound_min),
        lower_bound_max=t(env_cfg.lower_bound_max),
        upper_bound_min=t(env_cfg.upper_bound_min),
        upper_bound_max=t(env_cfg.upper_bound_max),
        collision_force_threshold=f32(env_cfg.collision_force_threshold),
        reset_on_collision=env_cfg.reset_on_collision,
        create_ground_plane=env_cfg.create_ground_plane,
        substep_mean=int(env_cfg.num_physics_steps_per_env_step_mean),
        substep_std=float(env_cfg.num_physics_steps_per_env_step_std),
        num_envs=int(num_envs if num_envs is not None else env_cfg.num_envs),
        num_env_actions=env_cfg.num_env_actions,
    )


def build_sim_params(sim_cfg, env_cfg, robot_cfg, ctrl_cfg, device,
                     num_envs: Optional[int] = None,
                     scene: Optional[SceneParams] = None) -> SimParams:
    from ..config.sensor_config.sensor_configs import (
        BaseDepthCameraConfig, BaseImuConfig, BaseLidarConfig)
    from ..sensors.imu import build_imu_params
    from ..sensors.raycast_sensor import build_ray_sensor_params

    def ray_sensor(enabled, cfg, default):
        if not enabled:
            return None
        cfg = cfg or default
        return build_ray_sensor_params(cfg() if isinstance(cfg, type) else cfg, device)

    sens = robot_cfg.sensor_config
    camera = ray_sensor(sens.enable_camera, sens.camera_config, BaseDepthCameraConfig)
    lidar = ray_sensor(sens.enable_lidar, sens.lidar_config, BaseLidarConfig)
    imu = None
    if sens.enable_imu:
        imu_cfg = sens.imu_config or BaseImuConfig
        imu = build_imu_params(imu_cfg() if isinstance(imu_cfg, type) else imu_cfg, device)
    return SimParams(
        dt=f32(sim_cfg.dt),
        gravity=tensor(sim_cfg.gravity, device),
        robot=build_robot_params(robot_cfg, device),
        motor=build_motor_params(robot_cfg, device),
        controller=build_controller_params(ctrl_cfg, device),
        env=build_env_params(env_cfg, device, num_envs),
        dof=build_dof_params(robot_cfg, device),
        art=build_art_params(robot_cfg, device),
        scene=scene,
        camera=camera,
        lidar=lidar,
        imu=imu,
    )


def initial_state(params: SimParams, seed: int = 0) -> SimState:
    """Allocate the full per-env state (pre-reset zeros + a seeded
    generator on the params' device)."""
    dev = params.device
    N = params.env.num_envs
    M = params.motor.num_motors
    A = params.scene.num_assets if params.scene is not None else 0
    D = params.dof.num_dofs if params.dof is not None else 0
    z = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
    unit_q = torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev)
    quat0 = lambda *lead: unit_q.expand(*lead, 4).clone()
    cp, mp = params.controller, params.motor
    mid = lambda lo, hi: ((lo + hi) / 2.0).expand(N, 3).clone()
    # a sensor's mount buffers: (N, .), or (N, S, .) for S > 1 copies
    mount = lambda sp: (N,) if sp is None or sp.num_sensors == 1 else (N, sp.num_sensors)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return SimState(
        pos=z(N, 3), quat=quat0(N), linvel=z(N, 3), angvel=z(N, 3),
        motor_thrust=z(N, M),
        motor_tau_inc=torch.full((N, M), mp.tau_inc_min, device=dev),
        motor_tau_dec=torch.full((N, M), mp.tau_dec_min, device=dev),
        motor_thrust_constant=torch.full(
            (N, M), f32((mp.thrust_constant_min + mp.thrust_constant_max) / 2.0),
            device=dev),
        K_pos=mid(cp.K_pos_min, cp.K_pos_max),
        K_vel=mid(cp.K_vel_min, cp.K_vel_max),
        K_rot=mid(cp.K_rot_min, cp.K_rot_max),
        K_angvel=mid(cp.K_angvel_min, cp.K_angvel_max),
        bounds_lo=params.env.lower_bound_min.expand(N, 3).clone(),
        bounds_hi=params.env.upper_bound_min.expand(N, 3).clone(),
        collisions=z(N), crashes=z(N), truncations=z(N),
        sim_steps=torch.zeros((N,), dtype=torch.int32, device=dev),
        rng=gen,
        applied_force_b=z(N, 3), applied_torque_b=z(N, 3),
        obstacle_pos=z(N, A, 3),
        obstacle_quat=quat0(N, A),
        obstacle_linvel=z(N, A, 3),
        obstacle_angvel=z(N, A, 3),
        cam_mount_pos=z(*mount(params.camera), 3), cam_mount_quat=quat0(*mount(params.camera)),
        lidar_mount_pos=z(*mount(params.lidar), 3), lidar_mount_quat=quat0(*mount(params.lidar)),
        imu_accel_bias=z(N, 3), imu_gyro_bias=z(N, 3), imu_mount_quat=quat0(N),
        num_obstacles=torch.full((N,), A, dtype=torch.int32, device=dev),
        dof_pos=z(N, D), dof_vel=z(N, D), dof_pos_target=z(N, D), dof_vel_target=z(N, D),
    )
