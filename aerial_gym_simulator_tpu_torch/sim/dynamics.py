"""Simulation core: substep physics, env step, masked reset.

Counterpart of ``aerial_gym_simulator_tpu/sim/dynamics.py``. Functions take
a state and return a new one (``replace`` shallow-copies the record);
nothing reads a device value back to the host. The step and the reset are
the spans ``physics`` (each substep's ``physics.control``,
``physics.integrate`` and ``physics.contact`` inside it, recorded where the
step runs eagerly) and ``reset`` (``utils/profiling.span``).

``env_step`` replays the step from a CUDA graph where its state is on CUDA
and no input needs a gradient (``sim/step_graph.py``), and runs
``env_step_eager`` otherwise; ``STEP_GRAPHS`` counts which it ran.

Frames: root state is world-frame (pos, xyzw quat, linvel, angvel);
applied forces/torques are body-frame. A rigid robot's motor thrusts map
to a body wrench through the allocation matrix; a robot with an
articulation URDF steps on the coupled solver (sim/articulated.py), its
thrusts applied on their own links; joints without a URDF take the
decoupled path (``integrate_dofs``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..control.controllers import Gains, compute_robot_obs, controller_update
from ..ops.motor_model import motor_step
from ..utils.env_rng import env_rand
from ..utils.math import (
    cross,
    interpolate_ratio,
    quat_from_euler_xyz_tensor,
    quat_integrate,
    quat_rotate,
    quat_rotate_inverse,
    rowwise_matmul,
    safe_norm,
)
from ..utils.profiling import span, spanned
from .step_graph import COUNTS as STEP_GRAPHS
from .step_graph import GRAPHS
from .structs import SimParams, SimState, replace


def sample_disturbance(params: SimParams, state: SimState):
    """Random body wrench of one substep -> (force (N, 3), torque (N, 3)):
    with probability ``disturbance_prob`` an env gets a force and a torque
    uniform in +-max_force_disturbance / +-max_torque_disturbance, else
    zeros. Drawn from the state's generator."""
    rp = params.robot
    N, g, dev = state.num_envs, state.rng, state.device
    u = env_rand(g, (N, 7), device=dev)
    occur = (u[:, 0:1] < rp.disturbance_prob).to(torch.float32)
    force = (2.0 * u[:, 1:4] - 1.0) * rp.max_force_disturbance
    torque = (2.0 * u[:, 4:7] - 1.0) * rp.max_torque_disturbance
    return force * occur, torque * occur


def compute_robot_wrench(params: SimParams, state: SimState, action: torch.Tensor,
                         disturbance=None, include_motor_wrench: bool = True):
    """One control substep -> (force_body, torque_body, new_motor_thrust):
    controller and allocation (under ``no_control`` the clipped action is
    the per-motor thrust reference), first-order motor lag, aerodynamic drag and,
    for robots that enable it, the random wrench disturbance (drawn here
    unless the caller passes its own (force, torque) pair).

    The motors' net wrench is ``allocation @ thrusts`` for both
    ``force_application_level`` settings: forces applied at the motor links
    and the wrench re-assembled at the root link are the same rigid-body
    wrench. ``include_motor_wrench=False`` (articulated robots) leaves it
    out: the coupled solver applies each thrust on its own link, so the
    returned wrench is drag and disturbance only."""
    rp, mp, cp = params.robot, params.motor, params.controller
    obs = compute_robot_obs(state.pos, state.quat, state.linvel, state.angvel)
    action = torch.clamp(action, -10.0, 10.0)

    if cp.name == "no_control":
        ref_thrust = action                      # per-motor thrust references
    else:
        gains = Gains(state.K_pos, state.K_vel, state.K_rot, state.K_angvel)
        wrench_cmd = controller_update(cp.name, cp, rp, params.gravity, obs, gains, action)
        ref_thrust = rowwise_matmul(wrench_cmd, mp.allocation_pinv.T)    # (N, M)

    new_thrust = motor_step(mp, params.dt, ref_thrust, state.motor_thrust,
                            state.motor_tau_inc, state.motor_tau_dec,
                            state.motor_thrust_constant)

    if include_motor_wrench:
        # net wrench of the per-motor forces == allocation @ thrusts
        wrench = new_thrust @ mp.allocation_matrix.T                      # (N, 6)
        force_b = wrench[..., 0:3]
        torque_b = wrench[..., 3:6]
    else:
        force_b = torch.zeros_like(state.pos)
        torque_b = torch.zeros_like(state.pos)

    v_b, w_b = obs.body_linvel, obs.body_angvel
    drag_f = (-rp.drag_lin_linear * v_b
              - rp.drag_lin_quadratic * safe_norm(v_b, dim=-1, keepdim=True) * v_b)
    drag_t = -rp.drag_ang_linear * w_b - rp.drag_ang_quadratic * torch.abs(w_b) * w_b
    force_b, torque_b = force_b + drag_f, torque_b + drag_t
    if rp.enable_disturbance:
        f_dist, t_dist = (sample_disturbance(params, state) if disturbance is None
                          else disturbance)
        force_b, torque_b = force_b + f_dist, torque_b + t_dist
    return force_b, torque_b, new_thrust


def integrate_rigid_body(params: SimParams, state: SimState,
                         force_b: torch.Tensor, torque_b: torch.Tensor) -> SimState:
    """Semi-implicit Euler step of the free rigid body with per-body
    engine damping v *= max(0, 1 - c dt) and velocity caps."""
    rp = params.robot
    dt = params.dt
    if rp.fix_base_link:
        return replace(state, linvel=torch.zeros_like(state.linvel),
                       angvel=torch.zeros_like(state.angvel))

    accel = quat_rotate(state.quat, force_b) / rp.mass
    if not rp.disable_gravity:
        accel = accel + params.gravity
    linvel = state.linvel + dt * accel
    linvel = linvel * max(0.0, 1.0 - rp.linear_damping * dt)
    speed = safe_norm(linvel, dim=-1, keepdim=True)
    linvel = torch.where(speed > rp.max_linear_velocity,
                         linvel * (rp.max_linear_velocity / torch.clamp(speed, min=1e-9)),
                         linvel)
    pos = state.pos + dt * linvel

    w_b = quat_rotate_inverse(state.quat, state.angvel)
    Iw = w_b @ rp.inertia.T
    w_dot = (torque_b - cross(w_b, Iw)) @ rp.inv_inertia.T
    w_b = w_b + dt * w_dot
    w_b = w_b * max(0.0, 1.0 - rp.angular_damping * dt)
    w_mag = safe_norm(w_b, dim=-1, keepdim=True)
    w_b = torch.where(w_mag > rp.max_angular_velocity,
                      w_b * (rp.max_angular_velocity / torch.clamp(w_mag, min=1e-9)),
                      w_b)
    angvel = quat_rotate(state.quat, w_b)
    quat = quat_integrate(state.quat, angvel, dt)
    return replace(state, pos=pos, quat=quat, linvel=linvel, angvel=angvel)


def joint_drive(dp, q, qd, q_target, qd_target):
    """(explicit spring torque, implicit damping coefficient, velocity
    reference) of the joint drives, tau = spring + damp (vel_ref - qd):
      position:  Kp (q_target - q) - Kd qd
      velocity:  Kd (qd_target - qd)
      effort:    Kp (q_target - q) + Kd (qd_target - qd), or morphy's arm
                 (nonlinear spring about 7.2 degrees for 16.25 g at 7 cm,
                 the gravity feed-forward of its command, negative linear
                 damping)
    The spring is clamped to the joints' effort limit."""
    if dp.dof_mode in ("position", "velocity") or dp.arm_response != "morphy":
        spring = dp.stiffness * (q_target - q)
        vel_ref = torch.zeros_like(qd) if dp.dof_mode == "position" else qd_target
        damp = dp.damping * torch.ones_like(q)
    else:
        e = q - 7.2 * math.pi / 180.0
        A = 0.01625 * (0.07 * 0.07)
        spring = (A * dp.nonlinear_stiffness * torch.sign(e) * e * e
                  - 9.81 * 0.01625 * 0.07 * torch.cos(q))
        vel_ref = torch.zeros_like(qd)
        damp = -A * dp.linear_damping * torch.ones_like(q)
    spring = torch.minimum(torch.maximum(spring, -dp.max_effort), dp.max_effort)
    return spring, damp, vel_ref


def integrate_dofs(params: SimParams, state: SimState) -> SimState:
    """One substep of decoupled joint dynamics J qdd = tau, the path of a
    robot with joints but no articulation URDF. The drive's damping is
    integrated implicitly (an engine drive is solved implicitly; explicit
    damping is unstable once dt Kd / J > 2)."""
    dp = params.dof
    q, qd = state.dof_pos, state.dof_vel
    spring, damp, vel_ref = joint_drive(dp, q, qd, state.dof_pos_target, state.dof_vel_target)
    dt = params.dt
    J = dp.dof_inertia
    qd = (qd + dt * (spring + damp * vel_ref) / J) / (1.0 + dt * damp / J)
    qd = torch.minimum(torch.maximum(qd, -dp.max_velocity), dp.max_velocity)
    q = q + dt * qd
    # inelastic joint stops
    zero = torch.zeros_like(qd)
    qd = torch.where((q < dp.lower_limit) & (qd < 0.0), zero, qd)
    qd = torch.where((q > dp.upper_limit) & (qd > 0.0), zero, qd)
    q = torch.minimum(torch.maximum(q, dp.lower_limit), dp.upper_limit)
    return replace(state, dof_pos=q, dof_vel=qd)


def contact_force_magnitude(params: SimParams, state: SimState) -> torch.Tensor:
    """Penetration-depth force proxy against ground plane and obstacles."""
    total = torch.zeros_like(state.collisions)
    r = params.robot.collision_radius
    if params.env.create_ground_plane:
        total = total + 1000.0 * torch.clamp(r - state.pos[..., 2], min=0.0)
    if params.scene is not None and params.scene.num_assets > 0:
        from ..envs.collision import obstacle_contact_forces
        total = total + obstacle_contact_forces(params, state)
    return total


def _substep(params: SimParams, state: SimState, action: torch.Tensor) -> SimState:
    with span("physics.control"):
        force_b, torque_b, new_thrust = compute_robot_wrench(
            params, state, action, include_motor_wrench=params.art is None)
        state = replace(state, motor_thrust=new_thrust,
                        applied_force_b=force_b, applied_torque_b=torque_b)
    with span("physics.integrate"):
        if params.art is not None:
            # the coupled base + joints: motors push on their own links, the
            # joints react on the base
            from .articulated import articulated_substep
            state = articulated_substep(params, state, force_b, torque_b, new_thrust)
        else:
            state = integrate_rigid_body(params, state, force_b, torque_b)
            if params.dof is not None and params.dof.num_dofs > 0:
                state = integrate_dofs(params, state)
        if params.scene is not None and params.scene.num_assets > 0:
            from ..envs.scene import integrate_obstacles
            state = integrate_obstacles(params, state)
    with span("physics.contact"):
        contact = contact_force_magnitude(params, state)
        collided = (contact > params.env.collision_force_threshold).to(torch.float32)
        return replace(state, collisions=state.collisions + collided)


@spanned("physics")
def env_step(params: SimParams, state: SimState, action: torch.Tensor,
             n_substeps: Optional[int] = None) -> SimState:
    """One environment step = n physics substeps (control-rate decimation).
    ``n_substeps`` is a host int (sampled by the caller); None means the
    config's mean. Replayed from a CUDA graph where the state is on CUDA
    and no input needs a gradient, else ``env_step_eager``."""
    n = params.env.substep_mean if n_substeps is None else n_substeps
    return GRAPHS.step(env_step_eager, params, state, action, n)


def env_step_eager(params: SimParams, state: SimState, action: torch.Tensor,
                   n_substeps: Optional[int] = None) -> SimState:
    """``env_step`` run op by op."""
    state = replace(state,
                    collisions=torch.zeros_like(state.collisions),
                    crashes=torch.zeros_like(state.crashes),
                    truncations=torch.zeros_like(state.truncations))
    n = params.env.substep_mean if n_substeps is None else n_substeps
    for _ in range(n):
        state = _substep(params, state, action)
    return replace(state,
                   sim_steps=state.sim_steps + 1,
                   crashes=torch.maximum(state.crashes,
                                         (state.collisions > 0).to(torch.float32)))


def sample_reset_states(params: SimParams, state: SimState) -> dict:
    """Draw a full fresh per-env state (bounds, pose, vel, gains, motors)
    from the state's generator."""
    rp, mp, cp = params.robot, params.motor, params.controller
    ep = params.env
    N, M = state.pos.shape[0], mp.num_motors
    g, dev = state.rng, state.device

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * env_rand(g, (N,) + shape, device=dev)

    bounds_lo = uniform(ep.lower_bound_min, ep.lower_bound_max, 3)
    bounds_hi = uniform(ep.upper_bound_min, ep.upper_bound_max, 3)
    rand13 = uniform(rp.min_init_state, rp.max_init_state, 13)
    fresh = dict(
        pos=interpolate_ratio(bounds_lo, bounds_hi, rand13[..., 0:3]),
        quat=quat_from_euler_xyz_tensor(rand13[..., 3:6]),
        linvel=rand13[..., 7:10].contiguous(),
        angvel=rand13[..., 10:13].contiguous(),
        bounds_lo=bounds_lo, bounds_hi=bounds_hi,
    )
    if cp.randomize_params:
        fresh.update(K_pos=uniform(cp.K_pos_min, cp.K_pos_max, 3),
                     K_vel=uniform(cp.K_vel_min, cp.K_vel_max, 3),
                     K_rot=uniform(cp.K_rot_min, cp.K_rot_max, 3),
                     K_angvel=uniform(cp.K_angvel_min, cp.K_angvel_max, 3))
    else:
        mid = lambda lo, hi: ((lo + hi) / 2.0).expand(N, 3)
        fresh.update(K_pos=mid(cp.K_pos_min, cp.K_pos_max),
                     K_vel=mid(cp.K_vel_min, cp.K_vel_max),
                     K_rot=mid(cp.K_rot_min, cp.K_rot_max),
                     K_angvel=mid(cp.K_angvel_min, cp.K_angvel_max))
    fresh.update(
        motor_tau_inc=uniform(mp.tau_inc_min, mp.tau_inc_max, M),
        motor_tau_dec=uniform(mp.tau_dec_min, mp.tau_dec_max, M),
        motor_thrust=uniform(mp.min_thrust, mp.max_thrust, M),
        motor_thrust_constant=uniform(mp.thrust_constant_min, mp.thrust_constant_max, M),
    )
    dp = params.dof
    if dp is not None and dp.num_dofs > 0:
        D = dp.num_dofs
        fresh.update(dof_pos=uniform(dp.init_pos_min, dp.init_pos_max, D),
                     dof_vel=uniform(dp.init_vel_min, dp.init_vel_max, D),
                     dof_pos_target=torch.zeros((N, D), device=dev),
                     dof_vel_target=torch.zeros((N, D), device=dev))
    return fresh


@spanned("reset")
def reset_envs(params: SimParams, state: SimState, mask: torch.Tensor) -> SimState:
    """Masked auto-reset: where mask, replace the state with a fresh draw."""
    fresh = sample_reset_states(params, state)
    mb = mask.to(torch.bool)

    def sel(new, old):
        return torch.where(mb.reshape((-1,) + (1,) * (old.dim() - 1)), new, old)

    updates = {name: sel(val, getattr(state, name)) for name, val in fresh.items()}
    state = replace(state,
                    sim_steps=torch.where(mb, torch.zeros_like(state.sim_steps),
                                          state.sim_steps),
                    collisions=torch.where(mb, torch.zeros_like(state.collisions),
                                           state.collisions),
                    **updates)
    if params.scene is not None and params.scene.num_assets > 0:
        from ..envs.scene import reset_obstacles
        state = reset_obstacles(params, state, mask)
    from ..sensors.raycast_sensor import sample_mount_pose
    for sp, prefix in ((params.camera, "cam"), (params.lidar, "lidar")):
        if sp is None:
            continue
        mpos, mquat = sample_mount_pose(sp, state.rng, state.num_envs)
        pos_name, quat_name = f"{prefix}_mount_pos", f"{prefix}_mount_quat"
        state = replace(state, **{
            pos_name: sel(mpos, getattr(state, pos_name)),
            quat_name: sel(mquat, getattr(state, quat_name))})
    if params.imu is not None:
        from ..sensors.imu import sample_imu_reset
        ab, gb, mq = sample_imu_reset(params.imu, state.rng, state.num_envs)
        m = mb[:, None]
        state = replace(state,
                        imu_accel_bias=torch.where(m, ab, state.imu_accel_bias),
                        imu_gyro_bias=torch.where(m, gb, state.imu_gyro_bias),
                        imu_mount_quat=torch.where(m, mq, state.imu_mount_quat))
    return state


def post_reward_step(params: SimParams, state: SimState) -> SimState:
    """Auto-reset terminated/truncated envs."""
    if params.env.reset_on_collision:
        done = torch.maximum(state.crashes, state.truncations)
    else:
        done = state.truncations
    return reset_envs(params, state, done)
