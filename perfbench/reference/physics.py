"""Plain reference of one environment step of a rigid multirotor among
obstacles: Lee velocity controller, allocation, first-order motor model
(rpm domain, RK4), drag and random wrench, semi-implicit rigid-body Euler
step, kinematic obstacles, and the sphere-against-primitives contact test
that flags crashes.

A frozen copy, in plain torch, of the port's step as the benchmark found it:
``sim/dynamics.py`` (``compute_robot_wrench`` 55-100, ``integrate_rigid_body``
103-133, ``_substep`` 190-209, ``env_step`` 212-227),
``control/controllers.py`` (``compute_robot_obs`` 60-72,
``compute_acceleration``, ``compute_body_torque``,
``desired_quat_from_forces_full``, ``euler_rates_to_body_rates``,
``lee_velocity_control`` 80-171), ``ops/motor_model.py`` (``motor_step``),
``envs/collision.py`` (the signed distances) and ``envs/scene.py``
(``integrate_obstacles``). Its parameters come from the configuration file
of the cell (``perfbench/configs/*.json``): the allocation's pseudo-inverse
and the inverse inertia are worked out here again. Imports nothing of the
port.

Every function takes a ``dtype``: float32 is the configuration's precision;
the control runs the same code in bfloat16.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import math3d as m

STIFFNESS = 1000.0     # N/m, the contact proxy's penalty


def f32(x) -> float:
    return float(np.float32(x))


@dataclass
class Physics:
    """The step's constants, built from a configuration's ``physics`` block."""
    dt: float
    gravity: torch.Tensor
    mass: float
    inertia: torch.Tensor
    inv_inertia: torch.Tensor
    linear_damping: float
    angular_damping: float
    max_linear_velocity: float
    max_angular_velocity: float
    collision_radius: float
    drag: tuple
    disturbance: bool
    disturbance_prob: float
    max_force: torch.Tensor
    max_torque: torch.Tensor
    allocation: torch.Tensor
    allocation_pinv: torch.Tensor
    min_thrust: float
    max_thrust: float
    max_thrust_rate: float
    max_yaw_rate: float
    collision_threshold: float
    ground_plane: bool
    substeps: int

    @staticmethod
    def build(cfg: dict, device, dtype=torch.float32) -> "Physics":
        sim, rb, mo = cfg["sim"], cfg["robot"], cfg["motor"]
        ctl, env = cfg["controller"], cfg["env"]
        if ctl["name"] != "lee_velocity_control":
            raise ValueError(f"no reference for controller {ctl['name']!r}")
        if not (mo["use_rps"] and mo["use_discrete_approximation"]
                and mo["integration_scheme"] == "rk4"):
            raise ValueError("the reference models the rpm-domain RK4 motor alone")
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device).to(dtype)
        inertia = np.asarray(rb["inertia"], np.float64)
        alloc = np.asarray(mo["allocation_matrix"], np.float32)
        dist = rb["disturbance"]
        return Physics(
            dt=f32(sim["dt"]), gravity=t(sim["gravity"]), mass=f32(rb["mass"]),
            inertia=t(inertia), inv_inertia=t(np.linalg.inv(inertia)),
            linear_damping=f32(rb["linear_damping"]), angular_damping=f32(rb["angular_damping"]),
            max_linear_velocity=f32(rb["max_linear_velocity"]),
            max_angular_velocity=f32(rb["max_angular_velocity"]),
            collision_radius=f32(rb["collision_radius"]),
            drag=tuple(t(rb[k]) for k in ("drag_lin_linear", "drag_lin_quadratic",
                                          "drag_ang_linear", "drag_ang_quadratic")),
            disturbance=bool(dist["enable"]), disturbance_prob=f32(dist["prob"]),
            max_force=t(dist["max_force_and_torque"][0:3]),
            max_torque=t(dist["max_force_and_torque"][3:6]),
            allocation=t(alloc), allocation_pinv=t(np.linalg.pinv(alloc)),
            min_thrust=f32(mo["min_thrust"]), max_thrust=f32(mo["max_thrust"]),
            max_thrust_rate=f32(mo["max_thrust_rate"]), max_yaw_rate=f32(ctl["max_yaw_rate"]),
            collision_threshold=f32(env["collision_force_threshold"]),
            ground_plane=bool(env["create_ground_plane"]), substeps=int(env["substeps"]))


def robot_obs(pos, quat, linvel, angvel):
    vq = m.vehicle_frame_quat(quat)
    return dict(pos=pos, quat=quat, linvel=linvel, angvel=angvel,
                euler=m.ssa(m.get_euler_xyz_tensor(quat)), vehicle_quat=vq,
                body_linvel=m.quat_rotate_inverse(quat, linvel),
                body_angvel=m.quat_rotate_inverse(quat, angvel))


def lee_velocity_control(ph: Physics, obs, K, action):
    """-> (N, 6) body wrench command for [vx, vy, vz, yaw_rate] in the
    vehicle frame."""
    setvel_world = m.quat_rotate(obs["vehicle_quat"], action[..., 0:3])
    accel = K["K_pos"] * (obs["pos"] - obs["pos"]) + K["K_vel"] * (setvel_world - obs["linvel"])
    forces = (accel - ph.gravity) * ph.mass
    R = m.quat_to_rotation_matrix(obs["quat"])
    thrust = torch.sum(forces * R[..., :, 2], dim=-1)
    # desired orientation: body z along the force at the current yaw
    yaw = obs["euler"][..., 2]
    b3 = m.normalize(forces)
    temp = torch.stack([torch.cos(yaw), torch.sin(yaw), torch.zeros_like(yaw)], dim=-1)
    b2 = m.normalize(m.cross(b3, temp))
    b1 = m.cross(b2, b3)
    quat_des = m.rotation_matrix_to_quat(torch.stack([b1, b2, b3], dim=-1))
    # yaw-rate command as body rates
    euler = obs["euler"]
    s_pitch, c_pitch = torch.sin(euler[..., 1]), torch.cos(euler[..., 1])
    s_roll, c_roll = torch.sin(euler[..., 0]), torch.cos(euler[..., 0])
    z = torch.zeros_like(action[..., 3])
    r0, r1, r2 = z, z, action[..., 3]
    rates = torch.stack([r0 - s_pitch * r2, c_roll * r1 + s_roll * c_pitch * r2,
                         -s_roll * r1 + c_roll * c_pitch * r2], dim=-1)
    # SO(3) error torque with the gyroscopic feed-forward
    yaw_rate = torch.clamp(rates[..., 2], -ph.max_yaw_rate, ph.max_yaw_rate)
    rates = torch.cat([rates[..., :2], yaw_rate[..., None]], dim=-1)
    RT_Rd_quat = m.quat_mul(m.quat_conjugate(obs["quat"]), quat_des)
    RT_Rd = m.quat_to_rotation_matrix(RT_Rd_quat)
    rot_err = 0.5 * m.compute_vee_map(RT_Rd.transpose(-2, -1) - RT_Rd)
    angvel_err = obs["body_angvel"] - m.quat_rotate(RT_Rd_quat, rates)
    Iw = obs["body_angvel"] @ ph.inertia.T
    torque = -K["K_rot"] * rot_err - K["K_angvel"] * angvel_err + m.cross(obs["body_angvel"], Iw)
    zeros = torch.zeros_like(thrust)
    return torch.stack([zeros, zeros, thrust, torque[..., 0], torque[..., 1], torque[..., 2]],
                       dim=-1)


def motor_step(ph: Physics, ref, cur, tau_inc, tau_dec, kt):
    """rpm-domain first-order lag, discrete mixing factor, RK4 with a rate
    clamp at every stage -> new thrusts."""
    ref = torch.clamp(ref, ph.min_thrust, ph.max_thrust)
    err = ref - cur
    tau = torch.where(torch.sign(cur) * torch.sign(err) < 0, tau_dec, tau_inc)
    mix = 1.0 / (ph.dt + tau)
    safe_kt = torch.clamp(kt, min=1e-12)
    cur_rpm = m.safe_sqrt(cur / safe_kt)
    des_rpm = m.safe_sqrt(ref / safe_kt)
    rate = lambda e: m.tensor_clamp(mix * e, -ph.max_thrust_rate, ph.max_thrust_rate)
    dt = ph.dt
    k1 = rate(des_rpm - cur_rpm)
    k2 = rate(des_rpm - (cur_rpm + 0.5 * dt * k1))
    k3 = rate(des_rpm - (cur_rpm + 0.5 * dt * k2))
    k4 = rate(des_rpm - (cur_rpm + dt * k3))
    new_rpm = cur_rpm + (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)
    return kt * new_rpm * new_rpm


def _sd_box(p, half):
    q = torch.abs(p) - half
    return m.safe_norm(torch.clamp(q, min=0.0), dim=-1) + torch.clamp(torch.amax(q, dim=-1),
                                                                       max=0.0)


def _sd_cylinder(p, r, h):
    d_xy = m.safe_norm(p[..., :2], dim=-1) - r
    d_z = torch.abs(p[..., 2]) - 0.5 * h
    outside = m.safe_norm(torch.stack([torch.clamp(d_xy, min=0.0), torch.clamp(d_z, min=0.0)],
                                      dim=-1), dim=-1)
    return outside + torch.clamp(torch.maximum(d_xy, d_z), max=0.0)


def _sd_triangle(p, size):
    a, b, c = size[..., 0], size[..., 1], size[..., 2]
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    zeros = torch.zeros_like(a)

    def seg2(px, py, ax_, ay, bx, by):
        dx_, dy_ = bx - ax_, by - ay
        tt = torch.clamp(((px - ax_) * dx_ + (py - ay) * dy_)
                         / torch.clamp(dx_ * dx_ + dy_ * dy_, min=1e-12), 0.0, 1.0)
        return (px - (ax_ + tt * dx_)) ** 2 + (py - (ay + tt * dy_)) ** 2

    v = y / torch.clamp(c, min=1e-12)
    u = (x - v * b) / torch.clamp(a, min=1e-12)
    inside = (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    d_edge2 = torch.minimum(torch.minimum(seg2(x, y, zeros, zeros, a, zeros),
                                          seg2(x, y, a, zeros, b, c)),
                            seg2(x, y, b, c, zeros, zeros))
    return m.safe_sqrt(torch.where(inside, torch.zeros_like(d_edge2), d_edge2) + z * z)


def scene_distance(scene, obstacle_pos, obstacle_quat, p_world):
    """Least signed distance from world points (N, 3) to each env's
    primitives. ``scene``: the local tables (kind, size, pos, rot, slot)."""
    slot = scene["slot"]
    gather = lambda per_slot: torch.gather(
        per_slot, 1, slot[..., None].expand(slot.shape + (per_slot.shape[-1],)))
    a_pos, a_quat = gather(obstacle_pos), gather(obstacle_quat)
    p_asset = m.quat_rotate_inverse(a_quat, p_world[:, None, :] - a_pos)
    local = torch.sum(scene["rot"] * (p_asset - scene["pos"])[..., :, None], dim=-2)
    kind, size = scene["kind"], scene["size"]
    d = torch.where(kind == 0, _sd_box(local, 0.5 * size),
                    torch.where(kind == 1, _sd_cylinder(local, size[..., 0], size[..., 1]),
                                torch.where(kind == 3, _sd_triangle(local, size),
                                            m.safe_norm(local, dim=-1) - size[..., 0])))
    d = torch.where(kind < 0, torch.full_like(d, 1e6), d)
    return torch.amin(d, dim=1)


def substep(ph: Physics, s: dict, action, scene, disturbance=None):
    """One physics substep on the state dict ``s`` -> a new dict.
    ``disturbance`` is the substep's (N, 7) uniform draw when the robot has
    random wrenches."""
    obs = robot_obs(s["pos"], s["quat"], s["linvel"], s["angvel"])
    action = torch.clamp(action, -10.0, 10.0)
    K = {k: s[k] for k in ("K_pos", "K_vel", "K_rot", "K_angvel")}
    wrench_cmd = lee_velocity_control(ph, obs, K, action)
    ref_thrust = m.rowwise_matmul(wrench_cmd, ph.allocation_pinv.T)
    thrust = motor_step(ph, ref_thrust, s["motor_thrust"], s["motor_tau_inc"],
                        s["motor_tau_dec"], s["motor_thrust_constant"])
    wrench = thrust @ ph.allocation.T
    force_b, torque_b = wrench[..., 0:3], wrench[..., 3:6]
    v_b, w_b = obs["body_linvel"], obs["body_angvel"]
    d_ll, d_lq, d_al, d_aq = ph.drag
    force_b = force_b + (-d_ll * v_b - d_lq * m.safe_norm(v_b, dim=-1, keepdim=True) * v_b)
    torque_b = torque_b + (-d_al * w_b - d_aq * torch.abs(w_b) * w_b)
    if ph.disturbance:
        u = disturbance
        occur = (u[:, 0:1] < ph.disturbance_prob).to(u.dtype)
        force_b = force_b + ((2.0 * u[:, 1:4] - 1.0) * ph.max_force) * occur
        torque_b = torque_b + ((2.0 * u[:, 4:7] - 1.0) * ph.max_torque) * occur

    # free rigid body, semi-implicit Euler with engine damping and caps
    dt = ph.dt
    accel = m.quat_rotate(s["quat"], force_b) / ph.mass + ph.gravity
    linvel = s["linvel"] + dt * accel
    linvel = linvel * max(0.0, 1.0 - ph.linear_damping * dt)
    speed = m.safe_norm(linvel, dim=-1, keepdim=True)
    linvel = torch.where(speed > ph.max_linear_velocity,
                         linvel * (ph.max_linear_velocity / torch.clamp(speed, min=1e-9)), linvel)
    pos = s["pos"] + dt * linvel
    w = m.quat_rotate_inverse(s["quat"], s["angvel"])
    w_dot = (torque_b - m.cross(w, w @ ph.inertia.T)) @ ph.inv_inertia.T
    w = (w + dt * w_dot) * max(0.0, 1.0 - ph.angular_damping * dt)
    w_mag = m.safe_norm(w, dim=-1, keepdim=True)
    w = torch.where(w_mag > ph.max_angular_velocity,
                    w * (ph.max_angular_velocity / torch.clamp(w_mag, min=1e-9)), w)
    angvel = m.quat_rotate(s["quat"], w)
    quat = m.quat_integrate(s["quat"], angvel, dt)

    # kinematic obstacles, then the contact test
    obstacle_pos = s["obstacle_pos"] + dt * s["obstacle_linvel"]
    obstacle_quat = m.quat_integrate(s["obstacle_quat"], s["obstacle_angvel"], dt)
    contact = torch.zeros_like(s["collisions"])
    if ph.ground_plane:
        contact = contact + 1000.0 * torch.clamp(ph.collision_radius - pos[..., 2], min=0.0)
    d = scene_distance(scene, obstacle_pos, obstacle_quat, pos)
    contact = contact + STIFFNESS * torch.clamp(ph.collision_radius - d, min=0.0)
    collided = (contact > ph.collision_threshold).to(contact.dtype)
    return dict(s, pos=pos, quat=quat, linvel=linvel, angvel=angvel, motor_thrust=thrust,
                obstacle_pos=obstacle_pos, obstacle_quat=obstacle_quat,
                collisions=s["collisions"] + collided)


STATE_KEYS = ("pos", "quat", "linvel", "angvel", "motor_thrust", "motor_tau_inc",
              "motor_tau_dec", "motor_thrust_constant", "K_pos", "K_vel", "K_rot", "K_angvel",
              "obstacle_pos", "obstacle_quat", "obstacle_linvel", "obstacle_angvel")


def env_step(ph: Physics, state: dict, action, scene, disturbances=None, dtype=torch.float32):
    """One environment step of ``ph.substeps`` substeps from the state's
    tensors (``STATE_KEYS``) -> dict of the next state, with ``crashes``
    (N,) the envs that touched an obstacle in any substep. ``disturbances``:
    one (N, 7) draw per substep when the robot has random wrenches."""
    s = {k: state[k].to(dtype) for k in STATE_KEYS}
    s["collisions"] = torch.zeros_like(s["pos"][:, 0])
    action = action.to(dtype)
    sc = {k: (v.to(dtype) if v.is_floating_point() else v) for k, v in scene.items()}
    for i in range(ph.substeps):
        s = substep(ph, s, action, sc, None if disturbances is None else disturbances[i].to(dtype))
    s["crashes"] = (s["collisions"] > 0).to(dtype)
    return s
