"""Floating-base articulated dynamics of the reconfigurable robots (snakey,
morphy).

Counterpart of ``aerial_gym_simulator_tpu/sim/articulated.py``: the base and
the joints step together on the full joint-space equations of motion

    H(q) [a0; qdd] = tau - C(q, v) - G(q) + J^T f_ext,

so the inertia depends on the configuration, the joints' reaction wrenches
reach the base, and the motors' moment arms move with their links:

  * a forward pass for the bodies' poses, velocities and bias
    accelerations,
  * an RNEA backward pass for the bias forces C + G - J^T f_ext (qdd = 0),
  * H assembled from the bodies' stacked base-frame Jacobians,
  * the drives' damping taken implicitly on H's diagonal, one batched
    Cholesky solve, semi-implicit integration, the engine's damping and
    velocity clamps, inelastic joint stops.

Motor thrusts act on their owning links with the thrust-to-torque couple;
the joint drives (position / velocity / effort PD, morphy's nonlinear arm
spring) enter as generalized torques.

Spatial vectors follow Featherstone: motion [omega; v], force [n; f], body
coordinates; the base block uses the base-origin body frame, so the solved
base acceleration is the plain derivative of (omega_b, v_b).

The loops over bodies run on the host over the static tree (Python data in
``ArtParams``); every tensor op is batched over envs. Nothing reads a
device value back: the solve uses ``cholesky_ex`` (no info check).
"""

from __future__ import annotations

import torch

from ..utils.math import quat_integrate, quat_to_rotation_matrix, safe_norm
from .dynamics import joint_drive
from .structs import ArtParams, SimParams, SimState, replace


def _cross(a, b):
    return torch.linalg.cross(*torch.broadcast_tensors(a, b), dim=-1)


def _matvec(m, v):
    """Batched matrix-vector product (..., a, b) @ (..., b) -> (..., a)."""
    return (m @ v.unsqueeze(-1)).squeeze(-1)


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _spatial_inertia(m, c, I_com):
    """(6, 6) spatial inertia about the body origin from (mass, com, I_com)."""
    cx = _skew(c)
    eye = torch.eye(3, dtype=c.dtype, device=c.device)
    top = torch.cat([I_com + m * (cx @ cx.T), m * cx], -1)
    return torch.cat([top, torch.cat([m * cx.T, m * eye], -1)], -2)


class _Derived:
    """Per-ArtParams constants the substep reuses: the axes' skew matrices,
    the spatial inertias, the ancestor mask and a few stacks."""

    def __init__(self, art: ArtParams):
        nb = art.nb
        self.K = _skew(art.axis)                                    # (nb, 3, 3)
        self.KK = self.K @ self.K
        self.I_body = torch.stack([_spatial_inertia(art.mass[i], art.com[i], art.inertia[i])
                                   for i in range(nb)])               # (nb, 6, 6)
        self.I_base = _spatial_inertia(art.base_mass, art.base_com, art.base_inertia)
        anc = torch.zeros((nb, nb), dtype=art.axis.dtype)
        for i in range(nb):
            j = i
            while j >= 0:
                anc[i, j] = 1.0
                j = art.parent[j]
        self.ancestors = anc.to(art.axis.device)                      # [body, joint]
        self.masses = torch.cat([art.mass.new_tensor([art.base_mass]), art.mass])  # (nb + 1,)
        self.base_skew = _skew(art.base_com)


def _derived(art: ArtParams) -> _Derived:
    d = art.__dict__.get("_derived")
    if d is None:
        d = _Derived(art)
        art.__dict__["_derived"] = d
    return d


def _xform(E, r, v):
    """Motion transform child <- parent of a spatial vector: [E w; E (vl - r x w)]."""
    w, vl = v[:, 0:3], v[:, 3:6]
    return torch.cat([_matvec(E, w), _matvec(E, vl - _cross(r, w))], -1)


def _xform_T(E, r, f):
    """Its transpose on a spatial force (child -> parent):
    [E^T n + r x (E^T fl); E^T fl]."""
    Et = E.transpose(-1, -2)
    fl = _matvec(Et, f[:, 3:6])
    return torch.cat([_matvec(Et, f[:, 0:3]) + _cross(r, fl), fl], -1)


def _crf(v, f):
    """(v x*) f: [w x n + vl x fl; w x fl]."""
    w, vl = v[:, 0:3], v[:, 3:6]
    n, fl = f[:, 0:3], f[:, 3:6]
    return torch.cat([_cross(w, n) + _cross(vl, fl), _cross(w, fl)], -1)


def _spd_solve(A, b):
    """A x = b for a batch of SPD A: Cholesky (no host-side check) and two
    triangular solves."""
    L, _ = torch.linalg.cholesky_ex(A)
    y = torch.linalg.solve_triangular(L, b.unsqueeze(-1), upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True).squeeze(-1)


def articulated_substep(params: SimParams, state: SimState, base_force_b: torch.Tensor,
                        base_torque_b: torch.Tensor, thrusts: torch.Tensor) -> SimState:
    """One coupled base + joints physics substep.

    base_force_b / base_torque_b: the non-motor wrench on the base (drag and
    disturbance), base frame about the base origin. thrusts: (N, M) motor
    thrusts, applied on their owning links."""
    art, dp, rp, mp = params.art, params.dof, params.robot, params.motor
    d = _derived(art)
    dt = params.dt
    nb = art.nb
    N = state.num_envs
    dev, f32 = state.device, state.pos.dtype

    Rb = quat_to_rotation_matrix(state.quat)                          # body -> world
    Rbt = Rb.transpose(-1, -2)
    omega_b = _matvec(Rbt, state.angvel)
    v_b = _matvec(Rbt, state.linvel)
    q, qd = state.dof_pos, state.dof_vel
    g_b = (torch.zeros((N, 3), dtype=f32, device=dev) if rp.disable_gravity
           else _matvec(Rbt, params.gravity.expand(N, 3)))
    if rp.fix_base_link:
        omega_b = torch.zeros_like(omega_b)
        v_b = torch.zeros_like(v_b)

    # forward pass: kinematics, velocities, zero-qdd (bias) accelerations
    v0 = torch.cat([omega_b, v_b], -1)
    s, c = torch.sin(q), torch.cos(q)
    eye3 = torch.eye(3, dtype=f32, device=dev)
    # joint rotations child -> parent of every body at once: R_tree (I + s K + (1 - c) K^2)
    rot = (eye3 + s[..., None, None] * d.K + (1.0 - c)[..., None, None] * d.KK)   # (N, nb, 3, 3)
    Rj_all = art.R_tree @ rot
    E_all = Rj_all.transpose(-1, -2)
    ax_qd = art.axis * qd[..., None]                                   # (N, nb, 3)
    R0, p0, v, a = [], [], [], []
    for i in range(nb):
        Rj, E, r, ax = Rj_all[:, i], E_all[:, i], art.t_tree[i], ax_qd[:, i]
        pi = art.parent[i]
        if pi >= 0:
            R0_i = R0[pi] @ Rj
            p0_i = p0[pi] + _matvec(R0[pi], r.expand(N, 3))
            v_p, a_p = v[pi], a[pi]
        else:
            R0_i = Rj
            p0_i = r.expand(N, 3)
            v_p, a_p = v0, None
        v_i = _xform(E, r, v_p)
        v_i = torch.cat([v_i[:, 0:3] + ax, v_i[:, 3:6]], -1)
        # c = v x^ S qd (S = [axis; 0] constant in child coordinates)
        c_i = torch.cat([_cross(v_i[:, 0:3], ax), _cross(v_i[:, 3:6], ax)], -1)
        a_i = c_i if a_p is None else _xform(E, r, a_p) + c_i
        R0.append(R0_i)
        p0.append(p0_i)
        v.append(v_i)
        a.append(a_i)
    R0_all = torch.stack(R0, 1)                                        # (N, nb, 3, 3)
    p0_all = torch.stack(p0, 1)                                        # (N, nb, 3)

    # external forces per body (own coordinates, about its origin): gravity,
    # the motors' thrust and drag couple; the base gets drag and disturbance
    cq = mp.thrust_to_torque_ratio
    f_ext_base = torch.cat([base_torque_b, base_force_b], -1)
    f_ext = torch.zeros((N, nb, 6), dtype=f32, device=dev)
    if not rp.disable_gravity:
        mg_base = art.base_mass * g_b
        f_ext_base = f_ext_base + torch.cat([_cross(art.base_com, mg_base), mg_base], -1)
        g_i = _matvec(R0_all.transpose(-1, -2), g_b[:, None, :])       # R0^T g per body
        mg = art.mass[:, None] * g_i
        f_ext = f_ext + torch.cat([_cross(art.com, mg), mg], -1)
    fm = art.motor_dir * thrusts[..., None]                            # (N, M, 3)
    nm = (_cross(art.motor_pos, fm)
          - cq * (mp.motor_directions[:, None] * art.motor_dir) * thrusts[..., None])
    f_motor = torch.cat([nm, fm], -1)                                  # (N, M, 6)
    f_ext_list = list(f_ext.unbind(1))
    for m, body in enumerate(art.motor_body):
        if body < 0:
            f_ext_base = f_ext_base + f_motor[:, m]
        else:
            f_ext_list[body] = f_ext_list[body] + f_motor[:, m]

    # RNEA backward pass: bias generalized forces (qdd = 0, a0 = 0)
    a_all = torch.stack(a, 1)                                          # (N, nb, 6)
    v_all = torch.stack(v, 1)
    Ia = _matvec(d.I_body, a_all)
    Iv = _matvec(d.I_body, v_all)
    fb_all = Ia + _crf(v_all.reshape(-1, 6), Iv.reshape(-1, 6)).reshape(N, nb, 6) \
        - torch.stack(f_ext_list, 1)
    fb = list(fb_all.unbind(1))
    fb_base = _crf(v0, v0 @ d.I_base.T) - f_ext_base
    p_q = [None] * nb
    for i in range(nb - 1, -1, -1):
        p_q[i] = fb[i][:, 0:3] @ art.axis[i]
        up = _xform_T(E_all[:, i], art.t_tree[i], fb[i])
        if art.parent[i] >= 0:
            fb[art.parent[i]] = fb[art.parent[i]] + up
        else:
            fb_base = fb_base + up

    # mass matrix H (N, 6+K, 6+K) from base-frame body Jacobians:
    #   H = sum_b m_b Wv_b^T Wv_b + Ww_b^T Ibar_b Ww_b,
    # Wv / Ww map u = [w_b; v_b; qd] to body b's com velocity / angular
    # velocity
    K = nb
    axis_b = _matvec(R0_all, art.axis.expand(N, K, 3))                # (N, K, 3)
    com_b = p0_all + _matvec(R0_all, art.com.expand(N, K, 3))          # (N, K, 3)
    anc = d.ancestors[None, :, :, None]                                # (1, body, joint, 1)
    Jv = _cross(axis_b[:, None, :, :], com_b[:, :, None, :] - p0_all[:, None, :, :]) * anc
    Jw = axis_b[:, None, :, :] * anc                                   # (N, body, joint, 3)
    eyeNK = eye3.expand(N, K, 3, 3)
    Wv_bodies = torch.cat([-_skew(com_b), eyeNK, Jv.transpose(-1, -2)], -1)  # (N, K, 3, D)
    Ww_bodies = torch.cat([eyeNK, torch.zeros_like(eyeNK), Jw.transpose(-1, -2)], -1)
    zK = torch.zeros((N, 3, K), dtype=f32, device=dev)
    eyeN = eye3.expand(N, 3, 3)
    Wv_base = torch.cat([-d.base_skew.expand(N, 3, 3), eyeN, zK], -1)
    Ww_base = torch.cat([eyeN, torch.zeros_like(eyeN), zK], -1)
    Wv = torch.cat([Wv_base[:, None], Wv_bodies], 1)                   # (N, B, 3, D)
    Ww = torch.cat([Ww_base[:, None], Ww_bodies], 1)
    Ibar_bodies = R0_all @ art.inertia @ R0_all.transpose(-1, -2)
    Ibar = torch.cat([art.base_inertia.expand(N, 1, 3, 3), Ibar_bodies], 1)
    H = (torch.einsum("b,nbxd,nbxe->nde", d.masses, Wv, Wv)
         + torch.einsum("nbxd,nbxy,nbye->nde", Ww, Ibar, Ww))

    # joint drives (implicit damping) and the SPD solve
    spring, damp, vel_ref = joint_drive(dp, q, qd, state.dof_pos_target, state.dof_vel_target)
    tau = spring + damp * (vel_ref - qd)
    rhs = torch.cat([-fb_base, tau - torch.stack(p_q, -1)], -1)
    diag = torch.cat([torch.zeros((N, 6), dtype=f32, device=dev), art.armature + dt * damp], -1)
    H = H + torch.diag_embed(diag)
    if rp.fix_base_link:
        qdd = _spd_solve(H[:, 6:, 6:], rhs[:, 6:])
        acc = torch.cat([torch.zeros((N, 6), dtype=f32, device=dev), qdd], -1)
    else:
        acc = _spd_solve(H, rhs)

    # semi-implicit integration, the engine's damping and clamps, joint stops
    omega_n = omega_b + dt * acc[:, 0:3]
    v_n = v_b + dt * acc[:, 3:6]
    omega_n = omega_n * max(0.0, 1.0 - rp.angular_damping * dt)
    v_n = v_n * max(0.0, 1.0 - rp.linear_damping * dt)
    wmag = safe_norm(omega_n, dim=-1, keepdim=True)
    omega_n = torch.where(wmag > rp.max_angular_velocity,
                          omega_n * (rp.max_angular_velocity / torch.clamp(wmag, min=1e-9)),
                          omega_n)
    vmag = safe_norm(v_n, dim=-1, keepdim=True)
    v_n = torch.where(vmag > rp.max_linear_velocity,
                      v_n * (rp.max_linear_velocity / torch.clamp(vmag, min=1e-9)), v_n)
    qd_n = torch.minimum(torch.maximum(qd + dt * acc[:, 6:], -dp.max_velocity), dp.max_velocity)
    q_n = q + dt * qd_n
    # inelastic joint stops
    hit_lo = q_n < dp.lower_limit
    hit_hi = q_n > dp.upper_limit
    zero = torch.zeros_like(qd_n)
    qd_n = torch.where(hit_lo & (qd_n < 0.0), zero, qd_n)
    qd_n = torch.where(hit_hi & (qd_n > 0.0), zero, qd_n)
    q_n = torch.minimum(torch.maximum(q_n, dp.lower_limit), dp.upper_limit)

    if rp.fix_base_link:
        new_pos, new_quat = state.pos, state.quat
        new_linvel = torch.zeros_like(state.linvel)
        new_angvel = torch.zeros_like(state.angvel)
    else:
        # back to the world frame with the attitude AFTER integration: the
        # stale one would drop the dt w x v transport term and leak momentum
        new_quat = quat_integrate(state.quat, _matvec(Rb, omega_n), dt)
        Rn = quat_to_rotation_matrix(new_quat)
        new_angvel = _matvec(Rn, omega_n)
        new_linvel = _matvec(Rn, v_n)
        new_pos = state.pos + dt * new_linvel

    # the IMU's source: the specific force of the base origin in the base
    # frame (material acceleration minus gravity) times the total mass
    spec = acc[:, 3:6] + _cross(omega_b, v_b) - g_b
    return replace(state, pos=new_pos, quat=new_quat, linvel=new_linvel, angvel=new_angvel,
                   dof_pos=q_n, dof_vel=qd_n, applied_force_b=rp.mass * spec)

