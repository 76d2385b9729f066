"""Port parity for the articulated robots (snakey, snakey5, snakey6, the
morphy family): the URDF joint trees, the built joint and articulation
parameters, one coupled substep and twenty env steps from a state carried
across from the JAX package, the decoupled joint path of a robot without
an articulation URDF, the joint reset draws and the joint-target setters;
then the port alone against the ground truths of tests/test_articulated.py
(the pendulum ODE, momentum conservation checked by an independent numpy
forward kinematics, a deflected arm torquing the base, the fixed-base arms
settling).

Tolerances, and how they were chosen:
  * parsed trees: exact (the same numpy code on the same text); built
    parameters: float leaves 1e-6, integer and tuple leaves exact;
  * one substep from the same state (disturbance off): positions,
    attitudes and joint angles 1e-6; linear, angular and joint velocities
    1e-4; the IMU's specific force 1e-4 of its largest magnitude. The two
    packages assemble H and the bias forces in other orders, and the f32
    Cholesky solve of the coupled system (its condition number ~1e4 on
    snakey6) turns their rounding into ~3e-5 in the joint velocities
    (measured on the CPU); morphy and the fixed base agree to ~2e-7;
  * twenty env steps (100 substeps of snakey6 at the 2 ms dt, motor
    thrusts and joint velocity targets): pose and joint angles 1e-4,
    velocities 1e-3 (the rounding of one substep carried on);
  * the decoupled joint path: 1e-6 (the same elementwise formulas);
  * ground truths: the bars of tests/test_articulated.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.assets.articulation import parse_articulation as j_parse
from aerial_gym_simulator_tpu.config.robot_config import catalog as j_catalog
from aerial_gym_simulator_tpu.registry.registries import (
    controller_registry as j_ctrl, env_config_registry as j_env, sim_config_registry as j_sim)
from aerial_gym_simulator_tpu.sim import articulated as ja
from aerial_gym_simulator_tpu.sim import dynamics as jd
from aerial_gym_simulator_tpu.sim.params import build_sim_params as j_build_sim_params
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.assets.articulation import parse_articulation as t_parse
from aerial_gym_simulator_tpu_torch.config.robot_config import catalog as t_catalog
from aerial_gym_simulator_tpu_torch.config.robot_config import reconfigurable_urdf as t_urdf
from aerial_gym_simulator_tpu_torch.config.robot_config.base_quad_config import (
    ControlAllocatorConfig, MotorModelConfig, ReconfigurationConfig, RobotConfig)
from aerial_gym_simulator_tpu_torch.registry.registries import (
    controller_registry as t_ctrl, env_config_registry as t_env, sim_config_registry as t_sim)
from aerial_gym_simulator_tpu_torch.sim import articulated as ta
from aerial_gym_simulator_tpu_torch.sim import dynamics as td
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)
from aerial_gym_simulator_tpu_torch.sim.params import build_sim_params, initial_state
from aerial_gym_simulator_tpu_torch.sim.structs import replace
from aerial_gym_simulator_tpu_torch.utils.math import quat_to_rotation_matrix

N = 8
T = torch.from_numpy
ROBOTS = ("snakey", "snakey5", "snakey6", "morphy")


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Thousands of tiny eager ops: one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves_match(port_rec, ref_rec, path=""):
    if isinstance(ref_rec, dict):
        assert set(port_rec) == set(ref_rec), path
        for k, v in ref_rec.items():
            _leaves_match(port_rec[k], v, f"{path}.{k}")
        return
    if ref_rec is None or isinstance(ref_rec, (bool, str)):
        assert port_rec == ref_rec, path
        return
    p, r = np.asarray(port_rec), np.asarray(ref_rec)
    assert p.shape == r.shape, (path, p.shape, r.shape)
    if r.dtype.kind in "iub" or p.dtype.kind in "iub":
        np.testing.assert_array_equal(p, r, err_msg=path)
    else:
        np.testing.assert_allclose(p, r, atol=1e-6, rtol=0, err_msg=path)


# ---------------------------------------------------------------------------
# trees and parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("robot", ROBOTS)
def test_parse_articulation_matches_jax(robot):
    jcfg, tcfg = getattr(j_catalog, robot)(), getattr(t_catalog, robot)()
    assert tcfg.articulation_urdf == jcfg.articulation_urdf
    got, want = t_parse(tcfg.articulation_urdf), j_parse(jcfg.articulation_urdf)
    assert (got.nb, got.parent, got.joint_names, got.motor_body) == \
        (want.nb, want.parent, want.joint_names, want.motor_body)
    for f in ("R_tree", "t_tree", "axis", "lower", "upper", "effort", "velocity", "mass",
              "com", "inertia", "base_com", "base_inertia", "motor_pos", "motor_dir"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.base_mass == want.base_mass and got.total_mass == want.total_mass
    assert got.nb == tcfg.dof_config.num_dofs
    assert len(got.motor_body) == tcfg.control_allocator_config.num_motors


@pytest.mark.parametrize("robot", ROBOTS + ("morphy_stiff", "morphy_fixed_base"))
def test_build_art_and_dof_params_match_jax(robot):
    """build_art_params / build_dof_params through build_sim_params, field
    by field, and params_from_numpy carrying the JAX build across to the
    same record (statics included)."""
    names = ("base_sim_2ms", "empty_env_2ms", robot, "no_control")
    jp = j_build_sim_params(j_sim.make(names[0]), j_env.make(names[1]),
                            j_catalog.__dict__[robot](), j_ctrl.make(names[3]), num_envs=4)
    tp = build_sim_params(t_sim.make(names[0]), t_env.make(names[1]),
                          t_catalog.__dict__[robot](), t_ctrl.make(names[3]), "cpu", num_envs=4)
    carried = params_from_numpy(record_to_numpy(jp), "cpu")
    assert (tp.art is None) == (jp.art is None) and (tp.dof is None) == (jp.dof is None)
    for part in ("art", "dof", "robot", "motor"):
        _leaves_match(record_to_numpy(getattr(tp, part)), record_to_numpy(getattr(jp, part)),
                      part)
        _leaves_match(record_to_numpy(getattr(carried, part)),
                      record_to_numpy(getattr(tp, part)), part)
    if tp.art is not None:
        assert isinstance(carried.art.parent, tuple) and carried.art.parent == tp.art.parent
        assert carried.art.motor_body == tp.art.motor_body and carried.art.nb == tp.art.nb
        # the URDF's limits override the config's
        urdf = t_parse(t_catalog.__dict__[robot]().articulation_urdf)
        np.testing.assert_allclose(tp.dof.lower_limit.numpy(), urdf.lower, rtol=1e-7)
        np.testing.assert_allclose(tp.dof.max_velocity.numpy(), urdf.velocity, rtol=1e-7)
    state = initial_state(tp, seed=0)
    D = tp.dof.num_dofs if tp.dof is not None else 0
    assert state.dof_pos.shape == state.dof_vel_target.shape == (4, D)


def test_build_art_params_checks_the_urdf_against_the_config():
    cfg = t_catalog.snakey6()
    cfg.dof_config.init_state_min = [[0.0] * 9, [0.0] * 9]
    with pytest.raises(ValueError, match="revolute joints"):
        build_sim_params(t_sim.make("base_sim"), t_env.make("empty_env"), cfg,
                         t_ctrl.make("no_control"), "cpu", num_envs=2)
    cfg = t_catalog.snakey()
    cfg.control_allocator_config.num_motors = 5
    with pytest.raises(ValueError, match="motor links"):
        build_sim_params(t_sim.make("base_sim"), t_env.make("empty_env"), cfg,
                         t_ctrl.make("no_control"), "cpu", num_envs=2)


# ---------------------------------------------------------------------------
# the coupled solver against JAX from a carried-across state
# ---------------------------------------------------------------------------


def _jax_env(robot, sim, env="empty_env", seed=1):
    jenv = JSimBuilder().build_env(sim, env, robot, "no_control", num_envs=N, seed=seed)
    jenv.reset()
    jp = jenv.params.replace(robot=jenv.params.robot.replace(enable_disturbance=False))
    return jenv, jp


def _moving_state(js, jp, rs):
    """Joints inside their limits and in motion, targets set, the base spinning."""
    D = jp.dof.num_dofs
    lo, hi = np.asarray(jp.dof.lower_limit), np.asarray(jp.dof.upper_limit)
    f = lambda x: jnp.asarray(x, jnp.float32)
    return js.replace(dof_pos=f(rs.uniform(0.8 * lo, 0.8 * hi, (N, D))),
                      dof_vel=f(rs.uniform(-1.0, 1.0, (N, D))),
                      dof_vel_target=f(rs.uniform(-1.0, 1.0, (N, D))),
                      dof_pos_target=f(rs.uniform(-0.2, 0.2, (N, D))),
                      angvel=f(rs.uniform(-1.0, 1.0, (N, 3))),
                      linvel=f(rs.uniform(-1.0, 1.0, (N, 3))))


@pytest.mark.parametrize("robot,sim", [("snakey6", "base_sim_2ms"), ("morphy", "base_sim_2ms"),
                                       ("morphy_fixed_base", "base_sim")])
def test_articulated_substep_matches_jax(robot, sim):
    jenv, jp = _jax_env(robot, sim)
    rs = np.random.RandomState(0)
    js = _moving_state(jenv.state, jp, rs)
    M = jp.motor.num_motors
    force = rs.uniform(-0.5, 0.5, (N, 3)).astype(np.float32)
    torque = rs.uniform(-0.02, 0.02, (N, 3)).astype(np.float32)
    thrust = rs.uniform(0.0, 3.0, (N, M)).astype(np.float32)
    jo = jax.jit(lambda s, a, b, c: ja.articulated_substep(jp, s, a, b, c))(
        js, jnp.asarray(force), jnp.asarray(torque), jnp.asarray(thrust))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    to = ta.articulated_substep(tp, ts, T(force), T(torque), T(thrust))
    for f, atol in (("pos", 1e-6), ("quat", 1e-6), ("dof_pos", 1e-6), ("linvel", 1e-4),
                    ("angvel", 1e-4), ("dof_vel", 1e-4)):
        np.testing.assert_allclose(getattr(to, f).numpy(), np.asarray(getattr(jo, f)),
                                   atol=atol, rtol=0, err_msg=f)
    spec = np.asarray(jo.applied_force_b)
    np.testing.assert_allclose(to.applied_force_b.numpy(), spec,
                               atol=1e-4 * np.abs(spec).max(), rtol=0)
    assert float((to.dof_vel - ts.dof_vel).abs().max()) > 1e-3      # the joints accelerate
    if robot == "morphy_fixed_base":
        assert torch.equal(to.pos, ts.pos) and float(to.linvel.abs().max()) == 0.0


def test_twenty_env_steps_match_jax():
    """snakey6 at the 2 ms dt (5 substeps a step) with thrusts and joint
    velocity targets, stepped 20 times by each package's env_step."""
    jenv, jp = _jax_env("snakey6", "base_sim_2ms", "empty_env_2ms", seed=2)
    rs = np.random.RandomState(3)
    js = _moving_state(jenv.state, jp, rs)
    js = js.replace(pos=js.pos + jnp.array([0.0, 0.0, 3.0]))       # clear of the bounds
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    step = jax.jit(lambda s, a: jd.env_step(jp, s, a))
    for k in range(20):
        a = rs.uniform(2.0, 4.0, (N, 6)).astype(np.float32)
        targets = rs.uniform(-0.5, 0.5, (N, 10)).astype(np.float32)
        js = step(js.replace(dof_vel_target=jnp.asarray(targets)), jnp.asarray(a))
        ts = td.env_step(tp, replace(ts, dof_vel_target=T(targets)), T(a))
    for f, atol in (("pos", 1e-4), ("quat", 1e-4), ("dof_pos", 1e-4), ("linvel", 1e-3),
                    ("angvel", 1e-3), ("dof_vel", 1e-3), ("motor_thrust", 1e-4)):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=atol, rtol=0, err_msg=f)
    np.testing.assert_array_equal(ts.crashes.numpy(), np.asarray(js.crashes))
    assert torch.isfinite(ts.pos).all()


@pytest.mark.parametrize("robot,mode", [("morphy", None), ("morphy", "pd"),
                                        ("snakey", None), ("snakey", "position")])
def test_integrate_dofs_matches_jax(robot, mode):
    """A robot with joints and no articulation URDF: the decoupled joint
    path (morphy's arm response, effort PD, velocity and position drives)."""
    def cfg(catalog):
        c = getattr(catalog, robot)()
        c.articulation_urdf = None
        if mode == "pd":
            c.dof_config.arm_response = "pd"
        elif mode == "position":
            c.dof_config.dof_mode = "position"
            c.dof_config.stiffness = [2.0] * c.dof_config.num_dofs
        return c
    jp = j_build_sim_params(j_sim.make("base_sim"), j_env.make("empty_env"), cfg(j_catalog),
                            j_ctrl.make("no_control"), num_envs=N)
    tp = build_sim_params(t_sim.make("base_sim"), t_env.make("empty_env"), cfg(t_catalog),
                          t_ctrl.make("no_control"), "cpu", num_envs=N)
    assert jp.art is None and tp.art is None and tp.dof.num_dofs == jp.dof.num_dofs
    _leaves_match(record_to_numpy(tp.dof), record_to_numpy(jp.dof))
    from aerial_gym_simulator_tpu.sim.params import initial_state as j_initial_state
    rs = np.random.RandomState(4)
    js = _moving_state(j_initial_state(jp, seed=0), jp, rs)
    js = js.replace(dof_pos=js.dof_pos * 1.2)                      # some past the stops
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    step = jax.jit(lambda s: jd.integrate_dofs(jp, s))
    for _ in range(10):
        js = step(js)
        ts = td.integrate_dofs(tp, ts)
    for f in ("dof_pos", "dof_vel"):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=1e-6, rtol=0, err_msg=f)
    lo, hi = tp.dof.lower_limit, tp.dof.upper_limit
    assert bool(((ts.dof_pos >= lo) & (ts.dof_pos <= hi)).all())


def test_reset_draws_the_joints_and_the_setters_write_the_targets():
    env = port.SimBuilder().build_env("base_sim", "empty_env", "snakey6", "no_control",
                                      device="cpu", num_envs=256, seed=5)
    dp, st = env.params.dof, env.state
    assert st.dof_pos.shape == (256, 10)
    for x, lo, hi in ((st.dof_pos, dp.init_pos_min, dp.init_pos_max),
                      (st.dof_vel, dp.init_vel_min, dp.init_vel_max)):
        assert bool(((x >= lo) & (x <= hi)).all())
        # spread over the range, not a constant
        assert bool((x.max(0).values - x.min(0).values > 0.8 * (hi - lo)).all())
    assert float(st.dof_pos_target.abs().max()) == float(st.dof_vel_target.abs().max()) == 0.0
    env.robot_manager.robot.set_dof_velocity_targets([0.3] * 10)
    env.robot_manager.robot.set_dof_position_targets(torch.full((256, 10), -0.1))
    assert torch.equal(env.state.dof_vel_target, torch.full((256, 10), 0.3))
    assert torch.equal(env.state.dof_pos_target, torch.full((256, 10), -0.1))
    fixed = port.SimBuilder().build_env("base_sim", "empty_env", "morphy_fixed_base",
                                        "no_control", device="cpu", num_envs=4)
    assert torch.equal(fixed.state.dof_pos, torch.tensor([0.29, 0.0] * 4).expand(4, 8))


# ---------------------------------------------------------------------------
# the port alone against ground truths
# ---------------------------------------------------------------------------

_PENDULUM_URDF = """<?xml version="1.0"?>
<robot name="pendulum">
  <link name="base_link">
    <inertial><origin xyz="0 0 0" rpy="0 0 0"/><mass value="0.5"/>
      <inertia ixx="0.001" ixy="0" ixz="0" iyy="0.001" iyz="0" izz="0.001"/>
    </inertial>
  </link>
  <link name="motor0">
    <inertial><origin xyz="0 0 0" rpy="0 0 0"/><mass value="0.0"/>
      <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/>
    </inertial>
  </link>
  <joint name="base_to_motor0" type="fixed">
    <parent link="base_link"/><child link="motor0"/>
    <origin xyz="0 0 0" rpy="0 0 0"/>
  </joint>
  <link name="bob">
    <inertial><origin xyz="0.3 0 0" rpy="0 0 0"/><mass value="0.2"/>
      <inertia ixx="0" ixy="0" ixz="0" iyy="0" iyz="0" izz="0"/>
    </inertial>
  </link>
  <joint name="hinge" type="revolute">
    <parent link="base_link"/><child link="bob"/>
    <origin xyz="0 0 0" rpy="0 0 0"/>
    <axis xyz="0 1 0"/>
    <limit lower="-9.0" upper="9.0" effort="100.0" velocity="100.0"/>
  </joint>
</robot>
"""


def _build(robot_cfg, sim_name="base_sim", num_envs=2):
    ctrl = t_ctrl.make("no_control")
    ctrl.num_actions = robot_cfg.control_allocator_config.num_motors
    params = build_sim_params(t_sim.make(sim_name), t_env.make("empty_env"), robot_cfg, ctrl,
                              "cpu", num_envs=num_envs)
    return params, initial_state(params, seed=0)


def test_pendulum_matches_the_ode():
    """A fixed-base 1-DoF pendulum against theta_dd = m g l cos(theta) /
    (m l^2 + armature) under the same symplectic Euler scheme."""
    armature = 1e-4
    cfg = RobotConfig(name="pendulum")
    cfg.control_allocator_config = ControlAllocatorConfig(
        num_motors=1, application_mask=[1], motor_directions=[1],
        allocation_matrix=[[0.0]] * 6,
        motor_model_config=MotorModelConfig(use_rps=False, max_thrust=0.0, min_thrust=0.0))
    cfg.dof_config = ReconfigurationConfig(
        dof_mode="effort", arm_response="pd", init_state_min=[[0.0], [0.0]],
        init_state_max=[[0.0], [0.0]], stiffness=[0.0], damping=[0.0],
        dof_inertia=[0.2 * 0.09])
    cfg.articulation_urdf = _PENDULUM_URDF
    cfg.robot_asset.fix_base_link = True
    cfg.robot_asset.armature = armature
    params, state = _build(cfg)
    state = replace(state, pos=state.pos + torch.tensor([0.0, 0.0, 5.0]))
    dt, m, l, g = params.dt, 0.2, 0.3, 9.81
    traj = []
    for _ in range(300):
        state = td.env_step(params, state, torch.zeros(2, 1))
        traj.append(state.dof_pos[:, 0].numpy().copy())
    traj = np.stack(traj)
    assert np.isfinite(traj).all()
    np.testing.assert_allclose(traj[:, 0], traj[:, 1])
    th, thd, ref = 0.0, 0.0, []
    for _ in range(300):
        thd += dt * (m * g * l * math.cos(th)) / (m * l * l + armature)
        th += dt * thd
        ref.append(th)
    np.testing.assert_allclose(traj[:, 0], np.array(ref), atol=2e-3)
    assert np.abs(traj).max() > 0.5


def _rot_axis_np(axis, q):
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]], [-axis[1], axis[0], 0]])
    return np.eye(3) + math.sin(q) * K + (1 - math.cos(q)) * (K @ K)


def _total_momentum_np(model, quat, pos, linvel, angvel, q, qd):
    """Independent forward kinematics: total linear momentum and angular
    momentum about the world origin of the base and every moving body."""
    Rb = quat_to_rotation_matrix(torch.tensor(quat, dtype=torch.float64)).numpy()
    c_rel = Rb @ model.base_com
    P = model.base_mass * (linvel + np.cross(angvel, c_rel))
    L = (Rb @ model.base_inertia @ Rb.T @ angvel
         + model.base_mass * np.cross(pos + c_rel, linvel + np.cross(angvel, c_rel)))
    R, o, w, v = {-1: Rb}, {-1: pos}, {-1: angvel}, {-1: linvel}
    for i in range(model.nb):
        p = model.parent[i]
        o[i] = o[p] + R[p] @ model.t_tree[i]
        v[i] = v[p] + np.cross(w[p], R[p] @ model.t_tree[i])
        R[i] = R[p] @ model.R_tree[i] @ _rot_axis_np(model.axis[i], q[i])
        w[i] = w[p] + R[i] @ (model.axis[i] * qd[i])
        c_w = o[i] + R[i] @ model.com[i]
        v_c = v[i] + np.cross(w[i], R[i] @ model.com[i])
        P = P + model.mass[i] * v_c
        L = L + R[i] @ model.inertia[i] @ R[i].T @ w[i] + model.mass[i] * np.cross(c_w, v_c)
    return P, L


def test_free_floating_momentum_is_conserved():
    """No gravity, thrust or engine damping: joint motion under the drives
    (internal forces) conserves the total linear and angular momentum."""
    cfg = t_catalog.snakey()
    cfg.disturbance.enable_disturbance = False
    cfg.robot_asset.linear_damping = 0.0
    cfg.robot_asset.angular_damping = 0.0
    params, state = _build(cfg, sim_name="base_sim_no_gravity", num_envs=1)
    model = t_parse(cfg.articulation_urdf)
    q0 = torch.tensor([[0.4, 0.1, -0.3, 0.2, 0.5, -0.1]])
    qd0 = torch.tensor([[0.2, -0.15, 0.2, 0.1, -0.2, 0.15]])
    state = replace(state, pos=torch.tensor([[0.0, 0.0, 5.0]]),
                    linvel=torch.tensor([[0.2, -0.1, 0.15]]),
                    angvel=torch.tensor([[0.1, 0.2, -0.15]]),
                    dof_pos=q0, dof_vel=qd0, dof_vel_target=qd0)

    def mom(s):
        f = lambda x: x[0].double().numpy()
        return _total_momentum_np(model, f(s.quat), f(s.pos), f(s.linvel), f(s.angvel),
                                  f(s.dof_pos), f(s.dof_vel))

    P0, L0 = mom(state)
    for _ in range(50):
        state = td.env_step(params, state, torch.zeros(1, 4))
    P1, L1 = mom(state)
    assert float((state.dof_pos - q0).abs().max()) > 0.05
    np.testing.assert_allclose(P1, P0, atol=2e-3)
    np.testing.assert_allclose(L1, L0, atol=2e-2)
    assert torch.isfinite(state.pos).all()


def test_deflected_arm_torques_the_base():
    """Equal thrusts: the symmetric morphy stays level; with one arm
    deflected its motor moves, and the same thrusts torque the base."""
    cfg = t_catalog.morphy()
    cfg.disturbance.enable_disturbance = False
    cfg.robot_asset.linear_damping = 0.0
    cfg.robot_asset.angular_damping = 0.0
    params, state = _build(cfg, sim_name="base_sim_no_gravity")
    dof = state.dof_pos.clone()
    dof[1, 0] = 0.24
    state = replace(state, pos=state.pos + torch.tensor([0.0, 0.0, 5.0]), dof_pos=dof)
    thrust = torch.full((2, 4), 0.6)
    for _ in range(20):
        state = td.env_step(params, state, thrust)
    w = state.angvel.numpy()
    assert np.linalg.norm(w[1]) > 5.0 * max(np.linalg.norm(w[0]), 1e-3), w


def test_fixed_base_arms_settle_under_gravity():
    """morphy_fixed_base's arms released at 0.29 rad settle inside the URDF
    limits, the base clamped."""
    params, state = _build(t_catalog.morphy_fixed_base(), num_envs=1)
    state = replace(state, dof_pos=torch.tensor([[0.29, 0.0] * 4]))
    for _ in range(300):
        state = td.env_step(params, state, torch.zeros(1, 4))
    q, qd = state.dof_pos, state.dof_vel
    assert torch.isfinite(q).all() and torch.isfinite(qd).all()
    assert float(qd.abs().max()) < 0.2
    assert float(q.abs().max()) <= 0.25 + 1e-5
    assert float(state.linvel.abs().max()) == 0.0


def test_snakey6_flies_inside_its_joint_limits():
    cfg = t_catalog.snakey6()
    cfg.disturbance.enable_disturbance = False
    params, state = _build(cfg)
    state = replace(state, pos=state.pos + torch.tensor([0.0, 0.0, 5.0]))
    z0 = state.pos[:, 2].clone()
    for _ in range(50):
        state = td.env_step(params, state, torch.full((2, 6), 3.2))
    assert torch.isfinite(state.pos).all() and torch.isfinite(state.dof_pos).all()
    lo, hi = params.dof.lower_limit - 1e-5, params.dof.upper_limit + 1e-5
    assert bool(((state.dof_pos >= lo) & (state.dof_pos <= hi)).all())
    assert float((state.pos[:, 2] - z0).abs().max()) > 1e-3           # the thrust moves it
