"""Port parity for the robots and controllers of the position-task variants,
the 8-motor family, the articulated robots and the IMU quads: the rates,
steering-angle and fully-actuated controllers, ``no_control`` through the
robot wrench (an articulated robot's without the motors' net wrench), each
new robot's parameters (joints, articulation and IMU included), the sim/env/controller registrations, five steps of the
octarotor, ROV and random 8-motor robots from a carried-across state, the
reversible motors, and the ROV's zero damping and gravity compensation.

Tolerances:
  * wrench and motor thrusts on the same inputs: atol 1e-5 (the bar of
    tests/test_torch_control.py);
  * built parameters: integer and bool leaves exact, float leaves 1e-6;
  * five env steps from a carried-across state (wrench disturbance off):
    pose and linear velocity 1e-4, body rates and motor thrusts 5e-3 (the
    drift bars of tests/test_torch_dynamics.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aerial_gym_simulator_tpu as ag  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.control import controllers as jc
from aerial_gym_simulator_tpu.registry.registries import (
    controller_registry as j_ctrl, env_config_registry as j_env,
    robot_registry as j_robot, sim_config_registry as j_sim)
from aerial_gym_simulator_tpu.sim import dynamics as jd
from aerial_gym_simulator_tpu.sim.params import build_sim_params as j_build_sim_params
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.control import controllers as tc
from aerial_gym_simulator_tpu_torch.registry.registries import (
    controller_registry as t_ctrl, env_config_registry as t_env,
    robot_registry as t_robot, sim_config_registry as t_sim)
from aerial_gym_simulator_tpu_torch.sim import dynamics as td
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)
from aerial_gym_simulator_tpu_torch.sim.params import build_sim_params as t_build_sim_params
from aerial_gym_simulator_tpu_torch.sim.structs import replace

N = 16
ATOL = 1e-5
NEW_ROBOTS = ("tinyprop", "x500", "lmf1", "base_octarotor", "base_rov", "base_random",
              "base_quad_root_link_control", "snakey", "snakey5", "snakey6", "morphy",
              "morphy_stiff", "morphy_fixed_base", "base_quadrotor_with_imu",
              "base_quadrotor_with_camera_imu")
T = torch.from_numpy


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Thousands of tiny eager ops: one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves_match(port_rec, ref_rec, path=""):
    if isinstance(ref_rec, dict):
        for k, v in ref_rec.items():
            _leaves_match(port_rec[k], v, f"{path}.{k}")
        return
    if ref_rec is None or isinstance(ref_rec, (bool, str)):
        assert port_rec == ref_rec, path
        return
    p, r = np.asarray(port_rec), np.asarray(ref_rec)
    assert p.shape == r.shape, (path, p.shape, r.shape)
    if r.dtype.kind in "iub":
        np.testing.assert_array_equal(p, r, err_msg=path)
    else:
        np.testing.assert_allclose(p, r, atol=1e-6, rtol=0, err_msg=path)


def _params(robot, controller, env="empty_env", sim="base_sim", num_envs=N):
    jp = j_build_sim_params(j_sim.make(sim), j_env.make(env), j_robot.make(robot),
                            j_ctrl.make(controller), num_envs=num_envs)
    return jp, params_from_numpy(record_to_numpy(jp), "cpu")


def _random_state(rs, n=N):
    q = rs.normal(size=(n, 4)).astype(np.float32)
    q[:, 3] += 3.0                                  # mostly upright
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    lin = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    ang = rs.uniform(-2, 2, (n, 3)).astype(np.float32)
    gains = [rs.uniform(0.1, 3.0, (n, 3)).astype(np.float32) for _ in range(4)]
    return pos, q, lin, ang, gains


# ---------------------------------------------------------------------------
# controllers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("robot,controller,num_actions", [
    ("base_quadrotor", "lee_rates_control", 4),
    ("lmf2", "lmf2_rates_control", 4),
    ("base_quadrotor", "lee_velocity_steering_angle_control", 4),
    ("base_rov", "rov_fully_actuated_control", 7),
    ("base_octarotor", "octarotor_position_control", 4),
])
def test_new_controllers_match_jax(robot, controller, num_actions):
    jp, tp = _params(robot, controller)
    assert tp.controller.name == jp.controller.name
    assert tp.controller.num_actions == jp.controller.num_actions == num_actions
    rs = np.random.RandomState(31)
    pos, q, lin, ang, gains = _random_state(rs)
    action = rs.uniform(-1.5, 1.5, (N, num_actions)).astype(np.float32)
    j_obs = jc.compute_robot_obs(*(jnp.asarray(x) for x in (pos, q, lin, ang)))
    j_w = jc.controller_update(jp.controller.name, jp.controller, jp.robot, jp.gravity, j_obs,
                               jc.Gains(*(jnp.asarray(g) for g in gains)), jnp.asarray(action))
    t_obs = tc.compute_robot_obs(*(T(x) for x in (pos, q, lin, ang)))
    t_w = tc.controller_update(tp.controller.name, tp.controller, tp.robot, tp.gravity, t_obs,
                               tc.Gains(*(T(g) for g in gains)), T(action))
    assert t_w.shape == (N, 6)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=ATOL, rtol=0)
    if controller == "rov_fully_actuated_control":
        assert (t_w[:, :2].abs() > 1e-3).any()      # a full body force, not z-thrust only
        with pytest.raises(ValueError, match="7 actions"):
            tc.controller_update(tp.controller.name, tp.controller, tp.robot, tp.gravity,
                                 t_obs, tc.Gains(*(T(g) for g in gains)), T(action[:, :4]))
    with pytest.raises(ValueError, match="no_control"):
        tc.controller_update("no_control", tp.controller, tp.robot, tp.gravity, t_obs,
                             tc.Gains(*(T(g) for g in gains)), T(action))


# ---------------------------------------------------------------------------
# no_control and the reversible motors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("robot", ["tinyprop", "x500", "base_octarotor", "snakey6"])
def test_no_control_wrench_matches_jax(robot):
    """Actions are the motor thrust references: the clipped action goes
    through the motor model, not the controller and the allocation pinv.
    An articulated robot's wrench leaves the motors out (the coupled solver
    applies each thrust on its link): drag only."""
    jenv = JSimBuilder().build_env("base_sim", "empty_env", robot, "no_control", num_envs=N,
                                   seed=2)
    jenv.reset()
    jp = jenv.params.replace(robot=jenv.params.robot.replace(enable_disturbance=False))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(jenv.state), "cpu")
    M = tp.motor.num_motors
    assert tp.controller.name == "no_control" and tp.controller.num_actions == M
    rs = np.random.RandomState(32)
    lo, hi = tp.motor.min_thrust, tp.motor.max_thrust
    action = rs.uniform(lo - 1.0, hi + 1.0, (N, M)).astype(np.float32)   # some clamped
    art = tp.art is not None
    jf, jt, jth = jd.compute_robot_wrench(jp, jenv.state, jnp.asarray(action),
                                          jax.random.PRNGKey(0), include_motor_wrench=not art)
    tf, tt, tth = td.compute_robot_wrench(tp, ts, T(action), include_motor_wrench=not art)
    for got, want in ((tf, jf), (tt, jt), (tth, jth)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)
    assert torch.isfinite(tth).all()
    if robot == "base_octarotor":
        assert lo < 0 and not tp.motor.use_rps
        assert (tth < 0).any() and (tth >= lo).all()  # reversing motors


def test_reversing_motors_match_jax_over_substeps():
    """8 reversible motors commanded to flip sign every few substeps: the
    decreasing time constant engages on each reversal; thrusts stay finite
    and inside [min, max], equal to JAX's."""
    jenv = JSimBuilder().build_env("base_sim", "empty_env", "base_random", "no_control",
                                   num_envs=N, seed=3)
    jenv.reset()
    jp = jenv.params.replace(robot=jenv.params.robot.replace(enable_disturbance=False))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    js = jenv.state
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    step = jax.jit(lambda s, a: jd.env_step(jp, s, a))
    rs = np.random.RandomState(33)
    base = rs.uniform(1.0, 4.0, (N, 8)).astype(np.float32)
    for k in range(6):
        a = base * (1.0 if k % 2 == 0 else -1.0)
        js = step(js, jnp.asarray(a))
        ts = td.env_step(tp, ts, T(a))
        np.testing.assert_allclose(ts.motor_thrust.numpy(), np.asarray(js.motor_thrust),
                                   atol=5e-3, rtol=0)
    assert (ts.motor_thrust.abs() <= tp.motor.max_thrust).all()
    assert torch.isfinite(ts.pos).all()


# ---------------------------------------------------------------------------
# parameters and registration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("robot", NEW_ROBOTS)
def test_new_robot_params_match_jax(robot):
    ctrl = "no_control"
    jp = j_build_sim_params(j_sim.make("base_sim"), j_env.make("empty_env"),
                            j_robot.make(robot), j_ctrl.make(ctrl), num_envs=4)
    tp = t_build_sim_params(t_sim.make("base_sim"), t_env.make("empty_env"),
                            t_robot.make(robot), t_ctrl.make(ctrl), "cpu", num_envs=4)
    for part in ("robot", "motor", "dof", "art", "imu"):
        _leaves_match(record_to_numpy(getattr(tp, part)), record_to_numpy(getattr(jp, part)),
                      part)
    assert (tp.imu is not None) == robot.endswith("_imu")
    assert (tp.art is not None) == (robot.startswith(("snakey", "morphy"))
                                    and robot != "morphy_stiff")
    M = tp.motor.num_motors
    assert tp.motor.allocation_matrix.shape == (6, M)
    if M == 8:
        assert np.linalg.matrix_rank(tp.motor.allocation_matrix.numpy()) == 6
        assert tp.motor.min_thrust == -tp.motor.max_thrust and not tp.motor.use_rps


def test_x500_and_lmf1_use_the_continuous_motor_model():
    for robot in ("x500", "lmf1"):
        cfg = t_robot.make(robot)
        ca = cfg.control_allocator_config
        assert ca.application_mask == [4, 1, 3, 2]
        assert not ca.motor_model_config.use_discrete_approximation


def test_sim_env_and_controller_registrations_match_jax():
    for name in ("base_sim", "base_sim_headless", "base_sim_2ms", "base_sim_4ms",
                 "base_sim_no_gravity"):
        j, t = j_sim.make(name), t_sim.make(name)
        assert (t.dt, tuple(t.gravity), t.substeps, t.integrator) == \
            (j.dt, tuple(j.gravity), j.substeps, j.integrator), name
    for name in ("empty_env", "empty_env_2ms"):
        j, t = j_env.make(name), t_env.make(name)
        assert (t.num_physics_steps_per_env_step_mean, t.num_physics_steps_per_env_step_std) \
            == (j.num_physics_steps_per_env_step_mean, j.num_physics_steps_per_env_step_std)
    names = set(j_ctrl.get_names())
    assert names == set(t_ctrl.get_names())
    for name in sorted(names):
        j, t = j_ctrl.make(name), t_ctrl.make(name)
        for f in ("name", "base_controller", "num_actions", "K_pos_tensor_min",
                  "K_pos_tensor_max", "K_vel_tensor_min", "K_vel_tensor_max",
                  "K_rot_tensor_min", "K_rot_tensor_max", "K_angvel_tensor_min",
                  "K_angvel_tensor_max", "randomize_params", "max_yaw_rate"):
            if (name, f) == ("fully_actuated_control", "num_actions"):
                # the JAX package registers 4, a width its controller cannot read
                assert (t.num_actions, j.num_actions) == (7, 4)
                continue
            assert getattr(t, f) == getattr(j, f), (name, f)
    assert set(NEW_ROBOTS) <= set(t_robot.get_names())


def test_no_gravity_and_2ms_sims_step():
    env = port.SimBuilder().build_env("base_sim_no_gravity", "empty_env_2ms", "base_quadrotor",
                                      "no_control", device="cpu", num_envs=4)
    env.reset()
    s0 = env.state
    z0 = s0.pos[:, 2].clone()
    s = s0
    quiet = replace(env.params, robot=replace(env.params.robot, enable_disturbance=False))
    s = replace(s, linvel=torch.zeros_like(s.linvel), angvel=torch.zeros_like(s.angvel),
                motor_thrust=torch.zeros_like(s.motor_thrust))
    s = td.env_step(quiet, s, torch.zeros(4, 4))
    assert env.params.env.substep_mean == 5 and env.params.dt == np.float32(0.01)
    assert torch.allclose(s.pos[:, 2], z0, atol=1e-6)   # no gravity, no thrust: no fall


# ---------------------------------------------------------------------------
# the 8-motor robots stepped from a carried-across state
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("robot,controller", [
    ("base_octarotor", "lee_position_control"),
    ("base_rov", "rov_fully_actuated_control"),
    ("base_random", "lee_position_control"),
])
def test_eight_motor_robots_step_like_jax(robot, controller):
    jenv = JSimBuilder().build_env("base_sim", "empty_env", robot, controller, num_envs=N,
                                   seed=4)
    jenv.reset()
    jp = jenv.params.replace(robot=jenv.params.robot.replace(enable_disturbance=False))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    js = jenv.state
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    A = tp.controller.num_actions
    rs = np.random.RandomState(34)
    step = jax.jit(lambda s, a: jd.env_step(jp, s, a))
    for _ in range(5):
        a = rs.uniform(-0.5, 0.5, (N, A)).astype(np.float32)
        if A == 7:
            a[:, 3:7] = np.array([0.0, 0.0, 0.0, 1.0]) + 0.1 * a[:, 3:7]
        js = step(js, jnp.asarray(a))
        ts = td.env_step(tp, ts, T(a))
    for f, atol in (("pos", 1e-4), ("quat", 1e-4), ("linvel", 1e-4), ("angvel", 5e-3),
                    ("motor_thrust", 5e-3)):
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=atol, rtol=0, err_msg=f)
    np.testing.assert_array_equal(ts.crashes.numpy(), np.asarray(js.crashes))
    assert torch.isfinite(ts.pos).all()


@pytest.mark.parametrize("controller", ["fully_actuated_control",
                                        "rov_fully_actuated_control"])
def test_fully_actuated_names_build_an_rov_that_steps(controller):
    n = 4
    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_rov", controller,
                                      device="cpu", num_envs=n)
    env.reset()
    assert env.params.controller.num_actions == 7
    hold = torch.tensor([0.5, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]).expand(n, 7)
    s = env.state
    for _ in range(5):
        s = td.env_step(env.params, s, hold)
    assert torch.isfinite(s.pos).all() and torch.isfinite(s.motor_thrust).all()


def test_rov_damping_is_zero_and_the_controller_compensates_gravity():
    """The ROV's shipped hydrodynamic damping is zero, so a surge persists
    (a damped copy decays it), and the fully-actuated controller holding
    its pose keeps it from sinking under gravity."""
    n = 4
    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_rov", "no_control",
                                      device="cpu", num_envs=n)
    env.reset()
    assert float(env.params.gravity[2]) < 0 and not env.params.robot.disable_gravity
    for d in ("drag_lin_linear", "drag_lin_quadratic", "drag_ang_linear",
              "drag_ang_quadratic"):
        assert not getattr(env.params.robot, d).any(), d

    def at_rest(state, linvel):
        return replace(state, pos=torch.zeros(n, 3),
                       quat=torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(n, 4).clone(),
                       linvel=torch.tensor(linvel).expand(n, 3).clone(),
                       angvel=torch.zeros(n, 3),
                       motor_thrust=torch.zeros_like(state.motor_thrust))

    s = at_rest(env.state, [1.0, 0.0, 0.0])
    for _ in range(50):
        s = td.env_step(env.params, s, torch.zeros(n, 8))
    assert float(s.linvel[:, 0].max()) > 0.9

    damped = replace(env.params, robot=replace(env.params.robot,
                                               drag_lin_linear=torch.ones(3),
                                               drag_lin_quadratic=torch.ones(3)))
    s = at_rest(env.state, [1.0, 0.0, 0.0])
    for _ in range(50):
        s = td.env_step(damped, s, torch.zeros(n, 8))
    assert float(s.linvel[:, 0].max()) < 0.75

    env2 = port.SimBuilder().build_env("base_sim", "empty_env", "base_rov",
                                       "rov_fully_actuated_control", device="cpu", num_envs=n)
    env2.reset()
    s = at_rest(env2.state, [0.0, 0.0, 0.0])
    hold = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0]).expand(n, 7)
    for _ in range(200):
        s = td.env_step(env2.params, s, hold)
    assert float(s.pos[:, 2].abs().max()) < 0.2
