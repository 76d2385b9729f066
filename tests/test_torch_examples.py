"""Port parity for the capability examples (aerial_gym_simulator_tpu_torch
.examples) against the repository's JAX scripts in examples/, loaded from
their files: NeuroBEM, the motor sys-id, IMU collection, gradient sys-id,
trajectory optimization and controller tuning. Every env state is carried
across from the JAX package (sim/convert.py); JAX's PRNG draws are carried
as draws.

Tolerances (each stated where it is held):
  * BEM: each wrench component within rtol 1e-4 of JAX's, plus an atol of
    1e-4 of its vector's largest component (the in-plane hub forces of a
    hovering rotor are 1e-5 of its thrust, and their f32 sums cancel); the
    batched call against the single rotor at the same bar (vmap's batched
    reductions and solves round otherwise); the
    notebook's oracle values rtol 1e-4 and the spin flip 1e-5 (JAX
    tests/test_aux_utils.py:233-254);
  * the motor step responses 1e-6 (the same f32 motor_step); the fit exact
    (the same float64 numpy) and within 10% of the truth (:419);
  * the IMU rows 1e-5 over 20 steps with JAX's draws, plus 1e-6 of the
    reading (accelerations of ~20 m/s^2 through two quaternion rotations in
    f32 differ by a few ulp; tests/test_torch_imu.py holds them to 2e-5);
  * the sys-id trajectory 1e-4 and its gradient 1e-3 relative at 4 envs x 20
    steps, 3 Adam iterations against optax's 1e-4 (20 steps of f32
    dynamics, tests/test_torch_dynamics.py);
  * the trajectory-optimization cost 1e-4 relative, its gradient 1e-3 of its
    largest component, 3 cosine-scheduled Adam iterations 1e-4;
  * step_response_metrics exact;
  * run_axis within 5e-3 at 8 envs x 50 steps (the dynamics bar of
    tests/test_torch_dynamics.py);
  * grad_tune's cost gradient 1e-3 relative at 4 envs x 30 steps.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.sensors import imu as j_imu
from aerial_gym_simulator_tpu.sim.dynamics import env_step as j_env_step
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

from aerial_gym_simulator_tpu_torch.examples import (
    bem_standalone as t_bem, differentiable_sysid_example as t_sysid, imu_data_collection as t_imu,
    sys_id as t_sys_id, trajectory_optimization_example as t_traj, tune_controllers as t_tune)
from aerial_gym_simulator_tpu_torch.sensors.imu import ImuDraws
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy, state_from_numpy

REPO = Path(__file__).resolve().parent.parent


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(f"jax_example_{name}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Many tiny eager ops: one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _carry(jstate):
    return state_from_numpy(record_to_numpy(jstate), "cpu")


# -- NeuroBEM ---------------------------------------------------------------------

BEM_CONDITIONS = [            # omega, v_hor, v_ver, p, q, clockwise
    (2000.0, 0.0, 0.0, 0.0, 0.0, 1.0),
    (1800.0, 3.0, 0.0, 0.0, 0.0, -1.0),
    (2200.0, 5.0, -1.0, 0.5, -0.3, 1.0),
    (1500.0, 0.0, 2.0, 0.0, 0.0, -1.0),
    (2500.0, 8.0, 1.0, -1.0, 1.0, 1.0),
]


@pytest.fixture(scope="module")
def bem():
    jb = _jax_example("bem_standalone")
    jbp = jb.default_params()
    tbp = t_bem.bem_params_from_numpy({k: np.asarray(v) for k, v in vars(jbp).items()}, "cpu")
    return jb, jbp, tbp


def _bem_close(got, want):
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max())


def test_bem_default_params_match_jax(bem):
    _, jbp, tbp = bem
    want = t_bem.default_params("cpu")
    for k, v in vars(jbp).items():
        assert float(getattr(tbp, k)) == float(v) == float(getattr(want, k)), k


@pytest.mark.parametrize("cond", BEM_CONDITIONS, ids=lambda c: f"w{c[0]:.0f}-vh{c[1]}-vv{c[2]}")
def test_bem_rotor_wrench_matches_jax(bem, cond):
    jb, jbp, tbp = bem
    _bem_close(t_bem.bem_rotor_wrench(tbp, *cond), jb.bem_rotor_wrench(jbp, *cond))


def test_bem_oracle_values_momentum_balance_and_spin_flip(bem):
    _, _, bp = bem
    force, torque = t_bem.bem_rotor_wrench(bp, 2000.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    np.testing.assert_allclose(float(force[2]), -7.44396, rtol=1e-4)
    np.testing.assert_allclose(float(torque[2]), 0.101683, rtol=1e-4)
    v_i = t_bem._solve_induced_velocity(bp, torch.tensor(2000.0), torch.tensor(0.0),
                                        torch.tensor(0.0))
    t_mom = t_bem._momentum_thrust(bp, v_i, 0.0, 0.0)
    t_bet, _, _ = t_bem._bet_integrals(bp, 2000.0, 0.0, 0.0, v_i, 0.0, 0.0, 0.0)
    np.testing.assert_allclose(float(t_bet) / float(t_mom), 1.0, rtol=5e-3)
    _, torque_ccw = t_bem.bem_rotor_wrench(bp, 2000.0, 0.0, 0.0, 0.0, 0.0, -1.0)
    np.testing.assert_allclose(float(torque_ccw[2]), -float(torque[2]), rtol=1e-5)


def test_bem_batched_matches_jax_and_the_single_rotor(bem):
    jb, jbp, tbp = bem
    cols = [np.array(c, np.float32) for c in zip(*BEM_CONDITIONS)]
    jf, jt = jb.bem_rotor_wrench_batched(jbp, *[jnp.asarray(c) for c in cols])
    tf, tt = t_bem.bem_rotor_wrench_batched(tbp, *[torch.as_tensor(c) for c in cols])
    assert tf.shape == tt.shape == (len(BEM_CONDITIONS), 3)
    for i, cond in enumerate(BEM_CONDITIONS):
        _bem_close((tf[i], tt[i]), (jf[i], jt[i]))
        _bem_close((tf[i], tt[i]), t_bem.bem_rotor_wrench(tbp, *cond))
    # any batch shape: (2, 3) rotors with a broadcast spin
    om = torch.linspace(1500.0, 2500.0, 6).reshape(2, 3)
    f2, t2 = t_bem.bem_rotor_wrench_batched(tbp, om, 1.0, 0.0, 0.0, 0.0, torch.tensor([1.0, -1.0, 1.0]))
    assert f2.shape == t2.shape == (2, 3, 3)
    _bem_close((f2[1, 2],), t_bem.bem_rotor_wrench(tbp, float(om[1, 2]), 1.0, 0.0, 0.0, 0.0, 1.0))


# -- motor sys-id ----------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["euler", "rk4"])
def test_sys_id_step_response_matches_jax(scheme):
    js = _jax_example("sys_id")
    want = js.simulate_step_response("base_quadrotor", scheme, 0.01, 100, 1.5)
    got = t_sys_id.simulate_step_response("base_quadrotor", scheme, 0.01, 100, 1.5, "cpu")
    assert got.shape == (100,)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_sys_id_fit_recovers_tau_as_jax(tmp_path):
    """JAX tests/test_aux_utils.py:419's synthetic trace; the command line's
    --fit on it as CSV."""
    js = _jax_example("sys_id")
    tau_up, tau_down, dt = 0.04, 0.02, 0.001
    t_up = np.arange(0, 0.4, dt)
    y_up = 2.0 * (1 - np.exp(-t_up / tau_up))
    t_dn = np.arange(0, 0.4, dt) + t_up[-1] + dt
    y_dn = y_up[-1] * np.exp(-(t_dn - t_dn[0]) / tau_down)
    times, thrusts = np.concatenate([t_up, t_dn]), np.concatenate([y_up, y_dn])
    got = t_sys_id.fit_time_constants(times, thrusts)
    assert got == js.fit_time_constants(times, thrusts)
    np.testing.assert_allclose(got, (tau_up, tau_down), rtol=0.1)
    path = tmp_path / "trace.csv"
    np.savetxt(path, np.stack([times, thrusts], 1), delimiter=",", header="time,thrust",
               comments="")
    np.testing.assert_allclose(t_sys_id.main(["--cpu", "--fit", str(path)]), got, rtol=1e-12)


def test_sys_id_command_line_writes_both_schemes(tmp_path, capsys):
    out = tmp_path / "resp.csv"
    euler, rk4 = t_sys_id.main(["--cpu", "--steps", "30", "--out", str(out)])
    rows = np.loadtxt(out, delimiter=",", skiprows=1)
    assert rows.shape == (30, 3)
    np.testing.assert_allclose(rows[:, 1], euler) and np.testing.assert_allclose(rows[:, 2], rk4)
    assert "63% time" in capsys.readouterr().out


# -- IMU collection -----------------------------------------------------------------


def test_imu_data_collection_rows_match_jax(tmp_path):
    """The JAX script's loop (hover, one measurement a step from a split
    key, biases written back) against collect() with its draws carried."""
    steps, n = 20, 1
    jenv = JSimBuilder().build_env("base_sim", "empty_env", "base_quadrotor_with_imu",
                                   "lee_position_control", num_envs=1, seed=0)
    jenv.reset()
    tenv = t_imu.build("cpu")
    tenv.state = _carry(jenv.state)
    hold = jnp.zeros((1, 4), jnp.float32)
    key = jax.random.PRNGKey(0)
    keys, want = [], []
    dt = float(jenv.params.dt)
    for i in range(steps):
        jenv.step(hold)
        key, k = jax.random.split(key)
        keys.append(k)
        accel, gyro, ab, gb = j_imu.imu_measurement(jenv.params, jenv.state, k)
        jenv.state = jenv.state.replace(imu_accel_bias=ab, imu_gyro_bias=gb)
        want.append([i * dt] + [float(v) for v in accel[0]] + [float(v) for v in gyro[0]])

    def draws(i):
        z = [torch.as_tensor(np.array(jax.random.normal(k, (n, 3))))
             for k in jax.random.split(keys[i], 4)]
        return ImuDraws(accel_bias=z[0], gyro_bias=z[1], accel_noise=z[2], gyro_noise=z[3])

    rows = t_imu.collect(tenv, steps, draws=draws)
    assert rows.shape == (steps, 7) and np.isfinite(rows).all()
    np.testing.assert_allclose(rows, np.array(want), atol=1e-5, rtol=1e-6)
    path = tmp_path / "imu.csv"
    t_imu.write_csv(str(path), rows)
    from aerial_gym_simulator_tpu_torch.utils.imu_to_rosbag import read_imu_csv
    back = np.array(list(read_imu_csv(str(path))))
    np.testing.assert_array_equal(back, rows)


def test_imu_data_collection_command_line(tmp_path):
    out = tmp_path / "imu.csv"
    rows = t_imu.main(["--cpu", "--steps", "5", "--out", str(out)])
    assert out.read_text().splitlines()[0] == "t,ax,ay,az,gx,gy,gz"
    assert rows.shape == (5, 7) and np.isfinite(rows).all()


# -- gradient sys-id ---------------------------------------------------------------


@pytest.fixture(scope="module")
def sysid_pair():
    js = _jax_example("differentiable_sysid_example")
    env = js.build(4)
    actions = js.excitation(4, 20)
    t_actions = t_sysid.excitation(4, 20, "cpu")
    np.testing.assert_array_equal(t_actions.numpy(), np.asarray(actions))
    tenv = t_sysid.build(4, device="cpu")
    tenv.state = _carry(env.state)
    j_roll = js.make_rollout(env.params, env.state, actions)
    t_roll = t_sysid.make_rollout(tenv.params, tenv.state, t_actions)
    true_j = {"tau": jnp.asarray(0.08), "drag": jnp.asarray([0.15, 0.12, 0.25])}
    measured_j = jax.jit(j_roll)(true_j)
    with torch.no_grad():
        measured_t = t_roll(t_sysid.theta_tensors(t_sysid.TRUE_THETA, "cpu"))

    def j_loss(lt):
        th = jax.tree_util.tree_map(jnp.exp, lt)
        return jnp.mean((j_roll(th) - measured_j) ** 2)

    return jax.jit(jax.value_and_grad(j_loss)), t_roll, measured_j, measured_t


def test_sysid_rollout_and_gradient_match_jax(sysid_pair):
    j_value_and_grad, t_roll, measured_j, measured_t = sysid_pair
    assert measured_t.shape == (20, 4, 6)
    np.testing.assert_allclose(measured_t.numpy(), np.asarray(measured_j), atol=1e-4, rtol=0)
    init = {"tau": 0.025, "drag": [0.5, 0.5, 0.05]}
    assert init == t_sysid.INITIAL_THETA
    lt_j = {k: jnp.log(jnp.asarray(v, jnp.float32)) for k, v in init.items()}
    loss_j, g_j = j_value_and_grad(lt_j)
    lt_t = {k: torch.log(v).requires_grad_() for k, v in t_sysid.theta_tensors(init, "cpu").items()}
    loss_t = t_sysid.sysid_loss(t_roll, measured_t, lt_t)
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-4)
    for k in ("tau", "drag"):
        g = lt_t[k].grad.numpy()
        np.testing.assert_allclose(g, np.asarray(g_j[k]), rtol=1e-3,
                                   atol=1e-3 * np.abs(np.asarray(g_j[k])).max(), err_msg=k)


def test_sysid_adam_matches_optax(sysid_pair):
    j_value_and_grad, t_roll, _, measured_t = sysid_pair
    lt = {k: jnp.log(jnp.asarray(v, jnp.float32)) for k, v in t_sysid.INITIAL_THETA.items()}
    opt = optax.adam(0.05)
    state = opt.init(lt)
    losses_j = []
    for _ in range(3):
        loss, g = j_value_and_grad(lt)
        upd, state = opt.update(g, state)
        lt = optax.apply_updates(lt, upd)
        losses_j.append(float(loss))
    lt_t, losses_t = t_sysid.identify(t_roll, measured_t, 3, 0.05)
    np.testing.assert_allclose(losses_t.numpy(), losses_j, rtol=1e-4)
    for k in ("tau", "drag"):
        np.testing.assert_allclose(lt_t[k].detach().numpy(), np.asarray(lt[k]), atol=1e-4,
                                   err_msg=k)
    assert float(losses_t[-1]) < float(losses_t[0])


def test_sysid_command_line_runs():
    th, losses = t_sysid.main(["--cpu", "--num_envs", "2", "--steps", "8", "--iters", "2"])
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert set(th) == {"tau", "drag"}


# -- trajectory optimization -------------------------------------------------------


def test_trajectory_cost_gradient_and_adam_match_jax():
    jt = _jax_example("trajectory_optimization_example")
    T, N, lr, iters = 20, 1, 0.05, 3
    params_j, st_j = jt.build(N)
    params_t, st_t = t_traj.build(N, "cpu")
    st_t = _carry(st_j)
    goal_j = jnp.asarray([1.0, 1.0, 1.0], jnp.float32)

    def j_cost(u):     # the JAX example's cost, as its main() writes it
        def body(st, a):
            st = j_env_step(params_j, st, a)
            return st, (st.pos, st.linvel, st.angvel)

        _, (pos, lv, av) = jax.lax.scan(body, st_j, u)
        w = jnp.linspace(0.0, 1.0, T)[:, None, None] ** 4
        track = jnp.mean(w * (pos - goal_j) ** 2)
        terminal = (jnp.sum((pos[-1] - goal_j) ** 2) + 0.1 * jnp.sum(lv[-1] ** 2)
                    + 0.05 * jnp.sum(av[-1] ** 2))
        effort = 1e-3 * jnp.mean((u - jt.HOVER_THRUST) ** 2)
        smooth = 1e-3 * jnp.mean((u[1:] - u[:-1]) ** 2)
        return track + terminal + effort + smooth

    _, cost_t = t_traj.make_cost(params_t, st_t, torch.tensor([1.0, 1.0, 1.0]))
    rs = np.random.RandomState(2)
    u0 = (jt.HOVER_THRUST + 0.05 * rs.normal(size=(T, N, 4))).astype(np.float32)
    j_value_and_grad = jax.jit(jax.value_and_grad(j_cost))
    c_j, g_j = j_value_and_grad(jnp.asarray(u0))
    u = torch.as_tensor(u0).requires_grad_()
    c_t = cost_t(u)
    c_t.backward()
    np.testing.assert_allclose(float(c_t.detach()), float(c_j), rtol=1e-4)
    g_j = np.asarray(g_j)
    np.testing.assert_allclose(u.grad.numpy(), g_j, rtol=0, atol=1e-3 * np.abs(g_j).max())

    opt = optax.adam(optax.cosine_decay_schedule(lr, iters))
    uj = jnp.asarray(u0)
    state = opt.init(uj)
    costs_j = []
    for _ in range(iters):
        c, g = j_value_and_grad(uj)
        upd, state = opt.update(g, state)
        uj = optax.apply_updates(uj, upd)
        costs_j.append(float(c))
    ut, costs_t = t_traj.optimize(cost_t, torch.as_tensor(u0), iters, lr)
    np.testing.assert_allclose(costs_t.numpy(), costs_j, rtol=1e-4)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-4, rtol=0)


def test_cosine_decay_is_optax_schedule():
    sched = optax.cosine_decay_schedule(0.05, 7)
    f = t_traj.cosine_decay(7)
    for count in range(10):
        np.testing.assert_allclose(0.05 * f(count), float(sched(count)), rtol=1e-6, atol=1e-9)


# -- controller tuning -----------------------------------------------------------


@pytest.fixture(scope="module")
def jtc():
    return _jax_example("tune_controllers")


def test_step_response_metrics_exact(jtc):
    rs = np.random.RandomState(4)
    t = np.arange(200) * 0.01
    for target, y in ((1.0, 1.0 - np.exp(-t / 0.3) + 0.1 * np.sin(8 * t) * np.exp(-t)),
                      (0.2, 0.2 * (1.0 - np.exp(-t / 0.1)) + 0.002 * rs.normal(size=200)),
                      (1.0, np.zeros(200))):
        got, want = t_tune.step_response_metrics(t, y, target), jtc.step_response_metrics(t, y, target)
        assert got.keys() == want.keys()
        for k in want:
            assert (got[k] == want[k]) or (np.isnan(got[k]) and np.isnan(want[k])), k


class _RecordingBuilder:
    """Stands in for the JAX module's SimBuilder class: builds with JAX's
    and keeps a numpy copy of each env's state right after its reset (the
    JAX step donates its state's buffers)."""

    def __init__(self):
        self.states = []

    def __call__(self):
        return self

    def build_env(self, *args, **kwargs):
        env = JSimBuilder().build_env(*args, **kwargs)
        reset = env.reset

        def recording_reset(*a, **k):
            out = reset(*a, **k)
            self.states.append(record_to_numpy(env.state))
            return out

        env.reset = recording_reset
        return env


def _carrying_build_env(states):
    """tune_controllers.build_env with its state taken from ``states``
    (numpy records of JAX envs of the same arguments, after their reset),
    one per build."""
    def build(robot, controller, num_envs, device=None):
        env = ORIGINAL_BUILD_ENV(robot, controller, num_envs, "cpu")
        env.state = state_from_numpy(states.pop(0), "cpu")
        return env
    return build


ORIGINAL_BUILD_ENV = t_tune.build_env


@pytest.mark.parametrize("case", t_tune.CASES, ids=lambda c: c[3].split(" ->")[0].replace(" ", "_"))
def test_run_axis_matches_jax(monkeypatch, jtc, case):
    controller, axis, target, _ = case
    recorder = _RecordingBuilder()
    monkeypatch.setattr(jtc, "SimBuilder", recorder)
    t_j, y_j = jtc.run_axis(controller, axis, target, 50, 8, "base_quadrotor")
    monkeypatch.setattr(t_tune, "build_env", _carrying_build_env(recorder.states))
    t_t, y_t = t_tune.run_axis(controller, axis, target, 50, 8, "base_quadrotor")
    np.testing.assert_allclose(t_t, t_j, rtol=1e-12)
    assert y_t.shape == (50,) and np.isfinite(y_t).all()
    np.testing.assert_allclose(y_t, np.asarray(y_j), atol=5e-3, rtol=0)


def test_grad_tune_cost_gradient_matches_jax(monkeypatch, jtc):
    steps, n = 30, 4
    jenv = JSimBuilder().build_env("base_sim", "empty_env", "base_quadrotor",
                                   "lee_position_control", num_envs=n, seed=0)
    jenv.reset()
    monkeypatch.setattr(t_tune, "build_env", _carrying_build_env([record_to_numpy(jenv.state)]))
    params_t, st0_t, _, cost_t = t_tune.tune_problem("base_quadrotor", steps, n)
    st0_j = jtc.rest_state(jenv)
    target = jnp.array([1.0, 0.0, 1.0])
    action = jnp.tile(jnp.array([[1.0, 0, 1.0, 0]], jnp.float32), (n, 1))

    def j_cost(log_g):     # the JAX grad_tune's cost, as it writes it
        g = jax.tree_util.tree_map(jnp.exp, log_g)
        st = st0_j.replace(K_pos=jnp.tile(g["kp"], (n, 1)), K_vel=jnp.tile(g["kv"], (n, 1)))

        def body(st, _):
            st = j_env_step(jenv.params, st, action)
            return st, st.pos

        _, pos = jax.lax.scan(body, st, None, length=steps)
        w = jnp.linspace(0.2, 1.0, steps)[:, None, None]
        return jnp.mean(w * (pos - target) ** 2) + 4.0 * jnp.mean(jnp.maximum(pos - target, 0.0) ** 2)

    lg_j = {"kp": jnp.log(st0_j.K_pos[0]), "kv": jnp.log(st0_j.K_vel[0])}
    c_j, g_j = jax.value_and_grad(j_cost)(lg_j)
    lg_t = {"kp": torch.log(st0_t.K_pos[0]).requires_grad_(),
            "kv": torch.log(st0_t.K_vel[0]).requires_grad_()}
    c_t = cost_t(lg_t)
    c_t.backward()
    np.testing.assert_allclose(float(c_t.detach()), float(c_j), rtol=1e-4)
    for k in ("kp", "kv"):
        want = np.asarray(g_j[k])
        np.testing.assert_allclose(lg_t[k].grad.numpy(), want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max(), err_msg=k)


def test_tune_controllers_command_line_and_grad_tune(capsys):
    res = t_tune.main(["--cpu", "--num_envs", "4", "--steps", "20"])
    assert "robot=base_quadrotor  envs=4  (20 steps)" in capsys.readouterr().out
    assert set(res) == {c[3] for c in t_tune.CASES}
    for m in res.values():
        assert np.isfinite(m["overshoot_pct"]) and np.isfinite(m["settling_time"])
    kp, kv, costs = t_tune.grad_tune("base_quadrotor", steps=10, iters=2, num_envs=2,
                                     device="cpu")
    assert "grad-tune iter    0" in capsys.readouterr().out
    assert costs.shape == (2,) and torch.isfinite(costs).all()
    assert kp.shape == kv.shape == (3,) and bool((kp > 0).all() and (kv > 0).all())
