"""Port parity for the position setpoint task: SimBuilder's parameters for
its environment, the reward, the observation at reset, and task steps from a
state carried across from the JAX package, including a crash and a
truncation.

Tolerances: reward shaping on the same inputs 1e-5; after a task step from a
carried-across state 1e-4 on reward, observation and robot state (one
physics substep per env step; the same formulas in another summation
order). An env that is reset inside the step draws its fresh state from a
torch generator here and from a JAX key there, so for those envs only the
reward and the flags are compared, and the fresh state is checked to lie
inside the env bounds.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag
from aerial_gym_simulator_tpu.tasks import position_setpoint_task as j_pos

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy, state_from_numpy
from aerial_gym_simulator_tpu_torch.tasks import position_setpoint_task as t_pos

N = 8


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run thousands of tiny eager ops; torch's intra-op threads
    buy them nothing and, when several test workers share the cores, their
    spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def tasks():
    jt = ag.task_registry.make_task("position_setpoint_task", num_envs=N, seed=5)
    tt = port.task_registry.make_task("position_setpoint_task", num_envs=N, seed=5,
                                      device="cpu")
    jt.reset()
    tt.reset()
    return jt, tt


def carry_across(jt, tt):
    tt.state = state_from_numpy(record_to_numpy(jt.state), "cpu", seed=11)


def _leaves_match(port_rec, ref_rec, path=""):
    if isinstance(ref_rec, dict):
        for k, v in ref_rec.items():
            _leaves_match(port_rec[k], v, f"{path}.{k}")
    elif ref_rec is None or isinstance(ref_rec, (bool, str)):
        assert port_rec == ref_rec, path
    else:
        np.testing.assert_allclose(np.asarray(port_rec, np.float64),
                                   np.asarray(ref_rec, np.float64), atol=1e-6, err_msg=path)


def test_task_is_registered_with_the_jax_defaults():
    assert "position_setpoint_task" in port.task_registry.get_task_names()
    jc = ag.task_registry.get_task_config("position_setpoint_task")
    tc = port.task_registry.get_task_config("position_setpoint_task")
    for f in dataclasses.fields(tc):
        if f.name != "device":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tc.device is None
    assert "empty_env" in port.env_config_registry.get_names()


def test_builders_agree_on_the_empty_env(tasks):
    jt, tt = tasks
    assert tt.params.scene is None and tt.params.camera is None
    assert tt.params.env.substep_mean == 1
    _leaves_match(record_to_numpy(tt.params), record_to_numpy(jt.params))


def test_compute_reward_matches_jax():
    rs = np.random.RandomState(0)
    n = 256
    err = rs.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    err[:8] *= 3.0                                       # some beyond the crash distance
    q = rs.standard_normal((n, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w = rs.standard_normal((n, 3)).astype(np.float32) * 3.0
    crashes = (rs.uniform(size=n) < 0.05).astype(np.float32)
    r_j, c_j = j_pos.compute_reward(jnp.asarray(err), jnp.asarray(q), jnp.asarray(w),
                                    jnp.asarray(crashes), 8.0)
    r_t, c_t = t_pos.compute_reward(torch.from_numpy(err), torch.from_numpy(q),
                                    torch.from_numpy(w), torch.from_numpy(crashes), 8.0)
    assert np.array_equal(c_t.numpy(), np.asarray(c_j)) and c_t.sum() > crashes.sum()
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), atol=1e-5, rtol=0)
    assert (r_t[c_t > 0] == -20.0).all()


def test_reset_observation_matches_jax(tasks):
    jt, tt = tasks
    carry_across(jt, tt)
    s = tt.state
    obs = t_pos._pack_obs(tt.target_position, t_pos.compute_robot_obs(s.pos, s.quat, s.linvel,
                                                                      s.angvel))
    assert tuple(obs.shape) == (N, 13)
    np.testing.assert_allclose(obs.numpy(), np.asarray(jt.task_obs["observations"]), atol=1e-5)


def _step_both(jt, tt, actions):
    jo, jr, jterm, jtrunc, _ = jt.step(jnp.asarray(actions))
    to, tr, tterm, ttrunc, infos = tt.step(torch.from_numpy(actions))
    assert infos == {}
    return ((np.asarray(jo["observations"]), np.asarray(jr), np.asarray(jterm),
             np.asarray(jtrunc)),
            (to["observations"].numpy(), tr.numpy(), tterm.numpy(), ttrunc.numpy()))


def test_three_task_steps_with_a_crash_and_a_truncation_match_jax(tasks):
    jt, tt = tasks
    rs = np.random.RandomState(1)

    # step 1: every env alive
    carry_across(jt, tt)
    a = rs.uniform(-0.5, 0.5, (N, 4)).astype(np.float32)
    (jo, jr, jte, jtr), (to, tr, tte, ttr) = _step_both(jt, tt, a)
    assert not jte.any() and not jtr.any()
    np.testing.assert_allclose(tr, jr, atol=1e-4, rtol=0)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=0)
    assert np.array_equal(tte, jte) and np.array_equal(ttr, jtr)
    for f in ("pos", "quat", "linvel", "angvel", "motor_thrust"):
        np.testing.assert_allclose(getattr(tt.state, f).numpy(), np.asarray(getattr(jt.state, f)),
                                   atol=1e-4, err_msg=f)

    # step 2: env 0 flies out of range (crash), env 1 runs out of time
    js = jt.state
    jt.state = js.replace(pos=js.pos.at[0, 0].set(50.0), sim_steps=js.sim_steps.at[1].set(501))
    carry_across(jt, tt)
    a = rs.uniform(-0.5, 0.5, (N, 4)).astype(np.float32)
    (jo, jr, jte, jtr), (to, tr, tte, ttr) = _step_both(jt, tt, a)
    assert jte.tolist() == [1.0] + [0.0] * (N - 1) and jtr.tolist() == [0.0, 1.0] + [0.0] * (N - 2)
    assert np.array_equal(tte, jte) and np.array_equal(ttr, jtr)
    np.testing.assert_allclose(tr, jr, atol=1e-4, rtol=0)
    assert tr[0] == -20.0
    np.testing.assert_allclose(to[2:], jo[2:], atol=1e-4, rtol=0)
    # the two done envs were reset: fresh state inside the bounds, clock at 0
    s = tt.state
    assert s.sim_steps[:2].tolist() == [0, 0] and int(s.sim_steps[2]) > 0
    assert ((s.pos[:2] >= s.bounds_lo[:2]) & (s.pos[:2] <= s.bounds_hi[:2])).all()
    assert np.abs(to[:2, :3]).max() <= 1.0 + 1e-6           # the target is the origin

    # step 3: from the JAX package's post-reset state, every env again
    carry_across(jt, tt)
    a = rs.uniform(-0.5, 0.5, (N, 4)).astype(np.float32)
    (jo, jr, jte, jtr), (to, tr, tte, ttr) = _step_both(jt, tt, a)
    np.testing.assert_allclose(tr, jr, atol=1e-4, rtol=0)
    np.testing.assert_allclose(to, jo, atol=1e-4, rtol=0)
    assert np.array_equal(tte, jte) and np.array_equal(ttr, jtr)


def test_observation_before_reset_matches_jax(tasks):
    jt, tt = tasks
    js = jt.state
    jt.state = js.replace(pos=js.pos.at[0, 0].set(50.0))
    carry_across(jt, tt)
    a = np.zeros((N, 4), np.float32)
    episode, crash = tt.task_config.episode_len_steps, tt.task_config.crash_dist_threshold
    _, jo, jr, jc, _ = j_pos.task_step(jt.params, jt.state, jnp.asarray(a), jt.target_position,
                                       episode, crash, None, True)
    _, to, tr, tc, _ = t_pos.task_step(tt.params, tt.state, torch.from_numpy(a),
                                       tt.target_position, episode, crash, None, True)
    assert tc.tolist() == np.asarray(jc).tolist() and tc[0] == 1.0
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-4, rtol=0)   # env 0 too
    assert abs(float(to[0, 0])) > 40.0
    jt.reset()


def test_make_step_fn_protocol_and_set_carry(tasks):
    _, tt = tasks
    step_fn, carry, obs = tt.make_step_fn()
    assert tuple(obs.shape) == (N, 13) and carry is tt.state
    carry2, obs2, reward, term, trunc = step_fn(carry, torch.zeros(N, 4))
    assert tuple(obs2.shape) == (N, 13) and tuple(reward.shape) == tuple(term.shape) == (N,)
    assert torch.isfinite(obs2).all() and torch.isfinite(reward).all()
    assert (carry2.sim_steps == 1).all() and trunc.sum() == 0
    same = tt.functional_step(tt.params, carry, torch.zeros(N, 4))
    assert len(same) == 5
    tt.set_carry(carry2)
    assert tt.state is carry2
    tt.reset_idx([0, 3])
    assert tt.state.sim_steps.tolist() == [0, 1, 1, 0] + [1] * (N - 4)
    assert tt.render() is None


def test_zero_actions_hover_on_the_cpu():
    """The verify recipe of the JAX package: 100 zero-action steps, reward
    mean around 1-3, no terminations."""
    task = port.task_registry.make_task("position_setpoint_task", num_envs=64, seed=7,
                                        device="cpu")
    task.reset()
    for _ in range(100):
        obs, r, term, trunc, info = task.step(torch.zeros(64, 4))
    assert 0.5 < float(r.mean()) < 3.5 and int(term.sum()) == 0 and task.counter == 100
    assert tuple(obs["observations"].shape) == (64, 13)


def test_position_task_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.task_registry.make_task("position_setpoint_task", num_envs=2)
