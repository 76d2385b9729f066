"""Port parity for the position-task variants (sim2real, acceleration
sim2real, end-to-end, px4, reconfigurable, morphy): the six rewards, the
action scaling and the rotation encoding at random inputs, ten task steps
of each variant from a carry carried across from the JAX package with
JAX's own observation noise, the registration, and one PPO iteration on
the end-to-end task.

Tolerances:
  * rewards, action scaling and rot6d on the same inputs: atol 1e-5 (f32,
    the same formulas), except the end-to-end and px4 rewards, 1e-4: their
    progress term multiplies a difference of two norms by up to 100, which
    puts f32 rounding alone at ~5e-5 (the float64 evaluation of the port's
    formula is held to JAX's f32 result at the same bar);
  * ten task steps from a carried-across carry (wrench disturbance off in
    both, the same actions and the same normal draws): pose, linear
    velocity and the observation's pose and velocity entries 1e-4, body
    rates and motor thrusts 5e-3 (the drift bars of
    tests/test_torch_dynamics.py), the scaled action in the observation
    1e-6; crash and truncation flags exactly. The reward is held to 2e-3:
    it multiplies the change of the distance to the target by up to 1,200
    (``closer_reward``), so one f32 rounding of a ~1 m distance shows as
    ~1e-4 in it (4e-4 measured on the acceleration variant). The
    reconfigurable and morphy variants' observations end in the joint
    states: joint angles 1e-4, joint rates 1e-3 (the coupled solver's
    rounding, tests/test_torch_articulated.py). Envs reset inside a step draw their fresh state
    from a torch generator here and a JAX key there; from then on only
    their flags are compared.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag
from aerial_gym_simulator_tpu.tasks import position_setpoint_variants as jv

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.rl import ppo as t_ppo
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, variant_carry_from_numpy)
from aerial_gym_simulator_tpu_torch.tasks import position_setpoint_variants as tv

N = 8
NAMES = {
    "sim2real": "position_setpoint_task_sim2real",
    "acceleration_sim2real": "position_setpoint_task_acceleration_sim2real",
    "end_to_end": "position_setpoint_task_sim2real_end_to_end",
    "px4": "position_setpoint_task_sim2real_px4",
    "reconfigurable": "position_setpoint_task_reconfigurable",
    "morphy": "position_setpoint_task_morphy",
}
ARTICULATED = ("reconfigurable", "morphy")
T = lambda a: torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Thousands of tiny eager ops: one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _rand(rs, *shape, scale=1.0):
    return (rs.standard_normal(shape) * scale).astype(np.float32)


def _unit_quats(rs, n):
    q = _rand(rs, n, 4)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


# ---------------------------------------------------------------------------
# rewards, action scaling, rotation encoding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["sim2real", "acceleration", "reconfigurable", "morphy"])
def test_sim2real_rewards_match_jax(which):
    if which in ARTICULATED:
        _articulated_reward_matches_jax(which)
        return
    rs = np.random.RandomState(1 if which == "sim2real" else 2)
    n = 64
    pos_error = _rand(rs, n, 3, scale=4.0)
    prev_dist = np.abs(_rand(rs, n, scale=4.0))
    yaw = _rand(rs, n)
    linvel, angvel = _rand(rs, n, 3), _rand(rs, n, 3)
    crashes = (rs.uniform(size=n) < 0.2).astype(np.float32)
    action, prev = _rand(rs, n, 4), _rand(rs, n, 4)
    pos_error[:4] *= 4.0                          # beyond the 10 m crash distance
    args = (pos_error, prev_dist, yaw, linvel, angvel, crashes, action, prev)
    jf, tf = ((jv._sim2real_reward, tv._sim2real_reward) if which == "sim2real"
              else (jv._acceleration_reward, tv._acceleration_reward))
    jr, jc = jf(*(jnp.asarray(a) for a in args))
    tr, tc = tf(*(T(a) for a in args))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert (tc.numpy() > 0).sum() > (crashes > 0).sum()            # the 10 m rule fired


def _articulated_reward_matches_jax(which):
    """The reconfigurable and morphy rewards and their crash rule (beyond
    3 m, or rolled or pitched past 1 rad)."""
    rs = np.random.RandomState(12 if which == "reconfigurable" else 13)
    n = 64
    pos_error = _rand(rs, n, 3, scale=1.5)
    pos_error[:4] *= 4.0                          # beyond the 3 m crash distance
    quat = _unit_quats(rs, n)
    quat[4:32, 3] += 4.0                          # most near level, some upset
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    angvel = _rand(rs, n, 3)
    crashes = (rs.uniform(size=n) < 0.1).astype(np.float32)
    if which == "reconfigurable":
        args = (pos_error, quat, angvel, crashes)
        jf, tf = jv._reconfigurable_reward, tv._reconfigurable_reward
    else:
        joint_vels = _rand(rs, n, 8, scale=0.5)
        action, prev = rs.uniform(0, 2, (n, 4)).astype(np.float32), rs.uniform(0, 2, (n, 4)).astype(np.float32)
        args = (pos_error, quat, angvel, joint_vels, crashes, action, prev)
        jf, tf = jv._morphy_reward, tv._morphy_reward
    jr, jc = jf(*(jnp.asarray(a) for a in args))
    tr, tc = tf(*(T(a) for a in args))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5, rtol=1e-6)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    crashed = tc.numpy() > 0
    assert crashed[:4].all() and (tr.numpy()[crashed] == -20.0).all()
    assert 4 < crashed.sum() < n - 16             # the upset rule fired, level envs kept


@pytest.mark.parametrize("variant", ["end_to_end", "px4"])
def test_motor_command_rewards_match_jax(variant):
    rs = np.random.RandomState(3 if variant == "end_to_end" else 4)
    n = 64
    cfg = jv.EndToEndConfig() if variant == "end_to_end" else jv.Px4Config()
    # the previous error one control step away, as in a flight (a few cm)
    pos_error = _rand(rs, n, 3, scale=1.5)
    prev_pos_error = pos_error + _rand(rs, n, 3, scale=0.02)
    quat = _unit_quats(rs, n)
    linvel, angvel = _rand(rs, n, 3), _rand(rs, n, 3)
    crashes = (rs.uniform(size=n) < 0.2).astype(np.float32)
    lo, hi = cfg.action_limit_min[0], cfg.action_limit_max[0]
    action = rs.uniform(lo, hi, (n, 4)).astype(np.float32)
    prev = rs.uniform(lo, hi, (n, 4)).astype(np.float32)
    args = (pos_error, prev_pos_error, quat, linvel, angvel, crashes, action, prev)
    jkw = dict(z_scale=11.0, hover_thrust=9.81 * 0.372 / 4.0, closer_gains=(10.0, 15.0),
               upright2=False, align_gains=(6.0, 0.0), angvel_gain=0.3, act_diff=(1.3, 6.0),
               closer_big=False)
    if variant == "px4":
        jkw = dict(z_scale=13.0, hover_thrust=9.81 * 1.6559999883174896 / 4.0,
                   closer_gains=(50.0, 100.0), upright2=True, align_gains=(4.0, 2.0),
                   angvel_gain=0.75, act_diff=(0.5, 6.0), closer_big=True)
    jr, jc = jv._motor_command_reward(*(jnp.asarray(a) for a in args),
                                      crash_dist=cfg.crash_dist, **jkw)
    tr, tc = tv._motor_command_reward(*(T(a) for a in args), crash_dist=cfg.crash_dist,
                                      **tv._MOTOR_REWARD[variant])
    # 1e-4: the progress term multiplies the difference of two ~1.5 m
    # norms by up to 100, so f32 rounding alone puts each package ~5e-5
    # from the float64 value of the same formula
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    t64, _ = tv._motor_command_reward(*(T(a).double() for a in args),
                                      crash_dist=cfg.crash_dist, **tv._MOTOR_REWARD[variant])
    np.testing.assert_allclose(t64.numpy(), np.asarray(jr), atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", list(NAMES))
def test_scale_actions_matches_jax(variant):
    rs = np.random.RandomState(5)
    jcfg = ag.task_registry.get_task_config(NAMES[variant])
    tcfg = port.task_registry.get_task_config(NAMES[variant])
    raw = _rand(rs, 32, tcfg.action_space_dim, scale=1.5)   # some beyond [-1, 1]
    got = tv._scale_actions(tcfg, T(raw)).numpy()
    np.testing.assert_allclose(got, np.asarray(jv._scale_actions(jcfg, jnp.asarray(raw))),
                               atol=1e-5, rtol=0)
    if tcfg.action_limit_min:
        lo = np.array(tcfg.action_limit_min, np.float32)
        hi = np.array(tcfg.action_limit_max, np.float32)
        assert (got >= np.minimum(lo, hi)).all() and (got <= np.maximum(lo, hi)).all()
    else:
        assert np.array_equal(got, raw)
    if variant == "reconfigurable":
        # the joint limits run from +1 down to -1: ratio 0 is +1 rad/s
        zero = tv._scale_actions(tcfg, torch.zeros(1, 16))[0]
        assert torch.equal(zero[6:], torch.ones(10)) and torch.equal(zero[:6], torch.zeros(6))


def test_matrix_to_rotation_6d_matches_jax():
    m = _rand(np.random.RandomState(6), 5, 7, 3, 3)
    got = tv.matrix_to_rotation_6d(T(m)).numpy()
    assert got.shape == (5, 7, 6)
    np.testing.assert_array_equal(got, np.asarray(jv.matrix_to_rotation_6d(jnp.asarray(m))))


def test_abs_exp_helpers_match_jax():
    x = _rand(np.random.RandomState(7), 100, scale=2.0)
    for jf, tf in ((jv.abs_exp_func, tv.abs_exp_func),
                   (jv.abs_exp_penalty_func, tv.abs_exp_penalty_func)):
        np.testing.assert_allclose(tf(T(x), 0.3, 4.0).numpy(),
                                   np.asarray(jf(jnp.asarray(x), 0.3, 4.0)), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# task steps from a carried-across carry
# ---------------------------------------------------------------------------


def _jax_draws(key):
    """The normal draws the JAX step's observation packing takes from this
    carry key (``_pack_obs``: four keys split from the step's obs key)."""
    _, k_obs = jax.random.split(key)
    ks = jax.random.split(k_obs, 4)
    z = [T(jax.random.normal(k, (N, 3), jnp.float32)) for k in ks]
    return tv.VariantDraws(euler=z[0], pos=z[1], linvel=z[2], angvel=z[3])


def _obs_slices(variant):
    """(slice, atol) of the observation: pose and velocity 1e-4, body rates
    5e-3, the scaled action 1e-6, joint angles 1e-4 and rates 1e-3."""
    if variant in ARTICULATED:
        A, D = (16, 10) if variant == "reconfigurable" else (4, 8)
        return ((slice(0, 10), 1e-4), (slice(10, 13), 5e-3), (slice(13, 13 + A), 1e-6),
                (slice(13 + A, 13 + A + D), 1e-4), (slice(13 + A + D, 13 + A + 2 * D), 1e-3))
    if variant in ("sim2real", "acceleration_sim2real"):
        return ((slice(0, 10), 1e-4), (slice(10, 13), 5e-3), (slice(13, 17), 1e-6))
    return ((slice(0, 12), 1e-4), (slice(12, 15), 5e-3))


@pytest.mark.parametrize("variant", list(NAMES))
def test_ten_variant_steps_match_jax(variant):
    name = NAMES[variant]
    jtask = ag.task_registry.make_task(name, num_envs=N, seed=3)
    jtask.reset()
    jcfg = jtask.task_config
    jparams = jtask.params.replace(robot=jtask.params.robot.replace(enable_disturbance=False))
    tcfg = port.task_registry.get_task_config(name)
    tparams = params_from_numpy(record_to_numpy(jparams), "cpu")
    assert tparams.controller.num_actions == tcfg.num_motors
    A = tcfg.action_space_dim
    # one env one step short of its episode end: it truncates in step 2;
    # envs 0-5 start within 0.5 m of the target, envs 6-7 where the reset
    # put them (the end-to-end task's 1.5 m crash distance is within its
    # reset range, so some of those crash at once)
    rs = np.random.RandomState(8)
    jc = jtask._carry
    pos = np.array(jc.sim.pos)
    pos[:6] = rs.uniform(-0.5, 0.5, (6, 3))
    jc = jc._replace(sim=jc.sim.replace(
        pos=jnp.asarray(pos, jnp.float32),
        sim_steps=jc.sim.sim_steps.at[1].set(jcfg.episode_len_steps - 1)))
    tc = variant_carry_from_numpy(record_to_numpy(jc), "cpu", seed=3)
    target = jnp.zeros((N, 3), jnp.float32)
    jstep = jax.jit(lambda c, a: jv.variant_task_step(jparams, jcfg, c, a, target, None))

    fresh = np.zeros(N, bool)                       # envs whose state was redrawn
    for step in range(10):
        raw = rs.uniform(-1.0, 1.0, (N, A)).astype(np.float32)
        if variant == "sim2real":
            raw *= 0.5                              # velocity commands of a cruise
        elif variant in ARTICULATED:                # near hover: thrust ratios about 0.2 / 0.35
            raw[:, :tcfg.num_motors] = 0.05 * raw[:, :tcfg.num_motors] + (
                0.2 if variant == "reconfigurable" else 0.36)
        draws = _jax_draws(jc.key)
        jc, jobs, jrew, jterm, jtrunc = jstep(jc, jnp.asarray(raw))
        tc, tobs, trew, tterm, ttrunc = tv.variant_task_step(
            tparams, tcfg, tc, T(raw), torch.zeros(N, 3), None, draws)
        same = ~fresh
        np.testing.assert_array_equal(tterm.numpy()[same], np.asarray(jterm)[same])
        np.testing.assert_array_equal(ttrunc.numpy()[same], np.asarray(jtrunc)[same])
        np.testing.assert_allclose(trew.numpy()[same], np.asarray(jrew)[same], atol=2e-3,
                                   rtol=0)
        done = (np.asarray(jterm) > 0) | (np.asarray(jtrunc) > 0)
        same = same & ~done                         # the observation shows the fresh state
        fresh |= done
        assert same[[0, 2, 3, 4, 5]].all() or step > 2, (step, same)
        o_t, o_j = tobs.numpy()[same], np.asarray(jobs)[same]
        for sl, atol in _obs_slices(variant):
            np.testing.assert_allclose(o_t[:, sl], o_j[:, sl], atol=atol, rtol=0,
                                       err_msg=f"step {step} obs {sl}")
        for f, atol in (("pos", 1e-4), ("quat", 1e-4), ("linvel", 1e-4), ("angvel", 5e-3),
                        ("motor_thrust", 5e-3), ("dof_pos", 1e-4), ("dof_vel", 1e-3)):
            np.testing.assert_allclose(getattr(tc.sim, f).numpy()[same],
                                       np.asarray(getattr(jc.sim, f))[same], atol=atol,
                                       rtol=0, err_msg=f"step {step} {f}")
        tdone = (tterm.numpy() > 0) | (ttrunc.numpy() > 0)
        np.testing.assert_array_equal(tc.prev_action.numpy()[tdone], 0.0)
        np.testing.assert_allclose(tc.prev_action.numpy()[same],
                                   np.asarray(jc.prev_action)[same], atol=1e-6, rtol=0)
        if step == 1:
            assert done[1] and float(ttrunc[1]) == 1.0        # the forced truncation
            assert int(tc.sim.sim_steps[1]) == 0
    assert torch.isfinite(tobs).all() and tobs.shape == (N, tcfg.observation_space_dim)


@pytest.mark.parametrize("variant", ["sim2real", "end_to_end", "reconfigurable", "morphy"])
def test_observation_before_reset_matches_jax(variant):
    """return_state_before_reset: the observation of a truncated env shows
    its pre-reset state, and its prev_action is zeroed all the same."""
    name = NAMES[variant]
    jtask = ag.task_registry.make_task(name, num_envs=N, seed=4)
    jtask.reset()
    jcfg = dataclasses.replace(jtask.task_config, return_state_before_reset=True)
    tcfg = dataclasses.replace(port.task_registry.get_task_config(name),
                               return_state_before_reset=True)
    jparams = jtask.params.replace(robot=jtask.params.robot.replace(enable_disturbance=False))
    tparams = params_from_numpy(record_to_numpy(jparams), "cpu")
    jc = jtask._carry
    jc = jc._replace(sim=jc.sim.replace(
        sim_steps=jc.sim.sim_steps.at[2].set(jcfg.episode_len_steps)))
    tc = variant_carry_from_numpy(record_to_numpy(jc), "cpu", seed=4)
    raw = np.random.RandomState(9).uniform(-0.5, 0.5, (N, tcfg.action_space_dim))
    raw = raw.astype(np.float32) + (0.5 if variant in ARTICULATED else 0.0)
    draws = _jax_draws(jc.key)
    jc, jobs, jrew, jterm, jtrunc = jax.jit(lambda c, a: jv.variant_task_step(
        jparams, jcfg, c, a, jnp.zeros((N, 3)), None))(jc, jnp.asarray(raw))
    tc, tobs, trew, tterm, ttrunc = tv.variant_task_step(
        tparams, tcfg, tc, T(raw), torch.zeros(N, 3), None, draws)
    assert float(ttrunc[2]) == float(jtrunc[2]) == 1.0
    for sl, atol in _obs_slices(variant):
        np.testing.assert_allclose(tobs.numpy()[:, sl], np.asarray(jobs)[:, sl], atol=atol,
                                   rtol=0)
    assert float(tc.prev_action[2].abs().sum()) == 0.0 and int(tc.sim.sim_steps[2]) == 0


# ---------------------------------------------------------------------------
# registration, the task API, training
# ---------------------------------------------------------------------------


def test_variants_are_registered_with_the_jax_configs():
    for variant, name in NAMES.items():
        jcfg = ag.task_registry.get_task_config(name)
        tcfg = port.task_registry.get_task_config(name)
        for f in ("variant", "seed", "sim_name", "env_name", "robot_name", "controller_name",
                  "num_envs", "observation_space_dim", "action_space_dim",
                  "episode_len_steps", "crash_dist", "action_limit_min", "action_limit_max",
                  "return_state_before_reset", "num_motors", "num_joints"):
            assert getattr(tcfg, f) == getattr(jcfg, f), (name, f)
        task = port.task_registry.make_task(name, num_envs=4, device="cpu")
        assert task.params.controller.num_actions == tcfg.num_motors and task.num_envs == 4
        obs, rew, term, trunc, _ = task.reset()
        assert obs["observations"].shape == (4, tcfg.observation_space_dim)
        obs, rew, term, trunc, _ = task.step(torch.zeros(4, tcfg.action_space_dim))
        assert torch.isfinite(obs["observations"]).all() and torch.isfinite(rew).all()
    assert set(NAMES.values()) <= set(port.task_registry.get_task_names())
    assert port.task_registry.get_task_config(NAMES["reconfigurable"]).action_space_dim == 16
    with pytest.raises(KeyError, match="ROADMAP.md"):
        port.task_registry.make_task("position_setpoint_task_unknown", device="cpu")
    with pytest.raises(ValueError, match="unknown variant"):
        tv.variant_task_step(None, tv.VariantTaskConfig(variant="stiff"), None, None, None)


def test_no_control_sets_the_action_width_to_the_motor_count():
    for name in ("position_setpoint_task_sim2real_end_to_end",
                 "position_setpoint_task_sim2real_px4"):
        task = port.task_registry.make_task(name, num_envs=2, device="cpu")
        assert task.params.controller.name == "no_control"
        assert task.params.controller.num_actions == task.params.motor.num_motors == 4


def test_make_step_fn_and_set_carry_round_trip():
    task = port.task_registry.make_task(NAMES["px4"], num_envs=N, seed=5, device="cpu")
    step_fn, carry, obs0 = task.make_step_fn()
    assert carry.sim is task.state and obs0.shape == (N, 15)
    action = torch.full((N, 4), 0.3)
    gen_state = carry.rng.get_state()
    sim_gen_state = carry.sim.rng.get_state()
    out = step_fn(carry, action)
    carry.rng.set_state(gen_state)
    carry.sim.rng.set_state(sim_gen_state)
    want = tv.variant_task_step(task.params, task.task_config, carry, action,
                                task.target_position)
    for a, b in zip((out[0].sim.pos, *out[1:]), (want[0].sim.pos, *want[1:])):
        assert torch.equal(a, b)
    task.set_carry(out[0])
    assert task.state is out[0].sim and task._carry is out[0]


def test_ppo_iteration_on_the_end_to_end_task():
    task = port.task_registry.make_task(NAMES["end_to_end"], num_envs=8, device="cpu")
    cfg = t_ppo.PPOConfig(num_envs=8, horizon=8, minibatch_size=16, epochs=1)
    trainer = t_ppo.PPOTrainer(task, cfg)
    before = {k: v.clone() for k, v in trainer.network.state_dict().items()}
    trainer.train(total_env_steps=8 * 8, log_every=1)
    assert trainer.action_dim == 4 and trainer.obs_dim == 15
    assert any(not torch.equal(before[k], v) for k, v in trainer.network.state_dict().items())
    assert task._carry is trainer.env_carry
    assert torch.isfinite(task._carry.sim.pos).all()
