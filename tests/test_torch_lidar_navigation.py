"""Port parity for the LiDAR and radar navigation tasks: the pure pieces
(config defaults, action transform, reward, target sampling, pointcloud
processing with the JAX side's random draws injected) and whole task steps
from a LidarNavState carried across, against the JAX package; the PPO
protocol (make_step_fn / set_carry); and a closed-loop flight of the
shipped radar policy (GRU) on the CPU by the JAX package's own bar.

Tolerances: pure functions atol 1e-5 (the inverse-range image rtol 1e-5
too, its values reach 1 / 0.2). A task step: reward atol 1e-4 (ten
physics substeps of rounding differences, see test_torch_dynamics.py);
terminations, truncations and infos equal; the 17 state dims of the
observation atol 1e-3; the 320 inverse-range pixels atol 1e-3 on at least
99% of them (the two ray casts agree to 2e-3 in range, and a ray grazing
an edge may hit in one and miss in the other, see test_torch_sensors.py),
the invalid (-1) radar returns equal. Envs that reset inside the step take
fresh random states on each side and are compared on reward and flags
only.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag
from aerial_gym_simulator_tpu.tasks import lidar_navigation_task as jlid

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.sim.convert import (
    lidar_nav_state_from_numpy, params_from_numpy, record_to_numpy)
from aerial_gym_simulator_tpu_torch.sim2real.policy import RecurrentPolicy, load_policy_npz
from aerial_gym_simulator_tpu_torch.tasks import lidar_navigation_task as tlid

NET = os.path.join(os.path.dirname(__file__), "..", "examples", "dce_rl_navigation",
                   "selected_network")
RADAR_NPZ = os.path.join(NET, "radar_navigation_policy.npz")
N = 4
T = torch.from_numpy
CONFIGS = {"lidar": (jlid.LidarNavigationTaskConfig, tlid.LidarNavigationTaskConfig),
           "radar": (jlid.RadarNavigationTaskConfig, tlid.RadarNavigationTaskConfig)}


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Hundreds of small eager steps: one torch thread while this module
    runs (with several test workers on the cores, intra-op threads spin)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# pure pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", sorted(CONFIGS))
def test_config_defaults_match_jax(kind):
    j, t = (make() for make in CONFIGS[kind])
    for f in dataclasses.fields(t):
        if f.name not in ("device", "curriculum"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name
    assert dataclasses.asdict(t.curriculum) == dataclasses.asdict(j.curriculum)
    assert t.observation_space_dim == 337 and t.radar_mode == (kind == "radar")


def test_action_transform_matches_jax():
    raw = np.random.RandomState(0).uniform(-1.5, 1.5, (64, 4)).astype(np.float32)
    ref = jlid.action_transform(jlid.LidarNavigationTaskConfig(), jnp.asarray(raw))
    out = tlid.action_transform(tlid.LidarNavigationTaskConfig(), T(raw))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


@pytest.mark.parametrize("progress", [0.0, 0.5, 1.0])
def test_compute_reward_matches_jax(progress):
    rs = np.random.RandomState(1)
    f = lambda *s, scale=2.0: (rs.normal(scale=scale, size=s)).astype(np.float32)
    pos_err, prev_err, vel, angvel = f(64, 3), f(64, 3), f(64, 3), f(64, 3)
    act, prev_act = f(64, 4, scale=1.0), f(64, 4, scale=1.0)
    pos_err[0] = 0.0                                       # at the goal: norm at zero
    pos_err[1:8] *= 0.2                                    # within 1 m: stable-at-goal terms
    yaw_err = rs.uniform(-np.pi, np.pi, 64).astype(np.float32)
    ttc = rs.uniform(0.0, 10.0, 64).astype(np.float32)
    crashes = (rs.uniform(size=64) < 0.2).astype(np.float32)
    rp = jlid.LidarNavigationTaskConfig().reward_parameters
    args = (pos_err, prev_err, vel, angvel, yaw_err, crashes, act, prev_act, ttc)
    ref = jlid.compute_reward(rp, *(jnp.asarray(x) for x in args), jnp.float32(progress))
    out = tlid.compute_reward(rp, *(T(x) for x in args), torch.tensor(progress))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


def _jax_draws(key, n=N):
    """The numbers the JAX step draws itself from this state key."""
    _, k_obs, k_tgt, _, k_pc = jax.random.split(key, 5)
    u = lambda k, *shape: T(np.array(jax.random.uniform(k, shape, jnp.float32)))
    k_ratio, k_yaw = jax.random.split(k_tgt)
    k1, k2, k3, k4, k5 = jax.random.split(k_pc, 5)
    H, W = tlid.DS_SHAPE
    low = H - tlid.LOW_ROWS
    return tlid.LidarNavDraws(
        obs_perturb=u(k_obs, n, 3), euler_perturb=u(jax.random.fold_in(k_obs, 1), n, 3),
        target_ratio=u(k_ratio, n, 3), target_yaw=u(k_yaw, n),
        noise=u(k1, n, H, W), noise_value=u(k2, n, H, W), drop=u(k3, n, H, W),
        low=u(k4, n, low, W), low_value=u(k5, n, low, W))


def test_sample_targets_matches_jax():
    jtask = ag.task_registry.make_task("radar_navigation_task", num_envs=N, seed=2)
    sim = jtask.nav_state.sim
    key = jax.random.PRNGKey(7)
    target, yaw = jlid.sample_targets(jtask.task_config, sim, key)
    k1, k2 = jax.random.split(key)
    u = lambda k, *shape: T(np.array(jax.random.uniform(k, shape, jnp.float32)))
    tsim = lidar_nav_state_from_numpy(record_to_numpy(jtask.nav_state), "cpu").sim
    t_target, t_yaw = tlid.sample_targets(tlid.RadarNavigationTaskConfig(), tsim,
                                          u(k1, N, 3), u(k2, N))
    np.testing.assert_allclose(t_target.numpy(), np.asarray(target), atol=1e-5, rtol=0)
    np.testing.assert_allclose(t_yaw.numpy(), np.asarray(yaw), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind,invalid_prob", [("lidar", None), ("radar", None),
                                               ("radar", 0.35)],
                         ids=["lidar", "radar", "radar-annealed"])
def test_process_pointcloud_matches_jax(kind, invalid_prob):
    """A pointcloud of every range band (past 10 m, under 0.2 m, between),
    moving robots (some rays closing, some not), the JAX key's draws fed to
    the port."""
    rs = np.random.RandomState(3)
    robot = rs.uniform(-2.0, 2.0, (N, 3)).astype(np.float32)
    dirs = rs.normal(size=(N, 48, 120, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rng = rs.uniform(0.05, 14.0, (N, 48, 120, 1)).astype(np.float32)
    rng[:, ::7] = 1000.0                                   # misses: the no-hit range
    pts = robot[:, None, None, :] + rng * dirs
    vel = rs.normal(scale=1.5, size=(N, 3)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jcfg, tcfg = (make() for make in CONFIGS[kind])
    j_obs, j_ttc = jlid.process_pointcloud(
        jcfg, jnp.asarray(robot), jnp.asarray(vel), jnp.asarray(pts), key,
        None if invalid_prob is None else jnp.float32(invalid_prob))
    # the five draws process_pointcloud makes from its key
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    u = lambda k, *shape: T(np.array(jax.random.uniform(k, shape, jnp.float32)))
    H, W = tlid.DS_SHAPE
    low = H - tlid.LOW_ROWS
    draws = dataclasses.replace(
        _jax_draws(jax.random.PRNGKey(0)), noise=u(k1, N, H, W), noise_value=u(k2, N, H, W),
        drop=u(k3, N, H, W), low=u(k4, N, low, W), low_value=u(k5, N, low, W))
    t_obs, t_ttc = tlid.process_pointcloud(
        tcfg, T(robot), T(vel), T(pts), draws,
        None if invalid_prob is None else torch.tensor(invalid_prob))
    j_obs, j_ttc = np.asarray(j_obs), np.asarray(j_ttc)
    assert t_obs.shape == (N, 320) and t_ttc.shape == (N,)
    np.testing.assert_allclose(t_obs.numpy(), j_obs, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(t_ttc.numpy(), j_ttc, atol=1e-5, rtol=0)
    if kind == "radar":
        invalid = j_obs == -1.0
        share = invalid.mean()
        p = 0.8 if invalid_prob is None else invalid_prob
        assert abs(share - p) < 0.05, share
        np.testing.assert_array_equal(t_obs.numpy() == -1.0, invalid)
    else:
        # ranges in [0.2, 10] plus noise, or a low return in [0.2, 1)
        assert (j_obs > 0.0).all() and (j_obs <= 5.0 + 1e-5).all()


# ---------------------------------------------------------------------------
# whole task steps from a carried-across state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """For each task: the JAX task at 4 envs with the disturbance off and
    its step jitted once (the radar's invalid share annealed over 8 env
    steps, so that the carried env_steps move it), and the same params in
    the port."""
    out = {}
    for kind, name in (("lidar", "lidar_navigation_task"), ("radar", "radar_navigation_task")):
        jcfg = ag.task_registry.get_task_config(name)
        tcfg = port.task_registry.get_task_config(name)
        if kind == "radar":
            jcfg.radar_invalid_anneal_env_steps = tcfg.radar_invalid_anneal_env_steps = 8
        jtask = ag.task_registry.make_task(name, num_envs=N, seed=3, task_config=jcfg)
        jparams = jtask.params.replace(
            robot=jtask.params.robot.replace(enable_disturbance=False))
        tparams = params_from_numpy(record_to_numpy(jparams), "cpu")
        tcfg.curriculum.max_level = jcfg.curriculum.max_level
        out[kind] = (jtask, jax.jit(jlid.make_lidar_nav_step(jparams, jcfg)), tparams, tcfg)
    return out


@pytest.mark.parametrize("kind", ["lidar", "radar"])
def test_lidar_nav_steps_match_jax(carried, kind):
    jtask, jstep, tparams, tcfg = carried[kind]
    # one env one step short of its episode end: it truncates and resets in step 2
    jns = jtask.nav_state
    jns = jns.replace(sim=jns.sim.replace(
        sim_steps=jns.sim.sim_steps.at[1].set(tcfg.episode_len_steps - 1)))
    tns = lidar_nav_state_from_numpy(record_to_numpy(jns), "cpu", seed=3)
    assert int(tns.sim.num_obstacles[0]) == 25 and tns.env_steps.dim() == 0
    tstep = tlid.make_lidar_nav_step(tparams, tcfg)

    rs = np.random.RandomState(4)
    fresh = np.zeros(N, bool)                      # envs whose state was redrawn
    for step in range(3):
        raw = rs.uniform(-1.0, 1.0, (N, 4)).astype(np.float32)
        draws = _jax_draws(jns.key)
        jns, jobs, jrew, jterm, jtrunc, jinfo = jstep(jns, jnp.asarray(raw))
        tns, tobs, trew, tterm, ttrunc, tinfo = tstep(tns, T(raw), draws)
        same = ~fresh
        np.testing.assert_array_equal(tterm.numpy()[same], np.asarray(jterm)[same])
        np.testing.assert_array_equal(ttrunc.numpy()[same], np.asarray(jtrunc)[same])
        np.testing.assert_allclose(trew.numpy()[same], np.asarray(jrew)[same], atol=1e-4)
        for k in ("successes", "timeouts", "crashes"):
            np.testing.assert_array_equal(tinfo[k].numpy()[same], np.asarray(jinfo[k])[same], k)
        assert float(tinfo["curriculum_level"]) == float(jinfo["curriculum_level"]) == 25.0
        assert float(tns.env_steps) == float(jns.env_steps) == (step + 1) * N
        done = (np.asarray(jterm) > 0) | (np.asarray(jtrunc) > 0)
        same = same & ~done                        # the observation shows the fresh state
        assert same.sum() >= N - 2
        o_t, o_j = tobs.numpy()[same], np.asarray(jobs)[same]
        np.testing.assert_allclose(o_t[:, :17], o_j[:, :17], atol=1e-3, rtol=0)
        close = np.abs(o_t[:, 17:] - o_j[:, 17:]) <= 1e-3
        assert close.mean() >= 0.99, close.mean()
        np.testing.assert_array_equal(o_t[:, 17:] == -1.0, o_j[:, 17:] == -1.0)
        np.testing.assert_allclose(tns.ttc.numpy()[same], np.asarray(jns.ttc)[same],
                                   atol=1e-3, rtol=1e-3)
        fresh |= done
        if step == 1:
            assert done[1] and float(ttrunc[1]) == 1.0       # the forced truncation
            assert int(tns.sim.sim_steps[1]) == 0
            assert float(tns.prev_action[1].abs().sum()) == 0.0
    assert torch.isfinite(tobs).all() and tobs.shape == (N, 337)
    if kind == "radar":
        # annealed over 8 env steps: the share has reached 0.8 by the third step
        share = float((tobs[:, 17:] == -1.0).float().mean())
        assert 0.6 < share < 0.95, share


def test_step_fn_and_set_carry_round_trip():
    task = port.task_registry.make_task("lidar_navigation_task", num_envs=N, seed=5,
                                        device="cpu")
    step_fn, carry, obs0 = task.make_step_fn()
    assert carry is task.nav_state and obs0.shape == (N, 337) and not obs0.any()
    action = torch.full((N, 4), 0.3)
    gen_state = carry.rng.get_state()
    ns, obs, rew, term, trunc = step_fn(carry, action)
    carry.rng.set_state(gen_state)
    want = tlid.make_lidar_nav_step(task.params, task.task_config)(carry, action)
    for a, b in zip((ns.sim.pos, obs, rew, term, trunc, ns.lidar_obs),
                    (want[0].sim.pos, *want[1:5], want[0].lidar_obs)):
        assert torch.equal(a, b)
    task.set_carry(ns)
    assert task.nav_state is ns and task.state is ns.sim and task.sim_env.state is ns.sim
    obs, *_ = task.step(action)
    assert obs["observations"].shape == (N, 337) and float(task.nav_state.env_steps) == 2 * N


def test_lidar_ppo_iteration_runs_through_the_protocol():
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    task = port.task_registry.make_task("lidar_navigation_task", num_envs=N, seed=6,
                                        device="cpu")
    trainer = PPOTrainer(task, PPOConfig(num_envs=N, horizon=4, minibatch_size=8, epochs=1,
                                         seed=2))
    before = [p.detach().clone() for p in trainer.network.parameters()]
    hist = trainer.train(total_env_steps=N * 4, log_every=1)
    assert len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values())
    assert any(not torch.equal(b, p) for b, p in zip(before, trainer.network.parameters()))
    assert task.nav_state is trainer.env_carry and float(task.nav_state.env_steps) == 4 * N


def test_task_without_lidar_is_refused():
    cfg = dataclasses.replace(tlid.LidarNavigationTaskConfig(), robot_name="lmf2",
                              controller_name="lmf2_acceleration_control",
                              env_name="env_with_obstacles")
    with pytest.raises(ValueError, match="no lidar"):
        tlid.LiDARNavigationTask(cfg, num_envs=2, device="cpu")


# ---------------------------------------------------------------------------
# the shipped radar policy, closed loop, by the JAX package's bar
# ---------------------------------------------------------------------------


def test_shipped_radar_policy_flies_on_cpu():
    """tests/test_shipped_policies.py::test_shipped_radar_policy_flies on the
    port: 8 envs, seed 99, 450 steps at the 0.8 invalid share, hidden state
    reset per env at episode ends, finite actions, at least one success."""
    n = 8
    task = port.task_registry.make_task("radar_navigation_task", num_envs=n, seed=99,
                                        device="cpu")
    policy = load_policy_npz(RADAR_NPZ, device="cpu", num_envs=n)
    assert isinstance(policy, RecurrentPolicy) and policy.recurrent
    obs, *_ = task.reset()
    totals = torch.zeros(3)
    for _ in range(450):
        act = policy(obs["observations"])
        assert torch.isfinite(act).all()
        obs, rew, term, trunc, info = task.step(act)
        done = (term > 0) | (trunc > 0)
        if done.any():
            policy.reset(torch.nonzero(done)[:, 0])
        totals += torch.stack([info["successes"].sum(), info["crashes"].sum(),
                               info["timeouts"].sum()])
    succ, crash, timo = totals.tolist()
    assert succ > 0, f"no successes (s{succ}/c{crash}/t{timo})"
