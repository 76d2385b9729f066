"""Port parity for the navigation task: the pure pieces (action transform,
reward, curriculum) and whole task steps against the JAX package, from a
NavState carried across and with the JAX side's random draws injected;
the wrench disturbance by its distribution; and a closed-loop flight of
the shipped ViT policy on the CPU.

Tolerances: pure functions atol 1e-5. A task step: reward atol 1e-4 (ten
physics substeps of rounding differences, see test_torch_dynamics.py),
terminations, truncations and infos equal, the 17 state dims of the
observation atol 1e-3, the 64 latents atol 5e-2 (both encoders compute in
bf16 and round at different places). Envs that reset inside the step take
fresh random states on each side and are compared on reward and flags
only, unless the task returns the state before the reset.

The task steps run with a 27x48 camera (upsampled to the encoder's
135x240 by both sides) to keep the file fast; the full camera is
compared in test_torch_slice.py and driven on the card by chip_smoke.py.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag
from aerial_gym_simulator_tpu.config.sensor_config.sensor_configs import (
    BaseDepthCameraConfig as JCameraConfig)
from aerial_gym_simulator_tpu.sensors.raycast_sensor import (
    build_ray_sensor_params as j_build_camera)
from aerial_gym_simulator_tpu.tasks import navigation_task as jnav

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
    BaseDepthCameraConfig as TCameraConfig)
from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
    build_ray_sensor_params as t_build_camera)
from aerial_gym_simulator_tpu_torch.sim import dynamics as td
from aerial_gym_simulator_tpu_torch.sim.convert import (
    nav_state_from_numpy, params_from_numpy, record_to_numpy)
from aerial_gym_simulator_tpu_torch.sim.structs import replace
from aerial_gym_simulator_tpu_torch.sim2real.policy import load_policy_npz
from aerial_gym_simulator_tpu_torch.tasks import navigation_task as tnav


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


NET = os.path.join(os.path.dirname(__file__), "..", "examples", "dce_rl_navigation",
                   "selected_network")
VIT_ENC = os.path.join(NET, "vit_depth_encoder.pkl")
VIT_NPZ = os.path.join(NET, "vit_navigation_policy.npz")
N = 8
CAM = dict(height=27, width=48)
T = torch.from_numpy


# ---------------------------------------------------------------------------
# pure pieces
# ---------------------------------------------------------------------------


def test_action_transform_matches_jax():
    raw = np.random.RandomState(0).uniform(-1.5, 1.5, (64, 4)).astype(np.float32)
    ref = np.asarray(jnav.action_transform(jnav.NavigationTaskConfig(), jnp.asarray(raw)))
    out = tnav.action_transform(tnav.NavigationTaskConfig(), T(raw))
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=0)


@pytest.mark.parametrize("progress", [0.0, 0.4, 1.0])
def test_compute_reward_matches_jax(progress):
    rs = np.random.RandomState(1)
    f = lambda *s: rs.normal(scale=2.0, size=s).astype(np.float32)
    pos_err, prev_err, act, prev_act = f(64, 3), f(64, 3), f(64, 4), f(64, 4)
    pos_err[0] = 0.0                                       # at the goal: norm at zero
    crashes = (rs.uniform(size=64) < 0.2).astype(np.float32)
    rp = jnav.NavigationTaskConfig().reward_parameters
    assert rp == tnav.NavigationTaskConfig().reward_parameters
    ref = jnav.compute_reward(rp, *(jnp.asarray(x) for x in (pos_err, prev_err, crashes, act,
                                                             prev_act)), jnp.float32(progress))
    out = tnav.compute_reward(rp, T(pos_err), T(prev_err), T(crashes), T(act), T(prev_act),
                              torch.tensor(progress))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=0)


CURRICULUM_CASES = [
    # level, aggregates (s, c, t), this step's outcomes (s, c, t) of 8 envs, level after
    pytest.param(20.0, (10.0, 3.0, 2.0), (2, 1, 0), 20.0, id="below-threshold-accumulates"),
    pytest.param(20.0, (1500.0, 300.0, 240.0), (6, 1, 1), 22.0, id="rate-0.73-raises-by-2"),
    pytest.param(20.0, (1000.0, 700.0, 340.0), (4, 3, 1), 19.0, id="rate-0.49-lowers-by-1"),
    pytest.param(20.0, (1300.0, 500.0, 240.0), (5, 2, 1), 20.0, id="rate-0.64-keeps"),
    pytest.param(44.0, (2000.0, 20.0, 20.0), (8, 0, 0), 44.0, id="capped-at-max"),
    pytest.param(15.0, (10.0, 2030.0, 0.0), (0, 8, 0), 15.0, id="floored-at-min"),
]


@pytest.mark.parametrize("level,aggs,outcomes,level_after", CURRICULUM_CASES)
def test_curriculum_update_matches_jax(level, aggs, outcomes, level_after):
    s, c, t = outcomes
    flags = np.zeros((3, N), np.float32)
    flags[0, :s] = 1.0
    flags[1, s:s + c] = 1.0
    flags[2, s + c:s + c + t] = 1.0
    jcur = jnav.CurriculumConfig(max_level=44)
    tcur = tnav.CurriculumConfig(max_level=44)
    assert dataclasses.asdict(jcur) == dataclasses.asdict(tcur)
    ref = jnav.curriculum_update(jcur, jnp.float32(level), *(jnp.float32(a) for a in aggs),
                                 *(jnp.asarray(x) for x in flags))
    out = tnav.curriculum_update(tcur, torch.tensor(level), *(torch.tensor(a) for a in aggs),
                                 *(T(x) for x in flags))
    for o, r in zip(out, ref):
        assert o.dim() == 0
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5, rtol=0)
    assert float(out[0]) == level_after
    checked = sum(aggs) + sum(outcomes) >= tcur.check_after_log_instances
    assert float(out[1] + out[2] + out[3]) == (0.0 if checked else sum(aggs) + sum(outcomes))


def test_config_defaults_match_jax():
    j, t = jnav.NavigationTaskConfig(), tnav.NavigationTaskConfig()
    for f in dataclasses.fields(t):
        if f.name not in ("device", "curriculum"):
            assert getattr(t, f.name) == getattr(j, f.name), f.name


# ---------------------------------------------------------------------------
# whole task steps from a carried-across state
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    """The JAX task (lmf2, shipped ViT encoder) with a small camera and the
    disturbance off, and the same params, state and encoder in the port."""
    jcfg = dataclasses.replace(ag.task_registry.get_task_config("navigation_task"),
                               vae_params_path=VIT_ENC)
    jtask = ag.task_registry.make_task("navigation_task", num_envs=N, seed=3, task_config=jcfg)
    jparams = jtask.params.replace(
        camera=j_build_camera(JCameraConfig(**CAM)),
        robot=jtask.params.robot.replace(enable_disturbance=False))
    tcfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                               vae_params_path=VIT_ENC)
    ttask = port.task_registry.make_task("navigation_task", num_envs=N, seed=3,
                                         task_config=tcfg, device="cpu")
    tparams = params_from_numpy(record_to_numpy(jparams), "cpu")
    assert tcfg.curriculum.max_level == jcfg.curriculum.max_level == 44
    return jtask, jparams, jcfg, ttask, tparams, tcfg


def _jax_draws(key):
    """The numbers the JAX nav_step draws itself from this state key."""
    _, k_obs, k_tgt, _, k_lat = jax.random.split(key, 5)
    u = lambda k: T(np.array(jax.random.uniform(k, (N, 3), jnp.float32)))
    return tnav.NavDraws(
        obs_perturb=u(k_obs), euler_perturb=u(jax.random.fold_in(k_obs, 1)),
        target_ratio=u(k_tgt),
        latent_noise=T(np.array(jax.random.normal(k_lat, (N, 64), jnp.float32))))


@pytest.mark.parametrize("before_reset", [False, True], ids=["after-reset", "before-reset"])
def test_nav_steps_match_jax(carried, before_reset):
    jtask, jparams, jcfg, ttask, tparams, tcfg = carried
    jcfg = dataclasses.replace(jcfg, return_state_before_reset=before_reset)
    tcfg = dataclasses.replace(tcfg, return_state_before_reset=before_reset)
    jstep = jax.jit(jnav.make_nav_step(jparams, jcfg, jtask.vae))
    # one env one step short of its episode end: it truncates and resets in step 2
    jns = jtask.nav_state
    jns = jns.replace(sim=jns.sim.replace(
        sim_steps=jns.sim.sim_steps.at[1].set(jcfg.episode_len_steps - 1)),
        latents=jnp.asarray(np.random.RandomState(2).normal(size=(N, 64)), jnp.float32))
    tns = nav_state_from_numpy(record_to_numpy(jns), "cpu", seed=3)
    assert int(tns.sim.num_obstacles[0]) == 15 and tns.curriculum_level.dim() == 0

    rs = np.random.RandomState(4)
    fresh = np.zeros(N, bool)                      # envs whose state was redrawn
    for step in range(3):
        raw = rs.uniform(-1.0, 1.0, (N, 4)).astype(np.float32)
        draws = _jax_draws(jns.key)
        jns, jobs, jrew, jterm, jtrunc, jinfo = jstep(jns, jnp.asarray(raw))
        tns, tobs, trew, tterm, ttrunc, tinfo = tnav.nav_step(
            tparams, tcfg, ttask.vae, tns, T(raw), draws)
        same = ~fresh
        np.testing.assert_array_equal(tterm.numpy()[same], np.asarray(jterm)[same])
        np.testing.assert_array_equal(ttrunc.numpy()[same], np.asarray(jtrunc)[same])
        np.testing.assert_allclose(trew.numpy()[same], np.asarray(jrew)[same], atol=1e-4)
        for k in ("successes", "timeouts", "crashes"):
            np.testing.assert_array_equal(tinfo[k].numpy()[same], np.asarray(jinfo[k])[same], k)
        assert float(tinfo["curriculum_level"]) == float(jinfo["curriculum_level"]) == 15.0
        done = (np.asarray(jterm) > 0) | (np.asarray(jtrunc) > 0)
        if not before_reset:
            same = same & ~done                    # the observation shows the fresh state
        assert same.sum() >= N - 2
        o_t, o_j = tobs.numpy()[same], np.asarray(jobs)[same]
        np.testing.assert_allclose(o_t[:, :17], o_j[:, :17], atol=1e-3, rtol=0)
        np.testing.assert_allclose(o_t[:, 17:], o_j[:, 17:], atol=5e-2, rtol=0)
        fresh |= done
        if step == 1:
            assert done[1] and float(ttrunc[1]) == 1.0       # the forced truncation
            assert int(tns.sim.sim_steps[1]) == 0
    assert torch.isfinite(tobs).all() and tobs.shape == (N, 81)
    assert (tns.sim.num_obstacles == 15).all()
    if before_reset:
        # the returned latents are the ones rendered for the previous step
        assert not torch.equal(tobs[:, 17:], tns.latents)


# ---------------------------------------------------------------------------
# the wrench disturbance, by its distribution
# ---------------------------------------------------------------------------


def test_disturbance_distribution(carried):
    ttask = carried[3]
    params, state = ttask.params, ttask.state
    rp = params.robot
    assert rp.enable_disturbance and rp.force_application_level == "root_link"
    assert abs(rp.disturbance_prob - 0.05) < 1e-7
    hits, draws = 0, 400
    for _ in range(draws):
        f, t = td.sample_disturbance(params, state)
        hit = (f != 0).any(dim=-1)
        assert torch.equal(hit, (t != 0).any(dim=-1))          # one coin for both
        assert (f.abs() <= rp.max_force_disturbance).all()
        assert (t.abs() <= rp.max_torque_disturbance).all()
        hits += int(hit.sum())
    share = hits / (draws * N)                  # 3200 coins: sigma = 0.0039
    assert 0.035 < share < 0.065, share
    f_all = torch.cat([td.sample_disturbance(params, state)[0] for _ in range(draws)])
    f_hit = f_all[(f_all != 0).any(dim=-1)]
    assert f_hit.abs().max() > 0.8 * 4.75 and abs(float(f_hit.mean())) < 0.6


def test_disturbance_enters_the_wrench(carried):
    ttask = carried[3]
    params, state = ttask.params, ttask.state
    quiet = replace(params, robot=replace(params.robot, enable_disturbance=False))
    action = torch.zeros(N, 4)
    push = (torch.ones(N, 3), 0.01 * torch.ones(N, 3))
    f0, t0, _ = td.compute_robot_wrench(quiet, state, action)
    f1, t1, _ = td.compute_robot_wrench(params, state, action, disturbance=push)
    torch.testing.assert_close(f1 - f0, push[0])
    torch.testing.assert_close(t1 - t0, push[1], atol=1e-6, rtol=0)
    assert torch.isfinite(td.env_step(params, state, action).pos).all()


def test_curriculum_level_culls_obstacles_on_reset(carried):
    """The task writes the curriculum level (15 of the 44 built slots) into
    num_obstacles; a reset then keeps that many obstacles per env (half of
    them with probability 0.15), never fewer than the keep_in_env slots
    (walls), and parks the rest at -1000."""
    jtask, _, _, ttask, _, _ = carried
    params, sc = ttask.params, ttask.params.scene
    n_keep = int(sc.keep_in_env.sum())
    assert sc.num_assets == 44 and n_keep == int(np.asarray(jtask.params.scene.keep_in_env).sum())
    state = replace(ttask.state, num_obstacles=torch.full((N,), 15, dtype=torch.int32))
    seen = set()
    for _ in range(12):
        state = td.reset_envs(params, state, torch.ones(N))
        present = state.obstacle_pos[..., 0] > -999.0                     # (N, A)
        assert present[:, sc.keep_in_env > 0].all()
        seen |= set(present.sum(dim=1).tolist())
    assert seen <= {15, max(15 // 2, n_keep)} and 15 in seen
    # the same rule as the JAX package, given the same state
    from aerial_gym_simulator_tpu.envs.scene import reset_obstacles as j_reset_obstacles
    jstate = jtask.nav_state.sim.replace(num_obstacles=jnp.full((N,), 15, jnp.int32))
    jout = j_reset_obstacles(jtask.params, jstate, jnp.ones((N,)), jstate.rng)
    jpresent = np.asarray(jout.obstacle_pos)[..., 0] > -999.0
    assert set(jpresent.sum(axis=1).tolist()) <= {15, max(15 // 2, n_keep)}


# ---------------------------------------------------------------------------
# the task object, closed loop
# ---------------------------------------------------------------------------


def test_shipped_vit_policy_flies_closed_loop_on_cpu():
    n = 4
    cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                              vae_params_path=VIT_ENC)
    task = port.task_registry.make_task("navigation_task", num_envs=n, seed=99,
                                        task_config=cfg, device="cpu")
    task.params = replace(task.params, camera=t_build_camera(TCameraConfig(**CAM), "cpu"))
    from aerial_gym_simulator_tpu_torch.models.vit import ViTImageEncoder
    assert isinstance(task.vae, ViTImageEncoder)
    policy = load_policy_npz(VIT_NPZ, device="cpu")
    obs, *_ = task.reset()
    assert obs["observations"].shape == (n, 81)
    ended = 0.0
    for _ in range(60):
        act = policy(obs["observations"])
        assert torch.isfinite(act).all()
        obs, rew, term, trunc, info = task.step(act)
        assert torch.isfinite(obs["observations"]).all() and torch.isfinite(rew).all()
        ended += float((info["successes"] + info["crashes"] + info["timeouts"]).sum())
    assert task.state is task.sim_env.state
    assert float(info["curriculum_level"]) == 15.0
    assert (task.state.num_obstacles == 15).all()
    assert ended == float(task.nav_state.success_agg + task.nav_state.crash_agg
                          + task.nav_state.timeout_agg)
    task.reset_idx([0, 2])
    assert (task.state.sim_steps[[0, 2]] == 0).all()
    task.close()


def test_task_without_gpu_raises_and_torch_vae_is_refused():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port.task_registry.make_task("navigation_task", num_envs=2)
    # the reference's .pth VAE is read when the task is built
    # (models/torch_vae_import; tests/test_torch_training_plumbing.py flies
    # one): a missing file is refused there
    cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                              torch_vae_path="reference_vae.pth")
    with pytest.raises(FileNotFoundError, match="reference_vae.pth"):
        port.task_registry.make_task("navigation_task", num_envs=2, task_config=cfg,
                                     device="cpu")
    assert port.task_registry.get_task_names() == [
        "lidar_navigation_task", "navigation_task", "position_setpoint_task",
        "position_setpoint_task_acceleration_sim2real", "position_setpoint_task_morphy",
        "position_setpoint_task_reconfigurable", "position_setpoint_task_sim2real",
        "position_setpoint_task_sim2real_end_to_end", "position_setpoint_task_sim2real_px4",
        "radar_navigation_task"]


# ---------------------------------------------------------------------------
# the PPO protocol
# ---------------------------------------------------------------------------


def _small_camera_task(n, seed):
    cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                              vae_params_path=VIT_ENC)
    task = port.task_registry.make_task("navigation_task", num_envs=n, seed=seed,
                                        task_config=cfg, device="cpu")
    task.params = replace(task.params, camera=t_build_camera(TCameraConfig(**CAM), "cpu"))
    return task


def test_make_step_fn_matches_nav_step_and_set_carry_hands_it_back():
    n = 2
    task = _small_camera_task(n, seed=5)
    step_fn, carry, obs0 = task.make_step_fn()
    assert carry is task.nav_state and obs0.shape == (n, 81) and not obs0.any()
    action = torch.full((n, 4), 0.2)
    gen_state = carry.rng.get_state()
    ns, obs, rew, term, trunc = step_fn(carry, action)
    carry.rng.set_state(gen_state)
    want = tnav.nav_step(task.params, task.task_config, task.vae, carry, action)
    for a, b in zip((ns.sim.pos, ns.latents, obs, rew, term, trunc),
                    (want[0].sim.pos, want[0].latents, *want[1:5])):
        assert torch.equal(a, b)
    task.set_carry(ns)
    assert task.nav_state is ns and task.state is ns.sim and task.sim_env.state is ns.sim


def test_ppo_iteration_on_the_navigation_task():
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    n = 4
    task = _small_camera_task(n, seed=6)
    trainer = PPOTrainer(task, PPOConfig(num_envs=n, horizon=4, minibatch_size=8, epochs=1,
                                         seed=2))
    assert trainer.obs_dim == 81
    before = [p.detach().clone() for p in trainer.network.parameters()]
    hist = trainer.train(total_env_steps=n * 4, log_every=1)
    assert len(hist) == 1 and all(np.isfinite(v) for v in hist[0].values())
    assert any(not torch.equal(b, p) for b, p in zip(before, trainer.network.parameters()))
    assert task.nav_state is trainer.env_carry and task.sim_env.state is trainer.env_carry.sim
    assert trainer.obs.shape == (n, 81) and torch.isfinite(trainer.obs).all()
