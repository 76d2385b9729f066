"""Port parity for first-order training through the simulator: rollout
gradients of env_step (tests/test_differentiable.py's recipe) against
jax.grad, and rl/bptt.py's window and update against the JAX package's
BPTTTrainer from the same TanhPolicy weights (sim/convert.tanh_policy_from_flax)
and the same carried-across state; remat with the state's generator; the
best-EMA snapshot; act; the command line.

Tolerances: rollout gradients 1e-3 relative to jax.grad and the central
finite difference at JAX's rtol 0.05; the BPTT window's surrogate and mean
reward 1e-5 relative, its parameter gradients within 1e-3 of the largest;
parameters after one update (clip + Adam) within 1e-5; remat against no
remat 1e-6 with the generator's state equal.

No learning run is made here: 800 BPTT iterations take minutes in eager
torch on one CPU thread. chip_smoke.py trains at the JAX defaults on the
card against tests/test_bptt.py's bar.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag
from aerial_gym_simulator_tpu.rl import bptt as j_bptt
from aerial_gym_simulator_tpu.sim import dynamics as j_dyn
from aerial_gym_simulator_tpu.tasks import position_setpoint_task as j_pos
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.rl import bptt as t_bptt
from aerial_gym_simulator_tpu_torch.sim import dynamics as t_dyn
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy, tanh_policy_from_flax)
from aerial_gym_simulator_tpu_torch.sim.structs import replace

N, T = 128, 12


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Many small eager ops: one intra-op thread while this module runs, so
    that the suite's workers do not contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- rollout gradients (tests/test_differentiable.py) -------------------------

def _actions(steps):
    t = np.arange(steps)[:, None, None] * 0.01
    phase = np.arange(2)[None, :, None] * 0.9
    return np.concatenate([np.sin(6 * t + phase), np.sin(9 * t + 1.3 + phase),
                           np.sin(4 * t + 2.1 + phase), 0.3 * np.sin(3 * t + phase)],
                          axis=2).astype(np.float32)


@pytest.fixture(scope="module")
def empty_env():
    env = JSimBuilder().build_env("base_sim", "empty_env", "base_quadrotor",
                                  "lee_velocity_control", num_envs=2, seed=3)
    env.reset()
    return (env.params, env.state, params_from_numpy(record_to_numpy(env.params), "cpu"),
            state_from_numpy(record_to_numpy(env.state), "cpu"))


def _weights(shape):
    return np.sin(np.arange(int(np.prod(shape))).reshape(shape) * 0.1).astype(np.float32)


def _jax_loss(jp, js, actions):
    def loss(tau, drag):
        p = jp.replace(robot=jp.robot.replace(drag_lin_linear=drag))
        st = js.replace(motor_tau_inc=jnp.full_like(js.motor_tau_inc, tau),
                        motor_tau_dec=jnp.full_like(js.motor_tau_dec, tau))

        def body(st, a):
            st = j_dyn.env_step(p, st, a)
            return st, jnp.concatenate([st.pos, st.linvel], axis=-1)

        _, traj = jax.lax.scan(body, st, jnp.asarray(actions))
        return jnp.sum(traj * _weights(traj.shape))

    return loss


def _port_loss(tp, ts, actions):
    def loss(tau, drag):
        p = replace(tp, robot=replace(tp.robot, drag_lin_linear=drag))
        st = replace(ts, motor_tau_inc=tau.expand_as(ts.motor_tau_inc),
                     motor_tau_dec=tau.expand_as(ts.motor_tau_dec))
        traj = []
        for a in torch.from_numpy(actions):
            st = t_dyn.env_step(p, st, a)
            traj.append(torch.cat([st.pos, st.linvel], dim=-1))
        traj = torch.stack(traj)
        return torch.sum(traj * torch.from_numpy(_weights(tuple(traj.shape))))

    return loss


def test_rollout_gradients_match_jax_and_finite_differences(empty_env):
    """d/d tau and d/d drag of a 12-step env_step rollout: finite, within
    1e-3 relative of jax.grad, and within rtol 0.05 of a central finite
    difference."""
    jp, js, tp, ts = empty_env
    actions = _actions(12)
    tau0, drag0 = 0.08, np.array([0.15, 0.12, 0.25], np.float32)
    g_ref = jax.grad(_jax_loss(jp, js, actions), argnums=(0, 1))(jnp.float32(tau0),
                                                                 jnp.asarray(drag0))
    loss = _port_loss(tp, ts, actions)
    tau = torch.tensor(tau0, requires_grad=True)
    drag = torch.tensor(drag0, requires_grad=True)
    loss(tau, drag).backward()
    got = np.concatenate([[tau.grad.item()], drag.grad.numpy()])
    ref = np.concatenate([[float(g_ref[0])], np.asarray(g_ref[1])])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=0)

    eps = 1e-3
    with torch.no_grad():
        fd_tau = (loss(torch.tensor(tau0 + eps), torch.tensor(drag0))
                  - loss(torch.tensor(tau0 - eps), torch.tensor(drag0))) / (2 * eps)
        np.testing.assert_allclose(got[0], float(fd_tau), rtol=0.05, atol=1e-3)
        for i in range(3):
            up, down = drag0.copy(), drag0.copy()
            up[i] += eps
            down[i] -= eps
            fd = (loss(torch.tensor(tau0), torch.tensor(up))
                  - loss(torch.tensor(tau0), torch.tensor(down))) / (2 * eps)
            np.testing.assert_allclose(got[1 + i], float(fd), rtol=0.05, atol=1e-3)


def test_gradients_finite_through_obstacle_penetration():
    """env 0's robot teleported into its first obstacle: the rollout
    crashes, and d/d actions and d/d initial position stay finite."""
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                      "lee_velocity_control", num_envs=2, seed=5, device="cpu")
    env.reset()
    params, state0 = env.params, env.state
    pos0 = state0.pos.clone()
    pos0[0] = state0.obstacle_pos[0, 0]
    acts = torch.zeros((6, 2, 4), requires_grad=True)
    pos0.requires_grad_(True)
    st, traj, crashes = replace(state0, pos=pos0), [], []
    for a in acts:
        st = t_dyn.env_step(params, st, a)
        traj.append(st.pos)
        crashes.append(st.crashes)
    crashes = torch.stack(crashes)
    loss = torch.sum(torch.stack(traj) ** 2) * (1.0 + 0.1 * crashes.sum())
    loss.backward()
    assert crashes[:, 0].max().item() > 0, "the robot inside an obstacle must crash"
    assert torch.isfinite(loss)
    assert torch.isfinite(acts.grad).all() and torch.isfinite(pos0.grad).all()


# -- BPTT ---------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_trainer():
    task = ag.task_registry.make_task("position_setpoint_task", num_envs=N, seed=0)
    return j_bptt.BPTTTrainer(task, j_bptt.BPTTConfig(num_envs=N, horizon=T, seed=0))


def _port_trainer(jtr, **cfg):
    """A port trainer with the JAX trainer's weights, carry and observation."""
    task = port.task_registry.make_task("position_setpoint_task", num_envs=N, seed=0,
                                        device="cpu")
    tr = t_bptt.BPTTTrainer(task, t_bptt.BPTTConfig(num_envs=N, horizon=T, seed=0, **cfg))
    tr.policy.load_state_dict(tanh_policy_from_flax(jax.device_get(jtr.params)).state_dict())
    tr.carry = state_from_numpy(record_to_numpy(jtr.carry), "cpu", seed=5)
    tr.obs = torch.from_numpy(np.array(jtr.obs))
    return tr


def _flax_order(tensors):
    """The port's per-parameter tensors (parameters() order: each layer's
    weight, then bias) in flax's layout: Dense_i kernel (in, out) and bias."""
    t = [x.detach().numpy() for x in tensors]
    return {f"Dense_{i}": {"kernel": t[2 * i].T, "bias": t[2 * i + 1]}
            for i in range(len(t) // 2)}


def _jax_window(jtr):
    """JAX BPTTTrainer's window under jax.value_and_grad, also counting the
    window's resets. The step is the task's make_step_fn closure, rebuilt
    here without the reset that make_step_fn does."""
    task, cfg, policy = jtr.task, jtr.cfg, jtr.policy
    step_fn = functools.partial(j_pos.task_step, task.params, target_position=task.target_position,
                                episode_len=task.task_config.episode_len_steps,
                                crash_dist=task.task_config.crash_dist_threshold,
                                n_substeps=None)

    def window(params, carry, obs):
        def body(c, _):
            carry, obs = c
            a = policy.apply(params, obs)
            carry, obs2, r, term, trunc = step_fn(carry, a)
            return (carry, obs2), (j_bptt.default_cost(obs2, a, cfg), r, term + trunc)

        _, (cs, rs, dones) = jax.lax.scan(body, (carry, obs), None, length=cfg.horizon)
        return jnp.mean(cs), (rs.mean(), dones.sum())

    return jax.jit(jax.value_and_grad(window, has_aux=True))


def test_tanh_policy_matches_flax(jax_trainer):
    pol = tanh_policy_from_flax(jax.device_get(jax_trainer.params))
    obs = np.random.RandomState(0).standard_normal((16, 13)).astype(np.float32) * 3.0
    ref = np.asarray(jax_trainer.policy.apply(jax_trainer.params, jnp.asarray(obs)))
    with torch.no_grad():
        got = pol(torch.from_numpy(obs)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    # the port's own initialization: flax's layer kinds and scales
    tr = t_bptt.TanhPolicy(13, 4)
    assert [tuple(p.shape) for p in tr.parameters()] == [(64, 13), (64,), (64, 64), (64,),
                                                         (4, 64), (4,)]
    w = tr.head.weight.detach()
    torch.testing.assert_close(w @ w.T, 0.25 * torch.eye(4), atol=1e-5, rtol=0)
    assert all(torch.equal(layer.bias, torch.zeros_like(layer.bias))
               for layer in list(tr.hidden) + [tr.head])


def test_window_surrogate_reward_and_gradients_match_jax(jax_trainer):
    (loss_ref, (r_ref, dones)), g_ref = _jax_window(jax_trainer)(
        jax_trainer.params, jax_trainer.carry, jax_trainer.obs)
    assert int(dones) == 0, "the parity window must hold no reset"
    tr = _port_trainer(jax_trainer)
    loss, (_, _, rmean) = tr.window()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    np.testing.assert_allclose(rmean.item(), float(r_ref), rtol=1e-5)
    got = _flax_order([p.grad for p in tr.policy.parameters()])
    ref = jax.device_get(g_ref)["params"]
    scale = max(np.abs(np.asarray(x)).max() for layer in ref.values() for x in layer.values())
    for name, layer in got.items():
        for k, v in layer.items():
            np.testing.assert_allclose(v, np.asarray(ref[name][k]), atol=1e-3 * scale, rtol=0,
                                       err_msg=f"{name}.{k}")


def test_one_update_matches_jax(jax_trainer):
    """One window, the clip by the global norm and Adam (eps 1e-8): the
    parameters within 1e-5 of the JAX trainer's jitted update."""
    jtr = jax_trainer
    carry = jax.tree_util.tree_map(jnp.copy, jtr.carry)
    out = jtr._update(jtr.params, jtr.opt_state, carry, jtr.obs, jnp.asarray(0.0),
                      jnp.asarray(-jnp.inf), jtr.params, jnp.asarray(0))
    params_ref, loss_ref, r_ref = out[0], out[7], out[8]
    tr = _port_trainer(jtr)
    best = [p.detach().clone() for p in tr.params]
    ema, best_ema, loss, rmean = tr.update(0, torch.zeros(()), torch.tensor(-np.inf), best)
    np.testing.assert_allclose(loss.item(), float(loss_ref), rtol=1e-5)
    assert ema.item() == rmean.item() == best_ema.item()
    np.testing.assert_allclose(rmean.item(), float(r_ref), rtol=1e-5)
    got = _flax_order(tr.params)
    ref = jax.device_get(params_ref)["params"]
    for name, layer in got.items():
        for k, v in layer.items():
            np.testing.assert_allclose(v, np.asarray(ref[name][k]), atol=1e-5, rtol=0,
                                       err_msg=f"{name}.{k}")
    # the snapshot holds the window's input parameters, and the next window
    # starts from the detached final carry
    ref_in = jax.device_get(jtr.params)["params"]
    for name, layer in _flax_order(best).items():
        np.testing.assert_array_equal(layer["kernel"], np.asarray(ref_in[name]["kernel"]))
    assert not tr.carry.pos.requires_grad and not tr.obs.requires_grad


def _crashing_trainer(jtr, remat):
    """A port trainer whose first four envs start beyond the crash distance,
    so the window resets them (drawing from the state's generator)."""
    tr = _port_trainer(jtr, remat=remat)
    pos = tr.carry.pos.clone()
    pos[:4] = 9.0
    tr.carry = replace(tr.carry, pos=pos)
    return tr


def test_remat_matches_and_replays_the_generator(jax_trainer):
    """remat=True recomputes each step in the backward from the generator
    state of its forward: the gradients equal remat=False's to 1e-6 and the
    generator ends where the forward left it, over a window with resets."""
    runs = []
    for remat in (False, True):
        tr = _crashing_trainer(jax_trainer, remat)
        loss, (carry, _, _) = tr.window()
        after_forward = tr.carry.rng.get_state()
        loss.backward()
        assert torch.equal(tr.carry.rng.get_state(), after_forward)
        assert (carry.sim_steps[:4] < T).all(), "the first envs must have reset"
        runs.append(([p.grad.clone() for p in tr.params], after_forward, carry.pos.detach()))
    (g0, s0, pos0), (g1, s1, pos1) = runs
    assert torch.equal(s0, s1) and torch.equal(pos0, pos1)
    for a, b in zip(g0, g1):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def test_remat_replays_draws_that_reach_the_gradient():
    """A step whose gradient depends on its draw: the recomputation must use
    the forward's noise, and the generator must not advance again."""

    @dataclasses.dataclass
    class Carry:
        x: torch.Tensor
        rng: torch.Generator

    def step(carry, a):
        noise = torch.rand(a.shape, generator=carry.rng)
        return Carry(x=carry.x + (a * noise) ** 2, rng=carry.rng)

    grads, states = [], []
    for stepper in (step, t_bptt.remat_step(step)):
        gen = torch.Generator().manual_seed(0)
        a = torch.ones(5, requires_grad=True)
        carry = Carry(torch.zeros(5), gen)
        for _ in range(3):
            carry = stepper(carry, a)
        carry.x.sum().backward()
        grads.append(a.grad)
        states.append(gen.get_state())
    assert torch.equal(grads[0], grads[1]) and torch.equal(states[0], states[1])


def test_best_ema_snapshot_on_scripted_rewards(monkeypatch):
    """Rewards 1, 3, 2, 5, 0 at ema 0.5 give EMAs 1, 2, 2, 3.5, 1.75: the best
    is the fourth window, so train() restores that window's input
    parameters and reports 3.5."""
    task = port.task_registry.make_task("position_setpoint_task", num_envs=4, seed=0,
                                        device="cpu")
    tr = t_bptt.BPTTTrainer(task, t_bptt.BPTTConfig(num_envs=4, horizon=2, ema=0.5))
    rewards, inputs = iter([1.0, 3.0, 2.0, 5.0, 0.0]), []

    def scripted_window():
        inputs.append([p.detach().clone() for p in tr.params])
        loss = tr.policy(tr.obs).pow(2).mean()
        return loss, (tr.carry, tr.obs, torch.tensor(next(rewards)))

    monkeypatch.setattr(tr, "window", scripted_window)
    hist = tr.train(iters=5, log_every=1)
    assert [m["task_reward_ema"] for m in hist] == [1.0, 2.0, 2.0, 3.5, 1.75]
    assert tr.best_ema == 3.5
    for p, b in zip(tr.params, inputs[3]):
        assert torch.equal(p, b)
    assert not torch.equal(inputs[3][0], inputs[4][0])
    assert [m["env_steps"] for m in hist] == [8, 16, 24, 32, 40]


def test_act_is_bounded_by_the_action_scale():
    task = port.task_registry.make_task("position_setpoint_task", num_envs=8, seed=0,
                                        device="cpu")
    tr = t_bptt.BPTTTrainer(task, t_bptt.BPTTConfig(num_envs=8, horizon=2, action_scale=0.5))
    a = tr.act(tr.obs * 1e3)
    assert a.shape == (8, 4) and a.abs().max().item() <= 0.5 + 1e-6


def test_command_line(capsys, monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    trainer = t_bptt.main(["--cpu", "--num_envs", "8", "--horizon", "3", "--iters", "2"])
    assert trainer.best_ema is not None and np.isfinite(trainer.best_ema)
    assert "final task reward" in capsys.readouterr().out
    # outside a process group --multihost is refused and --multichip is a
    # world of one (the sharded command line: tests/test_torch_parallel.py)
    assert t_bptt.parse_args(["--multichip"]).multichip
    with pytest.raises(RuntimeError, match="no coordinator"):
        t_bptt.main(["--cpu", "--multihost", "--num_envs", "8", "--iters", "1"])
