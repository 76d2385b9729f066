"""Port parity for the recurrent PPO learner: ActorCriticGRU and its GRU
cell against flax with the parameters carried across, the initial gains,
the recurrent loss with the gradient of every parameter on one fixed
minibatch of sequences against the JAX package's loss, the trainer on the
radar task and on a bandit, and the recurrent policy archive in both
loaders.

Tolerances: 1e-5 on network outputs, hidden states, losses and gradients
(f32, the same formulas; matmul_precision "highest" on the JAX side); the
exported policy equals trainer.act to 1e-5, and the shipped radar archive
gives the same actions in both loaders to 5e-5 over 20 steps (five f32
layers from 337 inputs, whose products numpy and torch sum in different
orders, and a hidden state that carries those differences forward;
actions reach 2 in magnitude).
"""

import dataclasses
import logging
import math
import os
import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_gym_simulator_tpu.rl import networks as j_net
from aerial_gym_simulator_tpu.rl import ppo as j_ppo
from aerial_gym_simulator_tpu.sim2real.numpy_policy import load_policy_npz as j_load_policy

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.rl import networks as t_net
from aerial_gym_simulator_tpu_torch.rl import ppo as t_ppo
from aerial_gym_simulator_tpu_torch.sim2real.policy import (
    RecurrentPolicy, export_policy_npz, load_policy_npz)

RADAR_NPZ = os.path.join(os.path.dirname(__file__), "..", "examples", "dce_rl_navigation",
                         "selected_network", "radar_navigation_policy.npz")
OBS, ACT, HID, RNN = 11, 4, (32, 24), 16


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Thousands of tiny eager ops: one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def flax_gru_params(seed=0):
    model = j_net.ActorCriticGRU(action_dim=ACT, hidden=HID, rnn_hidden=RNN)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)), jnp.zeros((1, RNN)))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.1 * rs.standard_normal(a.shape).astype(np.float32), params)
    return model, params


# flax module names -> the port's, for the encoder, the cell and the heads
def _flax_names(net: t_net.ActorCriticGRU):
    n = len(net.encoder)
    names = {f"Dense_{i}": f"encoder.{i}" for i in range(n)}
    names.update({f"Dense_{n}": "mean_head", f"Dense_{n + 1}": "value_head"})
    names.update({f"GRUCell_0/{g}": f"gru.{'in_' if g == 'in' else g}"
                  for g in ("ir", "iz", "in", "hr", "hz", "hn")})
    return names


def load_flax_params(net: t_net.ActorCriticGRU, params):
    p = params["params"]
    mods = dict(net.named_modules())
    with torch.no_grad():
        for flax_name, name in _flax_names(net).items():
            leaf = p
            for part in flax_name.split("/"):
                leaf = leaf[part]
            mods[name].weight.copy_(torch.from_numpy(np.array(leaf["kernel"]).T))
            if "bias" in leaf:
                mods[name].bias.copy_(torch.from_numpy(np.array(leaf["bias"])))
            else:
                assert mods[name].bias is None, name
        net.log_std.copy_(torch.from_numpy(np.array(p["log_std"])))
    return net


def grads_as_flax(net: t_net.ActorCriticGRU, grads):
    named = dict(zip([n for n, _ in net.named_parameters()], grads))
    out = {"GRUCell_0": {}}
    for flax_name, name in _flax_names(net).items():
        leaf = {"kernel": named[f"{name}.weight"].numpy().T}
        if f"{name}.bias" in named:
            leaf["bias"] = named[f"{name}.bias"].numpy()
        if flax_name.startswith("GRUCell_0/"):
            out["GRUCell_0"][flax_name.split("/")[1]] = leaf
        else:
            out[flax_name] = leaf
    out["log_std"] = named["log_std"].numpy()
    return {"params": out}


def assert_trees_close(got, want, atol):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert sorted(jax.tree_util.keystr(p) for p, _ in flat_g) == \
        sorted(jax.tree_util.keystr(p) for p, _ in flat_w)
    want_by = {jax.tree_util.keystr(p): w for p, w in flat_w}
    for path, g in flat_g:
        key = jax.tree_util.keystr(path)
        np.testing.assert_allclose(np.asarray(g), np.asarray(want_by[key]), atol=atol, rtol=0,
                                   err_msg=key)


# ---------------------------------------------------------------------------
# the network
# ---------------------------------------------------------------------------


def test_gru_forward_and_steps_match_flax():
    model, params = flax_gru_params()
    rs = np.random.RandomState(1)
    net = load_flax_params(t_net.ActorCriticGRU(OBS, ACT, HID, RNN), params)
    h_j = jnp.asarray(rs.standard_normal((32, RNN)).astype(np.float32) * 0.5)
    h_t = torch.from_numpy(np.array(h_j))
    for _ in range(3):                              # the hidden state carried three steps
        obs = rs.standard_normal((32, OBS)).astype(np.float32)
        with jax.default_matmul_precision("highest"):
            mean_j, log_std_j, value_j, h_j = model.apply(params, jnp.asarray(obs), h_j)
        with torch.no_grad():
            mean, log_std, value, h_t = net(torch.from_numpy(obs), h_t)
        assert tuple(mean.shape) == (32, ACT) and tuple(h_t.shape) == (32, RNN)
        np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(value.numpy(), np.asarray(value_j), atol=1e-5, rtol=0)
        np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(log_std.detach().numpy(), np.asarray(log_std_j))
    # the cell alone: flax's nn.GRUCell on the same input and hidden
    cell = j_net.nn.GRUCell(features=RNN)
    x = rs.standard_normal((8, HID[-1])).astype(np.float32)
    h = rs.standard_normal((8, RNN)).astype(np.float32)
    cell_params = {"params": params["params"]["GRUCell_0"]}
    with jax.default_matmul_precision("highest"):
        want, _ = cell.apply(cell_params, jnp.asarray(h), jnp.asarray(x))
    with torch.no_grad():
        got = net.gru(torch.from_numpy(h), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_gru_initialisation_has_the_jax_gains():
    torch.manual_seed(0)
    net = t_net.ActorCriticGRU(OBS, ACT, HID, RNN)

    def orthogonal(w, gain):
        small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
        torch.testing.assert_close(small, gain ** 2 * torch.eye(small.shape[0]),
                                   atol=1e-4, rtol=0)

    for layer in net.encoder:
        orthogonal(layer.weight.detach(), math.sqrt(2.0))
    orthogonal(net.mean_head.weight.detach(), 0.01)
    orthogonal(net.value_head.weight.detach(), 1.0)
    for g in (net.gru.hr, net.gru.hz, net.gru.hn):          # flax: orthogonal(), scale 1
        orthogonal(g.weight.detach(), 1.0)
    # flax's input kernels: lecun normal, truncated at two standard deviations
    _, fparams = flax_gru_params()
    fan_in = HID[-1]
    w = torch.cat([g.weight.detach().reshape(-1) for g in (net.gru.ir, net.gru.iz,
                                                             net.gru.in_)])
    flax_std = np.std(np.asarray(j_net.nn.GRUCell(features=RNN).init(
        jax.random.PRNGKey(3), jnp.zeros((1, RNN)), jnp.zeros((1, fan_in)))
        ["params"]["ir"]["kernel"]))
    assert abs(float(w.std()) - 1.0 / math.sqrt(fan_in)) < 0.1 / math.sqrt(fan_in)
    assert abs(flax_std - 1.0 / math.sqrt(fan_in)) < 0.15 / math.sqrt(fan_in)
    bound = 2.0 / math.sqrt(fan_in) / 0.87962566103423978
    assert float(w.abs().max()) <= bound + 1e-6
    for name, p in net.named_parameters():
        if name.endswith("bias"):
            assert not p.any(), name
    assert not net.log_std.any()
    assert net.gru.hr.bias is None and net.gru.hz.bias is None     # flax's r/z: no hidden bias
    with pytest.raises(ValueError, match="unknown activation"):
        t_net.ActorCriticGRU(OBS, ACT, activation="swish")


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------


def _jax_rnn_loss_fn(cfg):
    """The loss closure inside the JAX package's make_train_step_rnn."""
    train_step = j_ppo.make_train_step_rnn(lambda c, a: None, cfg)
    cells = dict(zip(train_step.__code__.co_freevars, train_step.__closure__))
    return cells["loss_fn"].cell_contents


def _sequences(seed, envs=6, steps=5):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.standard_normal(s).astype(np.float32)
    obs = np.clip(f(envs, steps, OBS) * 2.0, -5, 5)
    action = f(envs, steps, ACT) * 1.2
    old_logp = f(envs, steps) * 0.5 - 5.0
    old_value, adv, ret = f(envs, steps), f(envs, steps), f(envs, steps)
    done_prev = (rs.uniform(size=(envs, steps)) < 0.25).astype(np.float32)
    done_prev[0, 2] = 1.0                          # an episode boundary mid-sequence
    h0 = f(envs, RNN) * 0.5
    return (obs, action, old_logp, old_value, adv, ret, done_prev), h0


@pytest.mark.parametrize("entropy_coef,bounds", [(0.0, 1e-4), (0.01, 0.0)],
                         ids=["defaults", "entropy-no-bounds"])
def test_recurrent_loss_and_every_gradient_match_jax(entropy_coef, bounds):
    model, params = flax_gru_params(seed=6)
    kw = dict(num_envs=6, horizon=5, minibatch_size=30, entropy_coef=entropy_coef,
              bounds_loss_coef=bounds, rnn="gru", rnn_hidden=RNN, hidden=HID)
    jcfg = j_ppo.PPOConfig(matmul_precision="highest", **kw)
    mb, h0 = _sequences(6)
    ts = types.SimpleNamespace(apply_fn=model.apply)
    (total_j, aux_j), grads_j = jax.value_and_grad(_jax_rnn_loss_fn(jcfg), has_aux=True)(
        params, ts, tuple(jnp.asarray(x) for x in mb), jnp.asarray(h0))

    net = load_flax_params(t_net.ActorCriticGRU(OBS, ACT, HID, RNN), params)
    total, aux = t_ppo.ppo_loss_rnn(t_ppo.PPOConfig(**kw), net,
                                    tuple(torch.from_numpy(x) for x in mb),
                                    torch.from_numpy(h0))
    grads = torch.autograd.grad(total, list(net.parameters()))
    np.testing.assert_allclose(float(total.detach()), float(total_j), atol=1e-5, rtol=1e-6)
    for name, a, b in zip(("pg_loss", "v_loss", "entropy", "kl"), aux, aux_j):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5, rtol=1e-6, err_msg=name)
    assert_trees_close(grads_as_flax(net, grads), jax.tree_util.tree_map(np.asarray, grads_j),
                       atol=1e-5)


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


class SequenceBandit:
    """Reward -|action - target| where the target flips sign each step and
    only the first observation of an episode shows it: a policy must carry
    it in its hidden state. Episodes of ``length`` steps (truncations)."""

    def __init__(self, n, length=4):
        self.n, self.length = n, length
        self.device = torch.device("cpu")
        self.task_config = types.SimpleNamespace(observation_space_dim=OBS,
                                                 action_space_dim=ACT)
        self.carried = None

    def make_step_fn(self):
        def step(t, action):
            t = t + 1
            sign = 1.0 - 2.0 * float(t % 2)
            reward = -(action - 0.5 * sign).abs().sum(-1)
            trunc = torch.full((self.n,), float(t % self.length == 0))
            obs = torch.zeros(self.n, OBS)
            obs[:, 0] = float(t % self.length == 0)
            return t, obs, reward, torch.zeros(self.n), trunc
        obs = torch.zeros(self.n, OBS)
        obs[:, 0] = 1.0
        return step, 0, obs

    def set_carry(self, carry):
        self.carried = carry


def test_gru_trainer_sequences_masks_and_warnings(caplog):
    task = SequenceBandit(7)
    cfg = t_ppo.PPOConfig(num_envs=7, horizon=4, minibatch_size=8, epochs=2, rnn="gru",
                          rnn_hidden=RNN, hidden=HID, seed=0, normalize_obs=False)
    with caplog.at_level(logging.INFO, logger="ppo"):
        tr = t_ppo.PPOTrainer(task, cfg)
    # whole sequences: 8 // 4 = 2 envs a minibatch, 3 minibatches, one env dropped
    assert (tr.mb_envs, tr.n_minibatches, tr.mb_size) == (2, 3, 8)
    assert "not a multiple of the 2-env sequence minibatch: 1 env sequences" in caplog.text
    carry, h, done_prev = tr.env_carry
    assert carry == 0 and h.shape == (7, RNN) and not h.any() and not done_prev.any()
    ro = tr.collect_rollout()
    assert ro.done_prev.shape == (4, 7) and ro.h0.shape == (7, RNN) and not ro.h0.any()
    np.testing.assert_array_equal(ro.done_prev[:, 0].numpy(), [0.0, 0.0, 0.0, 0.0])
    carry, h, done_prev = tr.env_carry
    assert carry == 4 and bool(done_prev.all()) and h.abs().sum() > 0
    # the permutation is drawn over envs: one randperm(7) per epoch
    state = tr.generator.get_state()
    tr.update(ro)
    g = torch.Generator().manual_seed(0)
    g.set_state(state)
    perms = [torch.randperm(7, generator=g) for _ in range(cfg.epochs)]
    assert all(sorted(p.tolist()) == list(range(7)) for p in perms)
    assert torch.equal(tr.generator.get_state(), g.get_state())
    hist = tr.train(total_env_steps=7 * 4 * 3, log_every=1)
    assert len(hist) == 3 and all(math.isfinite(v) for m in hist for v in m.values())
    assert task.carried == tr.env_carry[0] == 16     # set_carry got the task's own carry


def test_gru_ppo_learns_to_carry_the_cue():
    torch.manual_seed(0)
    task = SequenceBandit(32)
    cfg = t_ppo.PPOConfig(num_envs=32, horizon=8, minibatch_size=64, epochs=4, lr=3e-3,
                          gamma=0.0, gae_lambda=0.0, rnn="gru", rnn_hidden=RNN, hidden=HID,
                          seed=1, normalize_obs=False, reward_scale=1.0)
    tr = t_ppo.PPOTrainer(task, cfg)
    hist = tr.train(total_env_steps=32 * 8 * 60, log_every=20)
    first, last = hist[0]["reward_mean"], hist[-1]["reward_mean"]
    assert last > first + 0.5, (first, last)


def test_gru_ppo_iteration_on_the_radar_task(tmp_path):
    n = 4
    task = port.task_registry.make_task("radar_navigation_task", num_envs=n, seed=7,
                                        device="cpu")
    cfg = t_ppo.PPOConfig(num_envs=n, horizon=4, minibatch_size=8, epochs=1, rnn="gru",
                          rnn_hidden=RNN, hidden=HID, seed=3)
    tr = t_ppo.PPOTrainer(task, cfg)
    assert isinstance(tr.network, t_net.ActorCriticGRU)
    before = [p.detach().clone() for p in tr.network.parameters()]
    hist = tr.train(total_env_steps=n * 4, log_every=1)
    assert len(hist) == 1 and all(math.isfinite(v) for v in hist[0].values())
    assert any(not torch.equal(b, p) for b, p in zip(before, tr.network.parameters()))
    assert task.nav_state is tr.env_carry[0]               # the bare task carry
    assert float(task.nav_state.env_steps) == n * 4
    # the checkpoint carries the recurrent config and restores act
    ckpt = str(tmp_path / "radar.ckpt")
    tr.save_checkpoint(ckpt)
    with open(ckpt, "rb") as f:
        blob = pickle.load(f)
    assert blob["cfg"]["rnn"] == "gru" and blob["cfg"]["rnn_hidden"] == RNN
    obs = torch.from_numpy(np.random.RandomState(2).normal(size=(n, 337)).astype(np.float32))
    tr.reset_act_hidden()
    want = [tr.act(obs), tr.act(obs)]
    other = t_ppo.PPOTrainer(task, dataclasses.replace(cfg, seed=9))
    other.load_checkpoint(ckpt)
    got = [other.act(obs), other.act(obs)]
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


# ---------------------------------------------------------------------------
# recurrent archives
# ---------------------------------------------------------------------------


def test_exported_gru_policy_equals_trainer_act_in_both_loaders(tmp_path):
    n = 5
    task = SequenceBandit(n, length=3)
    cfg = t_ppo.PPOConfig(num_envs=n, horizon=6, minibatch_size=12, epochs=1, rnn="gru",
                          rnn_hidden=RNN, hidden=HID, seed=4)
    tr = t_ppo.PPOTrainer(task, cfg)
    tr.train(total_env_steps=n * 6 * 2, log_every=1)
    ckpt, npz_a, npz_b = (str(tmp_path / x) for x in ("g.ckpt", "a.npz", "b.npz"))
    tr.save_checkpoint(ckpt)
    export_policy_npz(tr, npz_a)
    export_policy_npz(ckpt, npz_b)
    rs = np.random.RandomState(5)
    obs_seq = (rs.standard_normal((8, n, OBS)) * 2).astype(np.float32)
    dones = (rs.uniform(size=(8, n)) < 0.3).astype(np.float32)
    for path in (npz_a, npz_b):
        port_policy = load_policy_npz(path, device="cpu", num_envs=n)
        jax_policy = j_load_policy(path, num_envs=n)
        assert isinstance(port_policy, RecurrentPolicy) and jax_policy.recurrent
        tr.reset_act_hidden()
        for t in range(8):
            done_prev = dones[t - 1] if t else None
            want = tr.act(torch.from_numpy(obs_seq[t]), done_prev=done_prev).numpy()
            if done_prev is not None and done_prev.any():
                ids = np.nonzero(done_prev)[0]
                port_policy.reset(ids)
                jax_policy.reset(ids)
            got = port_policy(torch.from_numpy(obs_seq[t])).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
            np.testing.assert_allclose(jax_policy(obs_seq[t]), want, atol=1e-5, rtol=0)


def test_shipped_radar_archive_acts_the_same_in_both_loaders():
    n = 6
    port_policy = load_policy_npz(RADAR_NPZ, device="cpu", num_envs=n)
    jax_policy = j_load_policy(RADAR_NPZ, num_envs=n)
    assert port_policy.action_dim == jax_policy.action_dim == 4
    assert port_policy.hidden_dim == 128 and len(port_policy.encoder) == 3
    rs = np.random.RandomState(6)
    for t in range(20):
        obs = (rs.standard_normal((n, 337)) * 2).astype(np.float32)
        if t in (5, 12):
            port_policy.reset([0, 3])
            jax_policy.reset([0, 3])
        if t == 16:
            port_policy.reset()
            jax_policy.reset()
        np.testing.assert_allclose(port_policy(torch.from_numpy(obs)).numpy(),
                                   jax_policy(obs), atol=5e-5, rtol=0)
    np.testing.assert_allclose(port_policy.hidden.numpy(), jax_policy.hidden, atol=5e-5,
                               rtol=0)
    # a bool mask resets the same envs as their indices, with no read-back
    by_mask = load_policy_npz(RADAR_NPZ, device="cpu", num_envs=n)
    by_mask.hidden = port_policy.hidden.clone()
    port_policy.reset([1, 4])
    by_mask.reset(torch.tensor([False, True, False, False, True, False]))
    assert torch.equal(by_mask.hidden, port_policy.hidden)
    assert not port_policy.hidden[[1, 4]].any() and port_policy.hidden[0].any()
    with pytest.raises(ValueError, match="num_envs"):
        port_policy(torch.zeros(n + 1, 337))


def test_shipped_radar_archive_takes_one_1d_observation():
    """A single (337,) observation is a batch of one and gives a (4,) action,
    as in the JAX loader; with num_envs > 1 a 1-D observation still raises."""
    port_policy = load_policy_npz(RADAR_NPZ, device="cpu", num_envs=1)
    jax_policy = j_load_policy(RADAR_NPZ, num_envs=1)
    rs = np.random.RandomState(11)
    for _ in range(3):
        obs = (rs.standard_normal(337) * 2).astype(np.float32)
        got = port_policy(torch.from_numpy(obs)).numpy()
        want = jax_policy(obs)
        assert got.shape == want.shape == (4,)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(port_policy.hidden.numpy(), jax_policy.hidden, atol=1e-5,
                               rtol=0)
    with pytest.raises(ValueError, match="num_envs"):
        load_policy_npz(RADAR_NPZ, device="cpu", num_envs=3)(torch.zeros(337))


def test_feed_forward_encoder_archive_takes_one_1d_observation(tmp_path):
    """An ``n_enc`` archive without a recurrent core: a 1-D observation gives
    a 1-D action equal to the JAX loader's, and to row 0 of a batch."""
    rs = np.random.RandomState(12)
    dims = (OBS, 16, 12)
    flat = {"activation": np.array("elu"), "normalize_obs": np.array(True),
            "norm_mean": rs.standard_normal(OBS).astype(np.float32),
            "norm_var": rs.uniform(0.5, 2.0, OBS).astype(np.float32),
            "n_enc": np.array(len(dims) - 1), "recurrent": np.array(False),
            "head_W": rs.standard_normal((dims[-1], 2 * ACT)).astype(np.float32) * 0.3,
            "head_b": rs.standard_normal(2 * ACT).astype(np.float32) * 0.1}
    for i in range(len(dims) - 1):
        flat[f"enc_W{i}"] = rs.standard_normal((dims[i], dims[i + 1])).astype(np.float32) * 0.3
        flat[f"enc_b{i}"] = rs.standard_normal(dims[i + 1]).astype(np.float32) * 0.1
    path = str(tmp_path / "ff.npz")
    np.savez(path, **flat)
    port_policy = load_policy_npz(path, device="cpu")
    jax_policy = j_load_policy(path)
    assert isinstance(port_policy, RecurrentPolicy) and not port_policy.recurrent
    obs = rs.standard_normal((3, OBS)).astype(np.float32)
    got = port_policy(torch.from_numpy(obs[0])).numpy()
    assert got.shape == (ACT,)
    np.testing.assert_allclose(got, jax_policy(obs[0]), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, port_policy(torch.from_numpy(obs)).numpy()[0], atol=1e-6,
                               rtol=0)
