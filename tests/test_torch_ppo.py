"""Port parity for the PPO learner: the actor-critic network, the Gaussian
policy helpers, GAE, the running normalizers, the bounds loss, the clipped
loss with the gradient of every parameter on one minibatch, the optimizer
step and the adaptive learning rate, against the JAX package with the
parameters carried across and numpy-seeded data; the policy export; and
seeded CPU training runs.

Tolerances: 1e-5 on network outputs, losses and gradients (f32, the same
formulas; matmul_precision "highest" on the JAX side, whose default rounds
the products to bf16 on a TPU only); 1e-6 on one optimizer step from the same
gradients; the exported policy equals trainer.act to 1e-5.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aerial_gym_simulator_tpu.rl import networks as j_net
from aerial_gym_simulator_tpu.rl import ppo as j_ppo
from aerial_gym_simulator_tpu.sim2real.numpy_policy import NumpyPolicy

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.rl import networks as t_net
from aerial_gym_simulator_tpu_torch.rl import ppo as t_ppo
from aerial_gym_simulator_tpu_torch.sim2real.policy import export_policy_npz, load_policy_npz

OBS, ACT = 13, 4


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run thousands of tiny eager ops; torch's intra-op threads
    buy them nothing and, when several test workers share the cores, their
    spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def flax_actor_critic_params(seed=0, hidden=(256, 128, 64)):
    model = j_net.ActorCritic(action_dim=ACT, hidden=hidden)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    rs = np.random.RandomState(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rs.standard_normal(a.shape).astype(np.float32), params)
    return model, params


def load_flax_params(net: t_net.ActorCritic, params):
    """flax ActorCritic tree (Dense_0..2 actor, Dense_3 mean, Dense_4..6
    critic, Dense_7 value, log_std) -> the port's module, in place."""
    p = params["params"]
    n = len(net.actor)
    layers = list(net.actor) + [net.mean_head] + list(net.critic) + [net.value_head]
    assert len(layers) == 2 * n + 2
    with torch.no_grad():
        for i, layer in enumerate(layers):
            layer.weight.copy_(torch.from_numpy(np.array(p[f"Dense_{i}"]["kernel"]).T))
            layer.bias.copy_(torch.from_numpy(np.array(p[f"Dense_{i}"]["bias"])))
        net.log_std.copy_(torch.from_numpy(np.array(p["log_std"])))
    return net


def grads_as_flax(net: t_net.ActorCritic, grads):
    named = dict(zip([n for n, _ in net.named_parameters()], grads))
    n = len(net.actor)
    names = ([f"actor.{i}" for i in range(n)] + ["mean_head"]
             + [f"critic.{i}" for i in range(n)] + ["value_head"])
    out = {f"Dense_{i}": {"kernel": named[f"{name}.weight"].numpy().T,
                          "bias": named[f"{name}.bias"].numpy()}
           for i, name in enumerate(names)}
    out["log_std"] = named["log_std"].numpy()
    return {"params": out}


def assert_trees_close(got, want, atol):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=0,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# networks and distribution helpers
# ---------------------------------------------------------------------------


def test_actor_critic_forward_matches_flax():
    model, params = flax_actor_critic_params()
    obs = np.random.RandomState(1).standard_normal((32, OBS)).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        mean_j, log_std_j, value_j = model.apply(params, jnp.asarray(obs))
    net = load_flax_params(t_net.ActorCritic(OBS, ACT), params)
    with torch.no_grad():
        mean, log_std, value = net(torch.from_numpy(obs))
    assert tuple(mean.shape) == (32, ACT) and tuple(value.shape) == (32,)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(value.numpy(), np.asarray(value_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(log_std.detach().numpy(), np.asarray(log_std_j), atol=0, rtol=0)


def test_actor_critic_initialisation_is_orthogonal_with_the_jax_gains():
    net = t_net.ActorCritic(OBS, ACT)
    for layers, head, head_gain in ((net.actor, net.mean_head, 0.01),
                                    (net.critic, net.value_head, 1.0)):
        for layer, gain in [(l, math.sqrt(2.0)) for l in layers] + [(head, head_gain)]:
            w = layer.weight.detach()
            small = w @ w.T if w.shape[0] <= w.shape[1] else w.T @ w
            torch.testing.assert_close(small, gain ** 2 * torch.eye(small.shape[0]),
                                       atol=1e-4, rtol=0)
            assert not layer.bias.any()
    assert not net.log_std.any()
    with pytest.raises(ValueError, match="unknown activation"):
        t_net.ActorCritic(OBS, ACT, activation="swish")


def test_gaussian_helpers_match_jax():
    rs = np.random.RandomState(2)
    mean, action, noise = (rs.standard_normal((16, ACT)).astype(np.float32) for _ in range(3))
    log_std = rs.uniform(-1.0, 0.5, ACT).astype(np.float32)
    tm, ta, tn, tl = (torch.from_numpy(x) for x in (mean, action, noise, log_std))
    np.testing.assert_allclose(
        t_net.gaussian_logp(tm, tl, ta).numpy(),
        np.asarray(j_net.gaussian_logp(jnp.asarray(mean), jnp.asarray(log_std),
                                       jnp.asarray(action))), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(t_net.gaussian_entropy(tl)),
                               float(j_net.gaussian_entropy(jnp.asarray(log_std))), atol=1e-6)
    a, logp = t_net.sample_action(tm, tl, noise=tn)
    np.testing.assert_allclose(a.numpy(), mean + np.exp(log_std) * noise, atol=1e-6)
    torch.testing.assert_close(logp, t_net.gaussian_logp(tm, tl, a))
    g = torch.Generator().manual_seed(0)
    b, _ = t_net.sample_action(tm, tl, generator=g)
    assert tuple(b.shape) == (16, ACT) and not torch.equal(a, b)


# ---------------------------------------------------------------------------
# the learner's pieces
# ---------------------------------------------------------------------------


def test_gae_matches_jax():
    rs = np.random.RandomState(3)
    T, n = 12, 6
    values, rewards = (rs.standard_normal((T, n)).astype(np.float32) for _ in range(2))
    dones = (rs.uniform(size=(T, n)) < 0.2).astype(np.float32)
    last = rs.standard_normal(n).astype(np.float32)
    adv_j, ret_j = j_ppo._gae(0.99, 0.95, *(jnp.asarray(x) for x in (values, rewards, dones, last)))
    adv, ret = t_ppo._gae(0.99, 0.95, *(torch.from_numpy(x) for x in (values, rewards, dones, last)))
    np.testing.assert_allclose(adv.numpy(), np.asarray(adv_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ret.numpy(), np.asarray(ret_j), atol=1e-5, rtol=0)


def test_running_mean_std_matches_jax():
    rs = np.random.RandomState(4)
    sj, st = j_ppo.RunningMeanStd.init(OBS), t_ppo.RunningMeanStd.init(OBS)
    sj.update(v_mean=jnp.zeros(()), v_var=jnp.ones(()), v_count=jnp.asarray(1e-4))
    st.update(v_mean=torch.zeros(()), v_var=torch.ones(()), v_count=torch.tensor(1e-4))
    for i in range(3):
        batch = (rs.standard_normal((40, OBS)) * (i + 1) + i).astype(np.float32)
        sj = j_ppo.RunningMeanStd.update(sj, jnp.asarray(batch))
        st = t_ppo.RunningMeanStd.update(st, torch.from_numpy(batch))
        sj = j_ppo._vstats_update(sj, jnp.asarray(batch[:, :2]))
        st = t_ppo._vstats_update(st, torch.from_numpy(batch[:, :2]))
    assert set(st) == set(sj)
    for k in sj:                                     # biased variance on both sides
        np.testing.assert_allclose(st[k].numpy(), np.asarray(sj[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    x = (rs.standard_normal((5, OBS)) * 30).astype(np.float32)
    got = t_ppo.RunningMeanStd.normalize(st, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(j_ppo.RunningMeanStd.normalize(sj, jnp.asarray(x))),
                               atol=1e-5)
    assert float(got.abs().max()) == 5.0
    v = torch.from_numpy(x[:, 0])
    torch.testing.assert_close(t_ppo._v_unnormalize(st, t_ppo._v_normalize(st, v)), v)
    np.testing.assert_allclose(t_ppo._v_normalize(st, v).numpy(),
                               np.asarray(j_ppo._v_normalize(sj, jnp.asarray(x[:, 0]))), atol=1e-5)


def test_bounds_loss_matches_jax():
    mean = (np.random.RandomState(5).standard_normal((64, ACT)) * 1.5).astype(np.float32)
    want = float(j_ppo._bounds_loss(jnp.asarray(mean)))
    assert want > 0
    np.testing.assert_allclose(float(t_ppo._bounds_loss(torch.from_numpy(mean))), want, atol=1e-6)


def _jax_loss_fn(cfg):
    """The loss closure inside the JAX package's make_train_step."""
    train_step = j_ppo.make_train_step(lambda c, a: None, cfg)
    cells = dict(zip(train_step.__code__.co_freevars, train_step.__closure__))
    return cells["loss_fn"].cell_contents


def _minibatch(seed, n=128):
    rs = np.random.RandomState(seed)
    obs = np.clip(rs.standard_normal((n, OBS)) * 2.0, -5, 5).astype(np.float32)
    action = (rs.standard_normal((n, ACT)) * 1.2).astype(np.float32)
    old_logp = (rs.standard_normal(n) * 0.5 - 5.0).astype(np.float32)
    old_value, adv, ret = (rs.standard_normal(n).astype(np.float32) for _ in range(3))
    return obs, action, old_logp, old_value, adv, ret


@pytest.mark.parametrize("entropy_coef,bounds", [(0.0, 1e-4), (0.01, 0.0)],
                         ids=["defaults", "entropy-no-bounds"])
def test_ppo_loss_and_every_gradient_match_jax(entropy_coef, bounds):
    model, params = flax_actor_critic_params(seed=6)
    kw = dict(num_envs=16, horizon=8, minibatch_size=128, entropy_coef=entropy_coef,
              bounds_loss_coef=bounds)
    jcfg = j_ppo.PPOConfig(matmul_precision="highest", **kw)
    mb = _minibatch(6)
    ts = types.SimpleNamespace(apply_fn=model.apply)
    (total_j, aux_j), grads_j = jax.value_and_grad(_jax_loss_fn(jcfg), has_aux=True)(
        params, ts, tuple(jnp.asarray(x) for x in mb))

    net = load_flax_params(t_net.ActorCritic(OBS, ACT), params)
    total, aux = t_ppo.ppo_loss(t_ppo.PPOConfig(**kw), net, tuple(torch.from_numpy(x) for x in mb))
    grads = torch.autograd.grad(total, list(net.parameters()))
    np.testing.assert_allclose(float(total.detach()), float(total_j), atol=1e-5, rtol=1e-6)
    for name, a, b in zip(("pg_loss", "v_loss", "entropy", "kl"), aux, aux_j):
        np.testing.assert_allclose(float(a), float(b), atol=1e-5, rtol=1e-6, err_msg=name)
    assert_trees_close(grads_as_flax(net, grads), jax.tree_util.tree_map(np.asarray, grads_j),
                       atol=1e-5)


@pytest.mark.parametrize("scale", [1.0, 1e-3], ids=["clipped", "unclipped"])
def test_clip_then_adam_matches_optax(scale):
    """Two steps from the same gradients; at scale 1 the global norm exceeds
    max_grad_norm = 1 and the clip triggers, at 1e-3 it does not."""
    _, params = flax_actor_critic_params(seed=7, hidden=(32, 16))
    rs = np.random.RandomState(7)
    grads = [jax.tree_util.tree_map(
        lambda a: (scale * rs.standard_normal(a.shape)).astype(np.float32), params)
        for _ in range(2)]
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(3e-4, eps=1e-5))
    state, want = tx.init(params), params
    for g in grads:
        updates, state = tx.update(g, state)
        want = optax.apply_updates(want, updates)

    net = load_flax_params(t_net.ActorCritic(OBS, ACT, hidden=(32, 16)), params)
    opt = t_ppo.make_optimizer(net, 3e-4)
    for g in grads:
        g_net = load_flax_params(t_net.ActorCritic(OBS, ACT, hidden=(32, 16)), g)
        for p, gp in zip(net.parameters(), g_net.parameters()):
            p.grad = gp.detach().clone()
        t_ppo.clip_and_step(opt, 1.0)
    assert_trees_close(grads_as_flax(net, [p.detach() for p in net.parameters()]),
                       jax.tree_util.tree_map(np.asarray, want), atol=1e-6)
    assert isinstance(opt.param_groups[0]["lr"], torch.Tensor)   # the schedule's handle


def test_adapt_lr_three_branches_and_clamps():
    cfg = t_ppo.PPOConfig()
    lr = torch.tensor(3e-4)
    step = lambda lr, kl, c=cfg: float(t_ppo._adapt_lr(c, lr, torch.tensor(kl)))
    assert step(lr, 0.05) == pytest.approx(2e-4)                 # kl > 2 x 0.016: shrink
    assert step(lr, 0.001) == pytest.approx(4.5e-4)              # kl < 0.016 / 2: grow
    assert step(lr, 0.016) == pytest.approx(3e-4)                # inside the band: keep
    assert step(torch.tensor(1.2e-6), 0.05) == pytest.approx(cfg.min_lr)
    assert step(torch.tensor(9e-3), 0.001) == pytest.approx(cfg.max_lr)
    fixed = t_ppo.PPOConfig(lr_schedule="fixed")
    assert step(lr, 0.05, fixed) == pytest.approx(3e-4)
    # the JAX package's rule on the same numbers
    for kl in (0.05, 0.001, 0.016):
        want = jnp.where(kl > 2.0 * cfg.kl_threshold, jnp.maximum(3e-4 / 1.5, cfg.min_lr),
                         jnp.where(kl < 0.5 * cfg.kl_threshold,
                                   jnp.minimum(3e-4 * 1.5, cfg.max_lr), 3e-4))
        assert step(lr, kl) == pytest.approx(float(want))


def test_config_has_the_jax_fields_and_defaults():
    import dataclasses
    jf = {f.name: f.default for f in dataclasses.fields(j_ppo.PPOConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(t_ppo.PPOConfig)}
    # the port's one field more: rl-games' LayerNorm on the GRU's output, off
    # by default so that every JAX comparison builds the same network
    assert tf.pop("rnn_layer_norm") is False
    assert tf == jf


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------


class BanditTask:
    """Stateless bandit: reward = -|action - target|, constant observation
    (the task of the JAX package's own PPO learning test)."""

    def __init__(self, n, target, truncate_every=0):
        self.n, self.target, self.truncate_every = n, torch.tensor(target), truncate_every
        self.device = torch.device("cpu")
        self.task_config = types.SimpleNamespace(observation_space_dim=3,
                                                 action_space_dim=len(target))

    def make_step_fn(self):
        def step(carry, action):
            carry = carry + 1
            reward = -(action - self.target).abs().sum(-1)
            term = torch.zeros(self.n)
            trunc = torch.zeros(self.n)
            if self.truncate_every:
                trunc = trunc + float(int(carry) % self.truncate_every == 0)
            return carry, torch.zeros(self.n, 3), reward, term, trunc
        return step, torch.zeros((), dtype=torch.int64), torch.zeros(self.n, 3)


def test_ppo_learns_the_bandit_and_reward_rises():
    target = [0.5, -0.3]
    cfg = t_ppo.PPOConfig(num_envs=32, horizon=8, minibatch_size=128, epochs=4, lr=3e-3,
                          gamma=0.0, gae_lambda=0.0, seed=0, normalize_obs=False,
                          reward_scale=1.0, total_env_steps=32 * 8 * 120)
    tr = t_ppo.PPOTrainer(BanditTask(32, target), cfg)
    hist = tr.train(log_every=30)
    first, last = hist[0]["reward_mean"], hist[-1]["reward_mean"]
    assert last > first + 0.3, (first, last)
    np.testing.assert_allclose(tr.act(torch.zeros(1, 3))[0].numpy(), target, atol=0.15)
    assert all(cfg.min_lr <= m["lr"] <= cfg.max_lr for m in hist)
    assert len({m["lr"] for m in hist}) > 1                     # the schedule moved it


def test_ppo_value_normalization_and_bootstrap_path_learns():
    target = [0.2, 0.4]
    cfg = t_ppo.PPOConfig(num_envs=32, horizon=8, minibatch_size=128, epochs=4, lr=3e-3,
                          gamma=0.9, gae_lambda=0.95, seed=3, normalize_obs=False,
                          reward_scale=0.1, normalize_value=True, value_bootstrap=True,
                          total_env_steps=32 * 8 * 100)
    tr = t_ppo.PPOTrainer(BanditTask(32, target, truncate_every=4), cfg)
    hist = tr.train(log_every=25)
    assert hist[-1]["reward_mean"] > hist[0]["reward_mean"] + 0.2
    assert float(tr.norm["v_count"]) > 1000 and hist[-1]["done_rate"] == pytest.approx(0.25)


@pytest.fixture(scope="module")
def position_trainer():
    task = port.task_registry.make_task("position_setpoint_task", num_envs=64, seed=3,
                                        device="cpu")
    cfg = t_ppo.PPOConfig(num_envs=64, horizon=16, minibatch_size=256, epochs=2, seed=1)
    tr = t_ppo.PPOTrainer(task, cfg)
    before = [p.detach().clone() for p in tr.network.parameters()]
    hist = tr.train(total_env_steps=64 * 16 * 4, log_every=1)
    return tr, before, hist


def test_position_ppo_iterations_are_finite_and_move_the_parameters(position_trainer):
    tr, before, hist = position_trainer
    assert len(hist) == 4 and hist[-1]["env_steps"] == 64 * 16 * 4
    for m in hist:
        assert all(math.isfinite(v) for v in m.values()), m
        assert tr.cfg.min_lr <= m["lr"] <= tr.cfg.max_lr
        assert m["env_steps_per_s"] > 0
    assert all(not torch.equal(b, p) for b, p in zip(before, tr.network.parameters()))
    adam = tr.optimizer.state[next(tr.network.parameters())]
    assert int(adam["step"]) == 4 * 2 * 4 and float(tr.norm["count"]) > 4000
    assert tr.task.state is tr.env_carry                         # set_carry handed it back


def test_exported_policy_equals_trainer_act_in_both_loaders(position_trainer, tmp_path):
    tr, _, _ = position_trainer
    obs = (np.random.RandomState(8).standard_normal((16, OBS)) * 3).astype(np.float32)
    want = tr.act(torch.from_numpy(obs)).numpy()
    sampled = tr.act(torch.from_numpy(obs), deterministic=False).numpy()
    assert not np.array_equal(sampled, want)
    ckpt, npz_a, npz_b = (str(tmp_path / n) for n in ("t.ckpt", "a.npz", "b.npz"))
    tr.save_checkpoint(ckpt)
    export_policy_npz(tr, npz_a)
    export_policy_npz(ckpt, npz_b)
    for path in (npz_a, npz_b):
        got = load_policy_npz(path, device="cpu")(torch.from_numpy(obs)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        np.testing.assert_allclose(NumpyPolicy(path)(obs), want, atol=1e-5, rtol=0)


def test_checkpoint_round_trip_restores_act(position_trainer, tmp_path):
    tr, _, _ = position_trainer
    ckpt = str(tmp_path / "t.ckpt")
    tr.save_checkpoint(ckpt)
    obs = torch.from_numpy(np.random.RandomState(9).standard_normal((4, OBS)).astype(np.float32))
    want = tr.act(obs)
    task = port.task_registry.make_task("position_setpoint_task", num_envs=4, seed=0,
                                        device="cpu")
    other = t_ppo.PPOTrainer(task, t_ppo.PPOConfig(num_envs=4, horizon=2, minibatch_size=8,
                                                   seed=99))
    assert not torch.allclose(other.act(obs), want)
    other.load_checkpoint(ckpt)
    torch.testing.assert_close(other.act(obs), want)
    # Adam resumes where it stood: moments, step counts and the adapted lr
    for p, p_other in zip(tr.network.parameters(), other.network.parameters()):
        for key, value in tr.optimizer.state[p].items():
            torch.testing.assert_close(other.optimizer.state[p_other][key], value, atol=0, rtol=0)
    assert float(other.lr) == float(tr.lr) != other.cfg.lr
    assert other._iter == tr._iter == 4


def test_unported_options_raise():
    task = BanditTask(4, [0.0])
    with pytest.raises(ValueError, match="unknown rnn type"):
        t_ppo.PPOTrainer(task, t_ppo.PPOConfig(num_envs=4, rnn="lstm"))
    with pytest.raises(ValueError, match="lr_schedule"):
        t_ppo.PPOTrainer(task, t_ppo.PPOConfig(num_envs=4, lr_schedule="cosine"))
