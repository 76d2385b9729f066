"""The upstream navigation training recipe on the port's learner, held to
the benchmark's plain reference (``perfbench/reference/recurrent_ppo.py``):
the shipped navigation YAML through ``ppo_config_from_yaml``, the GRU
policy with its LayerNorm, one optimizer step, a whole update in one
process, and a 2-rank gloo update on the union of the ranks' rollouts, at
the published widths (81 -> MLP [256, 128, 64] elu -> GRU(32) ->
LayerNorm(32) -> heads). The task is a stub with the navigation task's
widths (``tests/nav_ppo_stub.py``): the update sees only the rollout.

Tolerances, all in float32 on the CPU with the same formulas:
  * network outputs and the new hidden state: 1e-5 absolute (values near
    1; the reference sums the same products in the same order, so the gap
    is a few ulps);
  * one optimizer step: each parameter's change within 2 ulps of the
    parameter plus 1e-4 of the change's RMS. The new parameter is stored
    in float32, so its change is known only to an ulp of the parameter: a
    weight near 0.3 has ulps of 3e-8 against changes near 6.5e-5 (the lr
    times Adam's normalised step), 4.6e-4 of the RMS measured. Beyond the
    ulp the gradients agree to 1e-6 of their RMS;
  * a whole update (4 epochs, 8 or more steps) and the 2-rank update: 1e-3
    of the change's RMS (the rounding gaps of each step carry into the
    next through the parameters and Adam's moments; measured up to 4e-5).
    The learning rate is compared exactly: the schedule's three branches
    are 1.5x apart.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os
import sys

import pytest
import torch

from nav_ppo_stub import (ACTION_DIM, CASES, OBS_DIM, RECIPE, StubTask, recipe_config,
                          reference_config, reference_update, snapshot)
from perfbench.reference import recurrent_ppo as ref

from aerial_gym_simulator_tpu_torch.parallel import multiproc
from aerial_gym_simulator_tpu_torch.rl import ppo as t_ppo
from aerial_gym_simulator_tpu_torch.rl.networks import ActorCriticGRU
from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from aerial_gym_simulator_tpu_torch.rl_training.rl_games import runner
from aerial_gym_simulator_tpu_torch.utils import profiling

WORKER = os.path.join(os.path.dirname(__file__), "torch_nav_ppo_worker.py")
HIDDEN, UNITS = (256, 128, 64), 32


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _network(layer_norm=True, seed=0):
    torch.manual_seed(seed)
    net = ActorCriticGRU(OBS_DIM, ACTION_DIM, HIDDEN, UNITS, "elu", layer_norm=layer_norm)
    with torch.no_grad():                  # a trained-looking network: nothing at its init
        for p in net.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return net


def _params(net):
    return {k: v.detach().clone() for k, v in net.named_parameters()}


def _ulp(x):
    """The gap from each element's magnitude to the next float32 above it."""
    a = x.abs()
    return torch.nextafter(a, torch.full_like(a, float("inf"))) - a


def _rel_gap(got, want):
    """Max abs gap of the concatenated tensors over the RMS of ``want``."""
    g = torch.cat([x.reshape(-1) for x in got])
    w = torch.cat([x.reshape(-1) for x in want])
    return float((g - w).abs().max() / w.pow(2).mean().sqrt())


# -- the network -----------------------------------------------------------------


def test_layer_norm_network_matches_reference():
    net, plain = _network(True), _network(False)
    with torch.no_grad():
        for k, v in plain.named_parameters():
            v.copy_(dict(net.named_parameters())[k])
    obs, h = torch.randn(16, OBS_DIM), torch.randn(16, UNITS)
    mean, log_std, value, h_new = net(obs, h)
    r_mean, r_log_std, r_value, r_h = ref.policy_forward(_params(net), obs, h)
    for a, b in ((mean, r_mean), (log_std, r_log_std), (value, r_value), (h_new, r_h)):
        assert torch.allclose(a, b, atol=1e-5, rtol=0), float((a - b).abs().max())
    # the norm feeds the heads only: the carried hidden state is the core's own
    assert torch.equal(plain(obs, h)[3], h_new)
    assert not torch.allclose(plain(obs, h)[0], mean, atol=1e-3)
    assert sorted(k for k in net.state_dict() if k.startswith("rnn_norm")) == [
        "rnn_norm.bias", "rnn_norm.weight"]
    assert net.rnn_norm.eps == 1e-5


def _minibatch(E=6, T=8, seed=1):
    g = torch.Generator().manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g)
    done = (torch.rand(E, T, generator=g) < 0.1).float()
    return dict(obs=r(E, T, OBS_DIM), action=r(E, T, ACTION_DIM), old_logp=r(E, T) - 4.0,
                old_value=r(E, T), adv=r(E, T), ret=r(E, T), done_prev=done), r(E, UNITS)


@pytest.mark.parametrize("layer_norm", [True, False])
def test_loss_and_one_optimizer_step_match_reference(layer_norm):
    """``ppo_loss_rnn`` and the trainer's step (clip, Adam with a history,
    the adaptive lr) against the reference's step on one minibatch."""
    cfg = dataclasses.replace(recipe_config(CASES["single"]), rnn_layer_norm=layer_norm)
    trainer = PPOTrainer(StubTask(cfg.num_envs), cfg)
    net = trainer.network
    mb, h0 = _minibatch()
    fields = ("obs", "action", "old_logp", "old_value", "adv", "ret", "done_prev")
    adv = mb["adv"]
    norm_adv = (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
    args = tuple(norm_adv if k == "adv" else mb[k] for k in fields)
    # a step first, so that Adam's moments are not zero
    trainer._step(*t_ppo.ppo_loss_rnn(cfg, net, args, h0))
    before, lr = _params(net), float(trainer.lr)
    names = [k for k, _ in net.named_parameters()]
    adam = {names[i]: {k: v.clone() for k, v in s.items()}
            for i, s in trainer._adam_state().items()}
    total, stats = t_ppo.ppo_loss_rnn(cfg, net, args, h0)
    r_total, _ = ref.ppo_loss(before, reference_config(cfg), mb, h0)
    assert abs(float(total.detach()) - float(r_total)) <= 1e-5 * max(1.0, abs(float(r_total)))
    trainer._step(total, stats)
    want, _, want_lr = ref.optimizer_step(before, adam, lr, reference_config(cfg), mb, h0)
    got = _params(net)
    rms = torch.cat([(want[k] - before[k]).reshape(-1) for k in names]).pow(2).mean().sqrt()
    for k in names:
        slack = 2.0 * _ulp(got[k]) + 1e-4 * rms
        assert ((got[k] - want[k]).abs() <= slack).all(), (k, float((got[k] - want[k]).abs().max()))
    assert float(trainer.lr) == pytest.approx(want_lr, rel=1e-6)


# -- the update ----------------------------------------------------------------------


def test_whole_update_in_one_process_matches_reference():
    """GAE with the truncation bootstrap's rewards, the observation and value
    moments, the advantages over each minibatch and 4 epochs of 2
    minibatches, against the reference on the same rollout."""
    case = CASES["single"]
    cfg = recipe_config(case)
    assert cfg.rnn_layer_norm and cfg.normalize_value and cfg.normalize_obs
    trainer = PPOTrainer(StubTask(cfg.num_envs), cfg)
    trainer.train_iteration()
    ro = trainer.collect_rollout()
    snap = dict(snapshot(trainer), rollout=vars(ro))
    trainer.update(ro)
    want, want_lr = reference_update(ref, [snap], cfg)
    names = list(want)
    got = _params(trainer.network)
    before = snap["params"]
    gap = _rel_gap([got[k] - before[k] for k in names], [want[k] - before[k] for k in names])
    assert gap <= 1e-3, gap
    assert float(trainer.lr) == pytest.approx(want_lr, rel=1e-6)
    assert t_ppo.COUNTS["optimizer_steps"] >= cfg.epochs * trainer.n_minibatches


def test_rollout_step_bootstraps_truncations():
    """The rollout's reward is the reference's shaped reward: scaled, plus
    gamma V(s) where the step was truncated."""
    cfg = recipe_config(CASES["single"])
    trainer = PPOTrainer(StubTask(cfg.num_envs), cfg)
    seen = []
    step_fn = trainer.step_fn

    def recording(carry, action):
        out = step_fn(carry, action)
        seen.append((out[2], out[4]))
        return out

    trainer.step_fn = recording
    for _ in range(40):
        norm_obs, action, logp, value, shaped, done, term, done_prev = trainer.rollout_step()
        reward, trunc = seen[-1]
        want = ref.shaped_rewards(reward, value, trunc, cfg.reward_scale, cfg.gamma)
        assert torch.allclose(shaped, want, atol=1e-6, rtol=0)
        assert torch.equal(done, torch.maximum(term, trunc))
    assert any(float(t.sum()) > 0 for _, t in seen)


@pytest.fixture(scope="module")
def two_rank_runs(tmp_path_factory):
    """Both sharded cases, each a 2-process gloo cluster, run side by side."""
    def launch(case):
        out = tmp_path_factory.mktemp(case)
        port = multiproc.free_port()
        argvs = [[sys.executable, WORKER, "--rank", str(r), "--world", "2", "--coordinator",
                  f"127.0.0.1:{port}", "--case", case, "--out", str(out)] for r in range(2)]
        rcs, outputs = multiproc.spawn(argvs, 300, env=multiproc.worker_env())
        return rcs, outputs, out

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        return dict(zip(("two_minibatches", "empty_share"),
                        pool.map(launch, ("two_minibatches", "empty_share"))))


@pytest.mark.parametrize("case", ["two_minibatches", "empty_share"])
def test_two_rank_update_matches_reference_on_the_union(case, two_rank_runs):
    """Each rank's parameters after a sharded update equal the reference's
    update on both ranks' rollouts together; in ``empty_share`` every
    minibatch is one sequence, so in each optimizer step one rank owns none
    of it and still takes part in every collective."""
    rcs, outputs, out = two_rank_runs[case]
    assert rcs == [0, 0], outputs
    snaps = [torch.load(out / f"rank{r}.pt") for r in range(2)]
    cfg = recipe_config(CASES[case], world=2)
    assert cfg.minibatch_size == 2 * CASES[case]["minibatch"]
    want, want_lr = reference_update(ref, snaps, cfg)
    before = snaps[0]["params"]
    names = list(want)
    for s in snaps:
        assert all(torch.equal(s["params"][k], before[k]) for k in names)
        gap = _rel_gap([s["after"][k] - before[k] for k in names],
                       [want[k] - before[k] for k in names])
        assert gap <= 1e-3, gap
    assert all(torch.equal(snaps[0]["after"][k], snaps[1]["after"][k]) for k in names)
    if case == "empty_share":
        mb_envs = cfg.minibatch_size // cfg.horizon
        assert mb_envs == 1 and cfg.num_envs // mb_envs == 4


# -- spans and counters ----------------------------------------------------------


def test_ppo_spans_record_only_under_the_profiler():
    cfg = recipe_config(CASES["single"])
    trainer = PPOTrainer(StubTask(cfg.num_envs), cfg)
    profiling.clear_spans()
    trainer.train_iteration()
    assert profiling.recorded_spans() == []
    before = dict(t_ppo.COUNTS)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trainer.train_iteration()
    names = [s[0] for s in profiling.recorded_spans()]
    profiling.clear_spans()
    assert names.count("ppo.policy") == cfg.horizon
    assert names.count("ppo.update") == 1
    steps = cfg.epochs * trainer.n_minibatches
    assert names.count("ppo.minibatch") == steps
    assert "ppo.allreduce" not in names             # one process: no collective
    assert t_ppo.COUNTS["updates"] - before["updates"] == 1
    assert t_ppo.COUNTS["optimizer_steps"] - before["optimizer_steps"] == steps
    assert t_ppo.COUNTS["collectives"] == before["collectives"]


# -- the runner ------------------------------------------------------------------------


def test_shipped_navigation_yaml_gives_the_recipe_at_four_ranks():
    cfg = runner.ppo_config_from_yaml(runner.load_yaml_config(RECIPE), num_envs=4096,
                                      world=4)
    want = dict(num_envs=4096, horizon=32, minibatch_size=8192, epochs=4, gamma=0.98,
                gae_lambda=0.95, clip_eps=0.2, value_coef=2.0, entropy_coef=0.0, lr=1e-4,
                lr_schedule="adaptive", kl_threshold=0.016, max_grad_norm=1.0,
                hidden=(256, 128, 64), activation="elu", normalize_advantage=True,
                normalize_obs=True, normalize_value=True, value_bootstrap=True,
                bounds_loss_coef=1e-4, reward_scale=0.1, rnn="gru", rnn_hidden=32,
                rnn_layer_norm=True, seed=10)
    assert {k: getattr(cfg, k) for k in want} == want


@pytest.mark.parametrize("world,mb,envs,want", [(1, 2048, 4096, 2048), (4, 2048, 4096, 8192),
                                                (2, 64, 8, 128), (4, 2048, 16, 512)])
def test_world_scales_the_minibatch(world, mb, envs, want):
    """rl-games' multi-GPU minibatch is one rank's: the global one is world
    times it, within the rollout (envs x 32)."""
    doc = runner.load_yaml_config(RECIPE)
    doc["params"]["config"]["minibatch_size"] = mb
    assert runner.ppo_config_from_yaml(doc, num_envs=envs, world=world).minibatch_size == want


@pytest.mark.parametrize("value,want", [(True, True), (False, False), (None, False)])
def test_rnn_layer_norm_is_mapped(value, want):
    doc = runner.load_yaml_config(RECIPE)
    rnn = doc["params"]["network"]["rnn"]
    if value is None:
        rnn.pop("layer_norm")
    else:
        rnn["layer_norm"] = value
    cfg = runner.ppo_config_from_yaml(doc, num_envs=8)
    assert cfg.rnn_layer_norm is want
    net = PPOTrainer(StubTask(8), dataclasses.replace(cfg, minibatch_size=64)).network
    assert (net.rnn_norm is not None) is want


def test_before_mlp_and_bad_world_are_refused():
    doc = runner.load_yaml_config(RECIPE)
    doc["params"]["network"]["rnn"]["before_mlp"] = True
    with pytest.raises(ValueError, match="before_mlp"):
        runner.ppo_config_from_yaml(doc, num_envs=8)
    with pytest.raises(ValueError, match="world"):
        runner.ppo_config_from_yaml(runner.load_yaml_config(RECIPE), num_envs=8, world=0)


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(runner.CONFIG_DIR)
                                         if f.endswith((".yaml", ".yml"))))
def test_yaml_without_pyyaml_reads_the_shipped_files(name):
    """Every YAML shipped beside the runner reads the same without PyYAML
    (the only reader where PyYAML is not installed)."""
    yaml = pytest.importorskip("yaml")
    text = open(os.path.join(runner.CONFIG_DIR, name)).read()
    assert runner.parse_simple_yaml(text) == yaml.safe_load(text)


@pytest.mark.parametrize("bad", ["a:\n  - 1\n", "a: {b: 1}\n", "a: |\n  x\n", "a: [1, 2\n"])
def test_yaml_outside_the_subset_is_refused(bad):
    with pytest.raises(ValueError):
        runner.parse_simple_yaml(bad)


def test_default_config_keeps_the_plain_gru():
    assert PPOConfig().rnn_layer_norm is False
    net = ActorCriticGRU(OBS_DIM, ACTION_DIM, HIDDEN, UNITS)
    assert net.rnn_norm is None and not any("rnn_norm" in k for k in net.state_dict())


def test_export_refuses_a_layer_norm_policy(tmp_path):
    from aerial_gym_simulator_tpu_torch.sim2real.policy import export_policy_npz
    cfg = recipe_config(CASES["single"])
    trainer = PPOTrainer(StubTask(cfg.num_envs), cfg)
    with pytest.raises(ValueError, match="LayerNorm"):
        export_policy_npz(trainer, str(tmp_path / "p.npz"))
