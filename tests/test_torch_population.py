"""Population training (rl/population.py), the port against itself at the
configuration of tests/test_population.py (8 envs, horizon 4, minibatch 32,
2 epochs, seed 3): member 0 equals a standalone PPOTrainer bit for bit, per-
member learning rates, the best member's checkpoint, the PBT exploit /
explore step, PBT training, the validation errors and the command line.

The JAX package's population is one vmapped program whose contract is the
same per-member equality; its members run a different random stream (JAX
keys), so the port is held to that contract on its own trainers.
"""

import dataclasses

import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.rl import population as t_pop
from aerial_gym_simulator_tpu_torch.rl.population import PopulationTrainer
from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from aerial_gym_simulator_tpu_torch.sim2real.policy import export_policy_npz, load_policy_npz

CFG = dict(num_envs=8, horizon=4, minibatch_size=32, epochs=2, seed=3)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Many small eager ops: one intra-op thread while this module runs, so
    that the suite's workers do not contend."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _factory(s):
    return port.task_registry.make_task("position_setpoint_task", num_envs=8, seed=s,
                                        device="cpu")


def _params(trainer):
    return [p.detach().clone() for p in trainer.network.parameters()]


def test_member_matches_standalone_trainer():
    """Member 0 of a 2-member population reproduces a standalone PPOTrainer
    with its seed bit for bit after two iterations: parameters, Adam state,
    lr, normalizer and env carry; the two members differ."""
    cfg = PPOConfig(**CFG)
    pop = PopulationTrainer(_factory, cfg, num_seeds=2)
    hist = pop.train(total_env_steps=2 * 8 * 4, log_every=1)
    solo = PPOTrainer(_factory(3), dataclasses.replace(cfg, seed=3))
    solo.train(total_env_steps=2 * 8 * 4, log_every=1)
    m0 = pop.members[0]
    for a, b in zip(_params(m0), _params(solo)):
        assert torch.equal(a, b)
    for pa, pb in zip(m0.network.parameters(), solo.network.parameters()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(m0.optimizer.state[pa][k], solo.optimizer.state[pb][k])
    assert torch.equal(m0.lr, solo.lr)
    assert all(torch.equal(m0.norm[k], solo.norm[k]) for k in solo.norm)
    assert torch.equal(m0.env_carry.pos, solo.env_carry.pos)
    diff = max((a - b).abs().max().item()
               for a, b in zip(_params(m0), _params(pop.members[1])))
    assert diff > 1e-6
    assert [m["iter"] for m in hist] == [0, 1]
    assert hist[-1]["reward_mean"].shape == (2,) and np.isfinite(hist[-1]["reward_mean"]).all()
    assert hist[-1]["env_steps"] == 64 and hist[-1]["env_steps_per_s"] > 0
    assert pop.task.state is m0.env_carry           # train() hands each task its carry


def test_member_lrs_and_best_checkpoint(tmp_path):
    """Per-member initial lrs land in each member's own lr tensor; the best
    member's checkpoint loads in a standalone trainer, acts as the member
    does, and exports for deployment."""
    cfg = PPOConfig(**CFG)
    pop = PopulationTrainer(_factory, cfg, num_seeds=2, member_lrs=[1e-4, 1e-3])
    np.testing.assert_allclose([m.lr.item() for m in pop.members], [1e-4, 1e-3], rtol=1e-6)
    assert pop.members[0].lr is not pop.members[1].lr
    hist = pop.train(total_env_steps=2 * 8 * 4, log_every=1)
    assert hist[-1]["reward_mean"].shape == (2,)
    best = pop.best_member()
    assert best == int(np.argmax(hist[-1]["reward_mean"]))
    ckpt = str(tmp_path / "best.ckpt")
    pop.member_checkpoint(best, ckpt)
    solo = PPOTrainer(_factory(0), PPOConfig(**CFG))
    solo.load_checkpoint(ckpt)
    obs = torch.from_numpy(np.random.RandomState(0).standard_normal((4, 13)).astype(np.float32))
    a_solo = solo.act(obs, deterministic=True)
    assert torch.equal(a_solo, pop.members[best].act(obs, deterministic=True))
    npz = str(tmp_path / "best.npz")
    export_policy_npz(ckpt, npz)
    np.testing.assert_allclose(load_policy_npz(npz, device="cpu")(obs).numpy(),
                               a_solo.numpy(), atol=1e-5)


def test_pbt_step_exploits_and_explores():
    """The worst member takes the best member's learner state (parameters,
    Adam state, lr, normalizer) in its own tensors, and its lr is perturbed
    within [min_lr, max_lr]; the winner's lr is untouched; the loser's env
    carry and generators stay its own; training goes on after the step."""
    cfg = PPOConfig(**CFG)
    pop = PopulationTrainer(_factory, cfg, num_seeds=2, member_lrs=[2e-4, 8e-4])
    pop.train(total_env_steps=8 * 4, log_every=1)
    w, l = pop.members
    carry_before, gen_before = l.env_carry.pos.clone(), l.generator.get_state()
    sim_gen_before = l.env_carry.rng.get_state()
    lr_w = w.lr.item()
    events = pop._pbt_step(np.array([1.0, 0.0]), np.random.default_rng(0))  # member 1 worst
    assert events and events[0][:2] == (1, 0)
    for a, b in zip(_params(w), _params(l)):
        assert torch.equal(a, b)
    for pw, pl in zip(w.network.parameters(), l.network.parameters()):
        sw, sl = w.optimizer.state[pw], l.optimizer.state[pl]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sw[k], sl[k]) and sw[k] is not sl[k]
    assert all(torch.equal(w.norm[k], l.norm[k]) and w.norm[k] is not l.norm[k]
               for k in w.norm)
    assert w.lr.item() == lr_w                                    # winner untouched
    assert l.lr.item() == pytest.approx(lr_w * events[0][2])     # copied + perturbed
    assert w.lr is not l.lr
    assert torch.equal(l.env_carry.pos, carry_before)
    assert torch.equal(l.generator.get_state(), gen_before)
    assert torch.equal(l.env_carry.rng.get_state(), sim_gen_before)
    pop.train(total_env_steps=8 * 4, log_every=1)


def test_pbt_before_any_update_and_lr_clip():
    """PBT on fresh members (no Adam state yet) copies that state too, and
    the perturbed lr is clipped to [min_lr, max_lr]."""
    cfg = PPOConfig(**CFG, max_lr=2.2e-4)
    pop = PopulationTrainer(_factory, cfg, num_seeds=4, member_lrs=[2e-4, 1e-4, 1e-4, 1e-4])
    events = pop._pbt_step(np.array([3.0, 0.0, 1.0, 2.0]), np.random.default_rng(1),
                           fraction=0.25, lr_perturb=(1.25,))
    assert events == [(1, 0, 1.25)]
    assert pop.members[1].lr.item() == pytest.approx(2.2e-4)
    assert not pop.members[1].optimizer.state
    for a, b in zip(_params(pop.members[0]), _params(pop.members[1])):
        assert torch.equal(a, b)


def test_train_with_pbt_runs():
    cfg = PPOConfig(**CFG)
    pop = PopulationTrainer(_factory, cfg, num_seeds=2)
    hist = pop.train(total_env_steps=3 * 8 * 4, log_every=1, pbt_every=1)
    assert np.isfinite(hist[-1]["reward_mean"]).all() and len(hist) == 3


def test_validation_errors():
    with pytest.raises(ValueError, match="adaptive"):
        PopulationTrainer(_factory, PPOConfig(**CFG, lr_schedule="fixed"), num_seeds=2,
                          member_lrs=[1e-4, 1e-3])
    with pytest.raises(ValueError, match="num_seeds"):
        PopulationTrainer(_factory, PPOConfig(**CFG), num_seeds=2, member_lrs=[1e-4])
    pop = PopulationTrainer(_factory, PPOConfig(**CFG, lr_schedule="fixed"), num_seeds=2)
    with pytest.raises(ValueError, match="adaptive"):
        pop._pbt_step(np.array([1.0, 0.0]), np.random.default_rng(0))
    pop = PopulationTrainer(_factory, PPOConfig(**CFG), num_seeds=2)
    with pytest.raises(ValueError, match="0.5"):
        pop._pbt_step(np.array([1.0, 0.0]), np.random.default_rng(0), fraction=0.75)
    with pytest.raises(RuntimeError, match="train"):
        pop.best_member()
    # outside a process group the population is a world of one: kept whole
    assert pop.shard().size == 1 and pop.local == [0, 1] and pop.layout is None


def test_seed_dependent_task_params_are_refused():
    def factory(s):
        task = _factory(s)
        if s != 3:
            task.params = dataclasses.replace(task.params, dt=task.params.dt * 2)
        return task

    with pytest.raises(ValueError, match="seed-independent"):
        PopulationTrainer(factory, PPOConfig(**CFG), num_seeds=2)


def test_command_line(tmp_path, capsys):
    ckpt = str(tmp_path / "b.ckpt")
    pop = t_pop.main(["--cpu", "--num_envs", "8", "--num_seeds", "2", "--horizon", "4",
                      "--total_steps", "64", "--lr_sweep", "1e-4", "1e-3", "--pbt_every", "1",
                      "--save_best", ckpt])
    assert len(pop.members) == 2 and pop.last_metrics["reward_mean"].shape == (2,)
    assert "best member:" in capsys.readouterr().out
    solo = PPOTrainer(_factory(0), PPOConfig(**CFG))
    solo.load_checkpoint(ckpt)
    # --env_devices needs --multichip; --multichip outside a process group
    # is a world of one (the sharded runs: tests/test_torch_parallel.py)
    with pytest.raises(SystemExit) as e:
        t_pop.parse_args(["--env_devices", "2"])
    assert e.value.code == 2 and "--multichip" in capsys.readouterr().err
    assert t_pop.parse_args(["--multichip", "--env_devices", "2"]).env_devices == 2


@pytest.mark.parametrize("via", ["shard", "train"])
def test_deferred_build_equals_the_whole_build(via):
    """build=False builds no member at construction; in a world of one,
    shard() (or train() itself) builds them all, and the population then
    trains bit for bit as one built whole (member lrs included)."""
    built = []

    def factory(s):
        built.append(s)
        return _factory(s)

    cfg = PPOConfig(**CFG)
    pop = PopulationTrainer(factory, cfg, num_seeds=2, member_lrs=[1e-4, 1e-3], build=False)
    assert built == [] and pop.members == [None, None]
    if via == "shard":
        assert pop.shard().size == 1 and built == [3, 4]
    pop.train(total_env_steps=2 * 8 * 4, log_every=1)
    ref = PopulationTrainer(_factory, cfg, num_seeds=2, member_lrs=[1e-4, 1e-3])
    ref.train(total_env_steps=2 * 8 * 4, log_every=1)
    assert built == [3, 4]
    for m, r in zip(pop.members, ref.members):
        assert all(torch.equal(a, b) for a, b in zip(_params(m), _params(r)))
        assert torch.equal(m.lr, r.lr)
