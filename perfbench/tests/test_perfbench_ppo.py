"""The four-card navigation PPO cell (``nav_vit.ppo.4x1k``) on the CPU at a
tiny size: four ranks over gloo, 4 envs each, a 27x48 camera, one rank's
minibatch of 2 sequences (a global minibatch of 8 of the 16 sequences, two
optimizer steps an epoch). ``correct`` must come out true on a sound run and
false for each fault planted in every rank: a missing all-reduce (each rank
keeps its own sums), the GRU's LayerNorm dropped, the global minibatch
taken for one rank's. A fault reaches the spawned ranks through a
``sitecustomize`` module on their ``PYTHONPATH`` and this process through
``monkeypatch``. The control, the references at the next precision below,
fails a limit; a port that cannot build the recipe is refused before any
rank is spawned."""

from __future__ import annotations

import os
import time

import pytest

CELL = "nav_vit.ppo.4x1k"
SMALL = dict(envs=4, camera_hw=(27, 48), minibatch=64)
SEED = 5 * 2 ** 32 + 77

# each fault as the code that plants it; ``patch(obj, name, value)`` is
# monkeypatch.setattr here and setattr in a spawned rank
FAULTS = {
    "no_allreduce": """
from aerial_gym_simulator_tpu_torch.rl import ppo
orig_all_reduce = ppo._all_reduce
def _all_reduce(x, shard):
    orig_all_reduce(x.clone(), shard)      # the collective runs; its sum is dropped
    return x
patch(ppo, "_all_reduce", _all_reduce)
""",
    "no_layer_norm": """
from aerial_gym_simulator_tpu_torch.rl.networks import ActorCriticGRU
orig_forward = ActorCriticGRU.forward
def forward(self, obs, h):
    norm = self.rnn_norm
    self.rnn_norm = None
    try:
        return orig_forward(self, obs, h)
    finally:
        self.rnn_norm = norm
patch(ActorCriticGRU, "forward", forward)
""",
    "rank_minibatch": """
from aerial_gym_simulator_tpu_torch.rl_training.rl_games import runner
orig_from_yaml = runner.ppo_config_from_yaml
def ppo_config_from_yaml(doc, num_envs=None, seed=None, world=1):
    return orig_from_yaml(doc, num_envs, seed, 1)  # the YAML's minibatch read as the global one
patch(runner, "ppo_config_from_yaml", ppo_config_from_yaml)
""",
}


def _run(**overrides):
    from perfbench.harness import core
    result, compared, _ = core.run_cell(CELL, SEED, 0.2, False, time.perf_counter(),
                                        device="cpu", overrides=dict(SMALL, **overrides))
    return result, dict((k, v) for k, v, _ in compared)


@pytest.mark.parametrize("ranks", [4, 1])
def test_sound_run_is_correct(ranks):
    """The cell's four ranks, and a world of one (a rank's rehearsal on one
    card, where the trainer has no shard to wait on at the end)."""
    result, numbers = _run(ranks=ranks)
    assert result["correct"], numbers
    assert result["device"]["count"] == 4 and result["failed"] == 0
    assert set(numbers) >= {"policy_gap", "advantage_gap", "update_gap", "state_gap"}


@pytest.mark.parametrize("fault,caught_by", [("no_allreduce", "update_gap"),
                                             ("no_layer_norm", "policy_gap"),
                                             ("rank_minibatch", "update_gap")])
def test_fault_in_every_rank_is_caught(fault, caught_by, monkeypatch, tmp_path):
    exec(FAULTS[fault], {"patch": monkeypatch.setattr})
    (tmp_path / "sitecustomize.py").write_text("patch = setattr\n" + FAULTS[fault])
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(filter(None, [
        str(tmp_path), os.environ.get("PYTHONPATH")])))
    result, numbers = _run()
    assert not result["correct"], numbers
    from perfbench.harness import core
    limits = core.load_cell(CELL)[3]
    assert numbers[caught_by] > limits[caught_by], numbers


def test_control_is_refused():
    from perfbench.calibrate import readings
    from perfbench.harness import core
    limits = core.load_cell(CELL)[3]
    out = readings(CELL, SEED, 0.2, device="cpu", overrides=SMALL)
    failed = [k for k, v in out["control"].items() if k in limits and not v <= limits[k]]
    assert failed, out["control"]
    assert all(v <= limits[k] for k, v in out["program"].items() if k in limits), out["program"]


def test_port_without_the_recipe_is_refused_before_any_rank(monkeypatch):
    """As on the commit before the recipe's options: ``ppo_config_from_yaml``
    without ``world``."""
    import subprocess

    from aerial_gym_simulator_tpu_torch.rl_training.rl_games import runner
    from perfbench.harness import core

    def old_from_yaml(doc, num_envs=None, seed=None):
        raise AssertionError("not reached")

    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(runner, "ppo_config_from_yaml", old_from_yaml)
    monkeypatch.setattr(subprocess, "Popen", no_spawn)
    with pytest.raises(core.Refused, match="recipe"):
        core.run_cell(CELL, SEED, 0.2, False, time.perf_counter(), device="cpu",
                      overrides=SMALL)
