"""``correct`` must come out false when the timed path is broken underneath,
and true when it is not. Each test drives a whole run of a cell on the CPU
at a tiny size (4 envs, a 27x48 camera), skipping only the look for a card,
with one fault planted in the port: a step that returns its state unchanged,
half of the batch left out of the step, an answer altered where it is
produced. The control test puts the references at the next precision below
the configuration's in the program's place and sees the cell's limits
refuse it. (The cells run on one card: no exchange between cards to leave
out.)"""

from __future__ import annotations

import time

import pytest
import torch

CELLS = ("obstacle_camera.16k", "nav_vit.serve.4k")
SMALL = dict(envs=4, camera_hw=(27, 48))
SEED = 5 * 2 ** 32 + 77           # above 32 bits, as no builder of the port takes


def _run(cell, seed=SEED):
    from perfbench.harness import core
    result, compared, _ = core.run_cell(cell, seed, 0.2, False, time.perf_counter(),
                                        device="cpu", overrides=SMALL)
    return result, dict((k, v) for k, v, _ in compared)


def _patch(monkeypatch, module, name, make):
    orig = getattr(module, name)
    monkeypatch.setattr(module, name, make(orig))


def _unchanged(monkeypatch):
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    from aerial_gym_simulator_tpu_torch.sim.structs import replace

    def make(orig):
        def env_step(params, state, action, n_substeps=None):
            return replace(state, sim_steps=state.sim_steps + 1)
        return env_step
    _patch(monkeypatch, dynamics, "env_step", make)


def _half_batch(monkeypatch):
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    from aerial_gym_simulator_tpu_torch.sim.structs import replace

    def make(orig):
        def env_step(params, state, action, n_substeps=None):
            new = orig(params, state, action, n_substeps)
            half = torch.arange(state.num_envs) >= state.num_envs // 2
            keep = {k: torch.where(half.reshape((-1,) + (1,) * (getattr(new, k).dim() - 1)),
                                   getattr(state, k), getattr(new, k))
                    for k in ("pos", "quat", "linvel", "angvel", "motor_thrust")}
            return replace(new, **keep)
        return env_step
    _patch(monkeypatch, dynamics, "env_step", make)


def _depth_altered(monkeypatch):
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda

    def make(orig):
        def raycast(*args, **kwargs):
            out = orig(*args, **kwargs)
            return (out[0] + 0.05,) + tuple(out[1:])
        return raycast
    _patch(monkeypatch, raycast_cuda, "raycast", make)


def _latents_altered(monkeypatch):
    from aerial_gym_simulator_tpu_torch.models.vae import FrozenImageEncoder

    def make(orig):
        def encode(self, images, generator=None, noise=None):
            return orig(self, images, generator, noise) + 0.1
        return encode
    _patch(monkeypatch, FrozenImageEncoder, "encode", make)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    result, numbers = _run(cell)
    assert result["correct"], numbers
    assert result["attempted"] == len(numbers) and result["failed"] == 0


FAULTS = [(cell, name) for cell in CELLS for name in ("unchanged", "half_batch", "depth")]
FAULTS.append(("nav_vit.serve.4k", "latents"))


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault, monkeypatch):
    {"unchanged": _unchanged, "half_batch": _half_batch, "depth": _depth_altered,
     "latents": _latents_altered}[fault](monkeypatch)
    result, numbers = _run(cell)
    assert not result["correct"], numbers
    assert result["failed"] >= 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_refused(cell):
    """The references at the control's precision, in the program's place,
    fail at least one of the cell's limits."""
    from perfbench.calibrate import readings
    from perfbench.harness import core
    limits = core.load_cell(cell)[3]
    out = readings(cell, SEED, 0.2, device="cpu", overrides=SMALL)
    failed = [k for k, v in out["control"].items() if k in limits and not v <= limits[k]]
    assert failed, out["control"]
    assert all(v <= limits[k] for k, v in out["program"].items() if k in limits), out["program"]


def test_state_only_traffic(monkeypatch):
    """A traffic file of kind ``env_camera`` with ``"render": false`` steps
    the physics alone: no image is compared, the state still is, and a step
    that returns its state unchanged is still caught."""
    from perfbench.harness import core
    load = core.load_cell

    def state_only(name):
        cell, cfg, traffic, limits, e2e, per_layer = load(name)
        limits = {k: v for k, v in limits.items() if "depth" not in k and "seg" not in k}
        return cell, cfg, dict(traffic, render=False), limits, e2e, per_layer

    monkeypatch.setattr(core, "load_cell", state_only)
    result, numbers = _run("obstacle_camera.16k")
    assert result["correct"], numbers
    assert set(numbers) == {"state_gap", "crash_mismatch", "reset_kept_mismatch"}
    _unchanged(monkeypatch)
    result, numbers = _run("obstacle_camera.16k")
    assert not result["correct"], numbers


def test_kind_on_several_cards_reports_its_own_peak_and_busy_time(monkeypatch):
    """The run takes a kind's ``peak_bytes()`` and ``busy_s(trace)`` where it
    has them (a kind whose ranks run on several cards), its own readings
    elsewhere."""
    import types

    from perfbench.harness import core
    load_kind = core.load_kind

    def with_hooks(name):
        kind = load_kind(name)

        class Loop(kind.Loop):
            def peak_bytes(self):
                return 123

            def busy_s(self, trace):
                return 0.5 * trace.busy_s + 1.0

        return types.SimpleNamespace(Loop=Loop, Check=kind.Check)

    monkeypatch.setattr(core, "load_kind", with_hooks)
    for trace in (False, True):
        result, _, _ = core.run_cell("obstacle_camera.16k", SEED, 0.2, trace, time.perf_counter(),
                                     device="cpu", overrides=SMALL)
        assert result["device"]["memory_peak_bytes"] == 123
        assert ("busy_s" in result["device"]) == trace
        if trace:
            assert result["device"]["busy_s"] >= 1.0
