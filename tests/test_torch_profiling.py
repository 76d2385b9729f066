"""Port parity for utils/profiling.py: Stopwatch, measure_steps (JAX
tests/test_checkpoint_profiling.py:46, on the position task at 8 envs from
a state carried across, the stepped state held against JAX's),
op_breakdown on a small synthetic Chrome trace with device events,
trace() on the CPU, profile_task (its idle share from the traced calls
alone and its table of the simulator's spans), and the command line with
--cpu.

Tolerances: measure_steps' keys equal to JAX's; its final state atol 1e-4
after 7 steps (the bar of tests/test_torch_slice.py for 3 env steps,
state-only here); op_breakdown's table exact against sums made by hand.
"""

import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag
from aerial_gym_simulator_tpu.utils import profiling as jprof

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy, state_from_numpy
from aerial_gym_simulator_tpu_torch.utils import profiling as tprof

N = 8


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Many tiny eager ops: one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_stopwatch_matches_jax_report():
    js, ts = jprof.Stopwatch(), tprof.Stopwatch()
    for sw, mm, ones in ((js, jnp.matmul, jnp.ones), (ts, torch.matmul, torch.ones)):
        for _ in range(2):
            with sw.phase("work"):
                x = mm(ones((64, 64)), ones((64, 64)))
                sw.fence(x)
        with sw.phase("other"):
            sw.fence({"a": [x, (x,)]})
    assert ts.counts == js.counts == {"work": 2, "other": 1}
    assert [line.split()[0] for line in ts.report().splitlines()] == \
        [line.split()[0] for line in js.report().splitlines()]
    assert "(2 calls)" in ts.report()


def test_measure_steps_matches_jax_on_the_position_task():
    jtask = ag.task_registry.make_task("position_setpoint_task", num_envs=N, seed=0)
    jtask.reset()
    j_step, j_carry, _ = jtask.make_step_fn()
    jitted = jax.jit(lambda s, a: j_step(s, a)[0])
    ttask = port.task_registry.make_task("position_setpoint_task", num_envs=N, seed=0,
                                         device="cpu")
    t_step, _, _ = ttask.make_step_fn()
    t_carry = state_from_numpy(record_to_numpy(j_carry), "cpu")
    ttask.target_position = torch.as_tensor(np.array(jtask.target_position))
    want = jprof.measure_steps(jitted, j_carry, jnp.zeros((N, 4)), steps=5, warmup=2,
                               fence=lambda s: s.pos)
    got = tprof.measure_steps(lambda s, a: t_step(s, a)[0], t_carry, torch.zeros((N, 4)),
                              steps=5, warmup=2, fence=lambda s: s.pos)
    assert got.keys() == want.keys()
    assert got["env_steps_per_s"] > 0 and got["wall_s"] > 0
    assert got["env_steps_per_s_per_chip"] == got["env_steps_per_s"]     # one CPU process
    for f in ("pos", "quat", "linvel", "angvel"):
        np.testing.assert_allclose(getattr(got["state"], f).numpy(),
                                   np.asarray(getattr(want["state"], f)), atol=1e-4, err_msg=f)


def _synthetic_trace(path, gz=False):
    """Two iterations of three kernels, a copy and a set, with host events
    that must not count."""
    ev = []
    for it in range(2):
        ev += [
            {"ph": "X", "cat": "kernel", "name": "raycast_kernel<0>", "dur": 1000.0 + it},
            {"ph": "X", "cat": "kernel", "name": "attention_mma_kernel", "dur": 250.0},
            {"ph": "X", "cat": "kernel", "name": "attention_mma_kernel", "dur": 250.0},
            {"ph": "X", "cat": "kernel", "name": "elementwise", "dur": 40.0},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "dur": 8.0},
            {"ph": "X", "cat": "gpu_memset", "name": "Memset", "dur": 2.0},
            {"ph": "X", "cat": "cpu_op", "name": "aten::add", "dur": 5000.0},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "dur": 9.0},
            {"ph": "i", "cat": "kernel", "name": "marker"},
        ]
    data = json.dumps({"traceEvents": ev, "deviceProperties": []})
    if gz:
        with gzip.open(str(path) + ".gz", "wt") as f:
            f.write(data)
    else:
        path.write_text(data)


@pytest.mark.parametrize("gz", [False, True], ids=["json", "json.gz"])
def test_op_breakdown_reads_device_events(tmp_path, gz):
    _synthetic_trace(tmp_path / "trace.json", gz=gz)
    rows, total = tprof.op_breakdown(str(tmp_path), iters=2, top_k=3)
    per_iter = {"raycast_kernel<0>": 1000.5, "attention_mma_kernel": 500.0, "elementwise": 40.0,
                "Memcpy HtoD": 8.0, "Memset": 2.0}
    s = sum(per_iter.values())
    assert total == pytest.approx(s / 1e3)
    assert [r[0] for r in rows] == ["raycast_kernel<0>", "attention_mma_kernel", "elementwise"]
    for name, ms, frac in rows:
        assert ms == pytest.approx(per_iter[name] / 1e3)
        assert frac == pytest.approx(per_iter[name] / s)
    with pytest.raises(FileNotFoundError):
        tprof.op_breakdown(str(tmp_path / "empty"))


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with tprof.trace(str(tmp_path)) as d:
        torch.ones(8, 8) @ torch.ones(8, 8)
    data = json.loads((tmp_path / tprof.TRACE_FILE).read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert d == str(tmp_path) and names & {"aten::matmul", "aten::mm"}
    rows, total = tprof.op_breakdown(str(tmp_path))
    assert rows == [] and total == 0.0       # no device events on the CPU


def test_profile_task_steps_the_task_and_keeps_its_carry(tmp_path):
    task = port.task_registry.make_task("position_setpoint_task", num_envs=N, seed=0,
                                        device="cpu")
    rep = tprof.profile_task(task, iters=2, trace_dir=str(tmp_path), echo=False)
    assert rep["calls"] == 5 and rep["num_envs"] == N and rep["wall_ms"] > 0
    assert rep["env_steps_per_s"] == pytest.approx(N / rep["wall_ms"] * 1e3)
    assert rep["rows"] == [] and rep["device_ms"] == 0.0
    assert (tmp_path / tprof.TRACE_FILE).exists()
    assert int(task.state.sim_steps.max()) >= 1
    assert torch.isfinite(task.state.pos).all()


def test_command_line_on_the_cpu(capsys, tmp_path):
    rep = tprof.main(["--cpu", "--num_envs", "8", "--iters", "2", "--trace_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "position_setpoint_task env step @ 8 envs:" in out
    assert "ms wall" in out and "env-steps/s" in out and "ms summed device ops" in out
    assert "ms/step" in out and rep["calls"] == 5
    ppo = tprof.main(["--cpu", "--num_envs", "8", "--iters", "1", "--ppo", "--horizon", "4",
                      "--trace_dir", str(tmp_path / "ppo")])
    assert "PPO iteration @ 8 envs" in capsys.readouterr().out
    assert ppo["calls"] == 3 and ppo["env_steps_per_s"] == pytest.approx(32 / ppo["wall_ms"] * 1e3)


def test_profile_task_reports_idle_share_and_spans(tmp_path):
    """The idle share comes from the traced calls alone (no device on the
    CPU: all idle); the span table holds the physics step, its substeps'
    layers inside it and the reset, per step, and what lies outside."""
    task = port.task_registry.make_task("position_setpoint_task", num_envs=N, seed=0,
                                        device="cpu")
    rep = tprof.profile_task(task, iters=2, trace_dir=str(tmp_path), echo=False)
    assert rep["idle_share"] == 1.0
    spans = rep["spans"]
    assert list(spans)[:2] == ["physics", "physics.control"] and "(outside)" in spans
    assert spans["physics"]["calls"] == 1.0 and spans["reset"]["calls"] == 1.0
    n_sub = spans["physics.control"]["calls"]
    assert n_sub >= 1 and spans["physics.integrate"]["calls"] == spans["physics.contact"][
        "calls"] == n_sub
    inner = sum(spans[k]["host_ms"] for k in ("physics.control", "physics.integrate",
                                              "physics.contact"))
    assert 0.0 < inner <= spans["physics"]["host_ms"]
    for t in spans.values():
        assert t["device_ms"] == 0.0 and t["launches"] == 0
        assert t["idle_ms"] == pytest.approx(t["host_ms"])      # no device: all idle
    assert tprof.recorded_spans()                   # kept for the caller to read


def test_profile_task_spans_of_the_navigation_step(tmp_path):
    from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
        BaseDepthCameraConfig)
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import build_ray_sensor_params
    from aerial_gym_simulator_tpu_torch.sim.structs import replace

    task = port.task_registry.make_task("navigation_task", num_envs=2, seed=0, device="cpu")
    task.params = replace(task.params, camera=build_ray_sensor_params(
        BaseDepthCameraConfig(height=12, width=16), "cpu"))
    task.sim_env.params = task.params
    rep = tprof.profile_task(task, iters=1, trace_dir=str(tmp_path), echo=False)
    spans = rep["spans"]
    assert list(spans) == ["task", "physics", "physics.control", "physics.integrate",
                           "physics.contact", "reset", "render", "encode", "(outside)"]
    assert all(spans[k]["calls"] == 1.0 for k in ("task", "physics", "reset", "render",
                                                     "encode"))
    assert spans["physics.control"]["calls"] == 10.0
    parts = sum(spans[k]["host_ms"] for k in ("physics", "reset", "render", "encode"))
    assert parts <= spans["task"]["host_ms"]


def test_command_line_prints_the_span_table(capsys, tmp_path):
    tprof.main(["--cpu", "--num_envs", "8", "--iters", "1", "--trace_dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "device idle share 1.000 in the traced calls" in out
    table = out[out.index("span "):].splitlines()
    assert "launches" in table[0] and "idle ms" in table[0]
    assert [line.split()[0] for line in table[1:3]] == ["physics", "physics.control"]
    assert table[-1].split()[0] == "(outside)"


def test_command_line_flags_match_jax():
    """JAX's flags and defaults, plus --cpu."""
    args = tprof.build_parser().parse_args([])
    assert (args.task, args.num_envs, args.iters, args.top, args.ppo, args.horizon,
            args.trace_dir, args.cpu) == ("position_setpoint_task", 1024, 10, 20, False, 32,
                                          None, False)
