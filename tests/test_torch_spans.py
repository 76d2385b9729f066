"""The simulator's spans (``utils/profiling.span``): nothing recorded and one
shared no-op context with no profiler running; under ``torch.profiler``
the task step, the env step and the render record their layers, nested as
the step runs them; and the arithmetic that puts a trace's device time,
launching calls and idle time down to each span."""

import ast
import inspect
from collections import Counter

import pytest
import torch

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
    BaseDepthCameraConfig)
from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import build_ray_sensor_params
from aerial_gym_simulator_tpu_torch.sim.structs import replace
from aerial_gym_simulator_tpu_torch.utils import profiling as prof

CAM = dict(height=12, width=16)
PHYSICS_CHILDREN = ("physics.control", "physics.integrate", "physics.contact")


def _recording(fn):
    """Run ``fn`` under torch.profiler (CPU activity) -> the spans it recorded."""
    prof.clear_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fn()
    spans = prof.recorded_spans()
    prof.clear_spans()
    return spans


def _edges(spans):
    """Counter of (span, parent span) over the recorded spans."""
    return Counter((n, spans[p][0] if p is not None else None) for n, p, _, _ in spans)


def _small_camera(params):
    return replace(params, camera=build_ray_sensor_params(BaseDepthCameraConfig(**CAM), "cpu"))


@pytest.fixture(scope="module")
def nav_task():
    task = port.task_registry.make_task("navigation_task", num_envs=2, seed=0, device="cpu")
    task.params = _small_camera(task.params)
    task.sim_env.params = task.params
    task.reset()
    return task


def test_span_off_is_one_shared_context_and_records_nothing(nav_task):
    prof.clear_spans()
    assert not torch.autograd.profiler._is_profiler_enabled
    a, b = prof.span("physics"), prof.span("render")
    assert a is b
    with a:
        pass
    nav_task.step(torch.zeros((2, 4)))
    assert prof.recorded_spans() == []


def test_navigation_step_records_its_layers_nested(nav_task):
    spans = _recording(lambda: nav_task.step(torch.zeros((2, 4))))
    edges = _edges(spans)
    substeps = nav_task.params.env.substep_mean
    assert substeps == 10
    want = {("task", None): 1, ("physics", "task"): 1, ("reset", "task"): 1,
            ("render", "task"): 1, ("encode", "task"): 1,
            **{(c, "physics"): substeps for c in PHYSICS_CHILDREN}}
    assert dict(edges) == want
    for name, parent, t0, t1 in spans:
        assert t1 is not None and t1 >= t0
        if parent is not None:
            p = spans[parent]
            assert p[2] <= t0 and t1 <= p[3], (name, p[0])
    # the children of each span follow one another in time
    kids = [s for s in spans if s[0] in PHYSICS_CHILDREN]
    assert all(a[3] <= b[2] for a, b in zip(kids, kids[1:]))
    assert [s[0] for s in kids[:3]] == list(PHYSICS_CHILDREN)


def test_env_manager_step_and_render_record_physics_reset_render():
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_camera", "lee_velocity_control",
                                      device="cpu", num_envs=2, seed=1)
    env.params = _small_camera(env.params)

    def step():
        env.step(torch.zeros((2, 4)))
        env.post_reward_calculation_step()
        env.render()

    edges = _edges(_recording(step))
    assert edges[("physics", None)] == 1 and edges[("reset", None)] == 1
    assert edges[("render", None)] == 1
    kids = {k[0]: v for k, v in edges.items() if k[1] == "physics"}
    assert set(kids) == set(PHYSICS_CHILDREN) and len(set(kids.values())) == 1
    assert sum(edges.values()) == 3 + 3 * kids["physics.control"]


def test_same_name_inside_records_once_and_the_list_is_bounded(monkeypatch):
    def nested():
        with prof.span("render"):
            with prof.span("render"):
                with prof.span("physics"):
                    pass

    spans = _recording(nested)
    assert [(n, p) for n, p, _, _ in spans] == [("render", None), ("physics", 0)]
    monkeypatch.setattr(prof, "MAX_SPANS", 3)
    spans = _recording(lambda: [nested() for _ in range(3)])
    assert len(spans) == 3


def test_the_span_code_reads_nothing_back_and_never_synchronises():
    """No host read-back or synchronisation in the span code: with the
    profiler off or on, a span adds none to the step."""
    for obj in (prof.span, prof.spanned, prof._Span):
        for node in ast.walk(ast.parse(inspect.getsource(obj).lstrip())):
            if isinstance(node, ast.Attribute):
                assert node.attr not in ("item", "tolist", "nonzero", "cpu", "numpy",
                                         "synchronize"), (obj, node.attr)


# a synthetic trace: spans task [0, 100] > physics [10, 60] > control [12, 30],
# contact [35, 55]; render [70, 90] inside task
SPANS = [("task", None, 0.0, 100.0), ("physics", 0, 10.0, 60.0),
         ("physics.control", 1, 12.0, 30.0), ("physics.contact", 1, 35.0, 55.0),
         ("render", 0, 70.0, 90.0)]
DEVICE = [
    ("k_control", 14.0, 4.0, 13.0),        # launched inside control
    ("k_edge", 31.0, 2.0, 30.0),           # launched on control's end: inside it
    ("k_physics", 33.0, 2.0, 32.0),        # physics' own
    ("g1", 40.0, 1.0, 36.0),               # one graph launch, three kernels: one call
    ("g2", 41.0, 1.0, 36.0),
    ("g3", 42.0, 1.0, 36.0),
    ("k_render", 75.0, 10.0, 71.0),
    ("k_outside", 105.0, 3.0, 101.0),      # launched after the task: outside
    ("k_unmatched", 50.0, 1.0, None),      # no launch found: belongs to no span
]


def _busy(t0, t1):
    return prof._merge([(ts, ts + d) for _, ts, d, _ in DEVICE if ts >= t0 and ts + d <= t1])


def test_span_times_put_device_launches_and_idle_down_to_spans():
    rows, outside = prof.span_times(SPANS, DEVICE, _busy(0.0, 110.0), 0.0, 110.0)
    by = {r["name"]: r for r in rows}
    assert by["physics.control"]["device_us"] == pytest.approx(6.0)
    assert by["physics.control"]["launches"] == 2
    assert by["physics.contact"]["launches"] == 1 and by["physics.contact"]["device_us"] == 3.0
    assert by["physics"]["device_us"] == pytest.approx(6.0 + 2.0 + 3.0)
    assert by["physics"]["launches"] == 4
    assert by["task"]["launches"] == 5 and by["render"]["device_us"] == 10.0
    assert outside == dict(device_us=3.0, launches=1, idle_us=pytest.approx(7.0))
    # busy: [14,18] [31,33] [33,35] [40,43] [50,51] [75,85] [105,108]
    assert by["physics"]["idle_us"] == pytest.approx(50.0 - 4 - 4 - 3 - 1)
    assert by["physics.control"]["idle_us"] == pytest.approx(18.0 - 4.0)
    assert by["render"]["idle_us"] == pytest.approx(10.0)
    assert by["task"]["idle_us"] == pytest.approx(100.0 - 4 - 4 - 3 - 1 - 10)


def test_span_times_idle_straddling_the_window_edges():
    # the window [20, 88] cuts task, physics, control and render: idle counts
    # inside it only
    rows, outside = prof.span_times(SPANS, DEVICE, _busy(20.0, 88.0), 20.0, 88.0)
    by = {r["name"]: r for r in rows}
    assert by["physics.control"]["idle_us"] == pytest.approx(10.0)      # [20, 30]
    assert by["physics"]["idle_us"] == pytest.approx(40.0 - 4 - 3 - 1)
    assert by["render"]["idle_us"] == pytest.approx(18.0 - 10.0)
    assert by["task"]["idle_us"] == pytest.approx(68.0 - 4 - 3 - 1 - 10)
    assert outside["idle_us"] == pytest.approx(0.0)


def _window_events(offset):
    """Chrome-trace events of profile_task's window [0, 110] with the spans'
    ranges at ``offset`` from the host clock, the runtime calls and the
    device events."""
    ev = [dict(ph="X", cat="user_annotation", name=prof.WINDOW, ts=0.0, dur=110.0),
          dict(ph="X", cat="user_annotation", name="Optimizer.step#Adam.step", ts=1.0, dur=1.0)]
    for name, _, s, e in SPANS:
        ev.append(dict(ph="X", cat="user_annotation", name=name, ts=s - 0.5, dur=e - s + 1.0))
    seen = {}
    for k, (name, ts, dur, launched) in enumerate(DEVICE):
        corr = None
        if launched is not None:
            corr = seen.setdefault(launched, len(seen) + 1)
            ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=launched,
                           dur=0.5, args={"correlation": corr}))
        ev.append(dict(ph="X", cat="kernel", name=name, ts=ts, dur=dur,
                       args={"correlation": corr} if corr else {}))
    return ev


def test_read_window_matches_the_spans_to_their_ranges():
    off = 5000.0
    recorded = [(n, p, s - off, e - off) for n, p, s, e in SPANS]
    w = prof.read_window(_window_events(off), recorded)
    assert (w["t0"], w["t1"]) == (0.0, 110.0)
    # each span where its range lies (a range opens just before the span's
    # clock reading and closes just after it), with its parent
    assert w["spans"] == [(n, p, s - 0.5, e + 0.5) for n, p, s, e in SPANS]
    table = prof.span_table(w, iters=2)
    assert list(table) == ["task", "physics", "physics.control", "physics.contact", "render",
                           "(outside)"]
    assert table["physics"]["calls"] == 0.5 and table["physics"]["launches"] == 2.0
    assert table["(outside)"]["launches"] == 0.5
    extra = [("render", 0, 95.0 - off, 96.0 - off)]       # a span with no range of its own
    assert prof.read_window(_window_events(off), recorded + extra)["spans"] is None
    assert prof.read_window(_window_events(off)[1:], recorded) is None
    assert prof.span_table(None) == {}
