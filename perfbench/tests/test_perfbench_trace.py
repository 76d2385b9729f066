"""Reading a device trace: the spans' synchronisations delimit the layers,
kernels go to the span that launched them, the idle share is the slice's
wall time left over by the union of the device's intervals."""

from __future__ import annotations

import pytest


def _events():
    ev = []
    corr = [0]

    def sync(ts, dur=2.0):
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaDeviceSynchronize", ts=ts, dur=dur,
                       args={}))

    def launch(ts, name, k_ts, k_dur):
        corr[0] += 1
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaLaunchKernel", ts=ts, dur=1.0,
                       args={"correlation": corr[0]}))
        ev.append(dict(ph="X", cat="kernel", name=name, ts=k_ts, dur=k_dur,
                       args={"correlation": corr[0]}))

    sync(0.0)                   # slice start
    sync(10.0)                  # env_step start
    launch(13.0, "physics_a", 14.0, 5.0)
    launch(20.0, "physics_b", 21.0, 5.0)
    sync(30.0)                  # env_step end
    sync(40.0)                  # render start
    launch(43.0, "raycast_kernel", 44.0, 20.0)
    sync(70.0)                  # render end
    sync(80.0, 20.0)            # slice end, 0..100 us
    return ev


OFF = 1000.0            # the trace's clock minus the host's
ANCHORS = [2.0 - OFF, 80.0 - OFF]
ORDER = [("env_step", 12.0 - OFF, 29.0 - OFF), ("render", 42.0 - OFF, 69.0 - OFF)]


def test_spans_and_idle_share():
    from perfbench.harness.tracing import Trace
    tr = Trace(_events(), ORDER, ANCHORS)
    assert tr.offset_us == pytest.approx(OFF)
    assert tr.window_s == pytest.approx(78e-6)
    assert tr.busy_s == pytest.approx(30e-6)
    assert tr.spans["env_step"][0]["device_us"] == pytest.approx(10.0)
    assert tr.spans["render"][0]["device_us"] == pytest.approx(20.0)
    assert [k for k, _ in tr.spans["render"][0]["kernels"]] == ["raycast_kernel"]
    assert tr.device_ops()[0] == ["raycast_kernel", pytest.approx(20e-6)]
    gaps = tr.idle_gaps()
    # the longest: from the physics' last kernel to the render's first launch
    assert gaps[0] == ["env_step: cudaLaunchKernel", pytest.approx(18e-6)]


def test_spans_dropped_when_clocks_do_not_match():
    from perfbench.harness.tracing import Trace
    tr = Trace(_events(), ORDER, [ANCHORS[0], ANCHORS[1] + 5000.0])
    assert tr.offset_us is None and tr.spans == {}
    assert tr.busy_s == pytest.approx(30e-6)


def test_readers_on_a_trace():
    from perfbench.harness import core
    from perfbench.harness.tracing import Spans, Trace
    tr = Trace(_events(), ORDER, ANCHORS)
    spans = Spans(__import__("torch").device("cpu"))
    spans.times = {"env_step": [0.1, 0.3], "render": [0.05]}
    ctx = dict(trace=tr, spans=spans, step_s=0.2, launches={"attention_fwd": 0},
               bounds=dict(raycast_s=10e-6, counted_s=0.004), num_envs=1, workload="x")
    assert core.load_reader("env_step_ms.obstacle")(ctx) == pytest.approx(200.0)
    assert core.load_reader("render.roofline_share")(ctx) == pytest.approx(50.0)
    assert core.load_reader("device_idle_share.sim")(ctx) == pytest.approx(100.0 * (1 - 30 / 78))
    assert core.load_reader("mfu.sim")(ctx) == pytest.approx(2.0)
    assert core.load_reader("attention.roofline_share")(ctx) is None
