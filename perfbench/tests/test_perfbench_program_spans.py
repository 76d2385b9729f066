"""The port's spans on the device trace's clock (``harness/program_spans.py``)
and the four readers over them, on a synthetic slice: launches inside,
outside and on the edge of a span, nested spans, one graph launch carrying
three kernels, idle stretches that straddle a span's edge, and a slice
whose clocks do not match."""

from __future__ import annotations

import pytest

OFF = 1000.0                    # the trace's clock minus the host's


def _events(closing_late=0.0):
    """A slice [2, 80] on the trace's clock, delimited by synchronisations,
    holding two of the benchmark's spans, each closed by a synchronisation
    that starts at its last host reading (``closing_late`` us later on the
    second)."""
    ev = []
    corr = [0]

    def sync(ts, dur=0.5):
        ev.append(dict(ph="X", cat="cuda_runtime", name="cudaDeviceSynchronize", ts=ts, dur=dur,
                       args={}))

    def launch(ts, kernels, name="cudaLaunchKernel"):
        corr[0] += 1
        ev.append(dict(ph="X", cat="cuda_runtime", name=name, ts=ts, dur=1.0,
                       args={"correlation": corr[0]}))
        for k_name, k_ts, k_dur in kernels:
            ev.append(dict(ph="X", cat="kernel", name=k_name, ts=k_ts, dur=k_dur,
                           args={"correlation": corr[0]}))

    sync(0.0, 2.0)                                  # slice start
    sync(8.0)                                       # the benchmark's first span opens
    launch(11.0, [("before_physics", 12.0, 2.0)])   # in task, before physics
    launch(15.0, [("control_a", 16.0, 3.0)])        # inside physics.control [14, 20]
    launch(20.0, [("control_edge", 22.0, 2.0)])     # on control's end: inside it
    launch(26.0, [("g1", 27.0, 1.0), ("g2", 28.0, 1.0), ("g3", 29.0, 1.0)],
           name="cudaGraphLaunch")                  # one call, three kernels, in physics
    launch(35.0, [("k_render", 40.0, 8.0)])         # inside render [34, 50]
    launch(53.0, [("encode_a", 54.0, 4.0)])         # inside encode [52, 60]
    sync(63.0)                                      # ... and closes
    sync(63.5)                                      # the second opens
    launch(66.0, [("physics_b", 67.0, 2.0)])        # inside the second physics [64, 70]
    launch(75.0, [("outside", 76.0, 1.0)])          # inside no port span
    sync(78.0 + closing_late)                       # ... and closes
    sync(80.0, 20.0)                                # slice end
    return ev


ANCHORS = [2.0 - OFF, 80.0 - OFF]
# the benchmark's spans: (name, first host reading, last host reading)
ORDER = [("task_step", 8.5 - OFF, 63.0 - OFF), ("env_step", 64.0 - OFF, 78.0 - OFF)]
# the port's recorded spans, on the host clock: task > physics > control;
# render and encode inside task; a second physics after the task
RECORDED = [("task", None, 10.0 - OFF, 62.0 - OFF),
            ("physics", 0, 13.0 - OFF, 32.0 - OFF),
            ("physics.control", 1, 14.0 - OFF, 20.0 - OFF),
            ("render", 0, 34.0 - OFF, 50.0 - OFF),
            ("encode", 0, 52.0 - OFF, 60.0 - OFF),
            ("physics", None, 64.0 - OFF, 70.0 - OFF)]


class _Spans:
    def __init__(self, order):
        self.order = order


def _ctx(recorded=RECORDED, anchors=ANCHORS, monkeypatch=None, events=None, order=ORDER):
    from perfbench.harness import program_spans
    from perfbench.harness.tracing import Trace
    monkeypatch.setattr(program_spans, "port_spans", lambda: list(recorded))
    return dict(trace=Trace(events or _events(), [], anchors), spans=_Spans(order),
                bounds=dict(raycast_s=2e-6))


def test_device_time_launches_and_idle_by_span(monkeypatch):
    from perfbench.harness.program_spans import by_name, mapped
    ctx = _ctx(monkeypatch=monkeypatch)
    rows, outside = mapped(ctx)
    t = by_name(rows)
    # busy [12,14] [16,19] [22,24] [27,30] [40,48] [54,58] [67,69] [76,77] in [2, 80]
    assert t["physics.control"] == dict(calls=1, host_us=6.0, device_us=5.0, launches=2,
                                        idle_us=pytest.approx(6.0 - 3.0))
    # physics: the control's two calls, the graph launch (one call), the
    # second physics span launched one more
    assert t["physics"]["calls"] == 2 and t["physics"]["launches"] == 4
    assert t["physics"]["device_us"] == pytest.approx(5.0 + 3.0 + 2.0)
    # idle inside the physics spans: [13,32] less 1+3+2+3 busy; [64,70] less 2
    assert t["physics"]["idle_us"] == pytest.approx(19.0 - 9.0 + 6.0 - 2.0)
    assert t["task"]["launches"] == 6 and t["task"]["device_us"] == pytest.approx(22.0)
    assert t["render"]["device_us"] == 8.0 and t["render"]["idle_us"] == pytest.approx(8.0)
    assert t["encode"]["device_us"] == 4.0
    # idle outside every span, of stretches that straddle the spans' edges:
    # [2,10] before the task, [62,64] and [70,76] around the second physics,
    # [77,80] at the end
    assert outside["idle_us"] == pytest.approx(8.0 + 2.0 + 6.0 + 3.0)
    assert outside["launches"] == 1 and outside["device_us"] == 1.0
    assert ctx["program_spans"] is mapped(ctx)          # read once per slice


def test_readers(monkeypatch):
    from perfbench.harness.core import load_reader
    ctx = _ctx(monkeypatch=monkeypatch)
    assert load_reader("physics.host_launches")(ctx) == pytest.approx(2.0)
    assert load_reader("physics.idle_ms")(ctx) == pytest.approx((10.0 + 4.0) / 2 * 1e-3)
    assert load_reader("encode.device_ms.nav")(ctx) == pytest.approx(4.0e-3)
    assert load_reader("render.roofline_share.nav")(ctx) == pytest.approx(100.0 * 2.0 / 8.0)


@pytest.mark.parametrize("case", ["clocks", "no_spans", "no_recorder"])
def test_readers_read_none(monkeypatch, case):
    from perfbench.harness import program_spans
    from perfbench.harness.core import load_reader
    if case == "clocks":
        ctx = _ctx(anchors=[ANCHORS[0], ANCHORS[1] + 5000.0], monkeypatch=monkeypatch)
        assert ctx["trace"].offset_us is None
    elif case == "no_spans":
        ctx = _ctx(recorded=[], monkeypatch=monkeypatch)
    else:
        ctx = _ctx(monkeypatch=monkeypatch)
        monkeypatch.setattr(program_spans, "port_spans", lambda: None)
    for name in ("physics.host_launches", "physics.idle_ms", "encode.device_ms.nav",
                 "render.roofline_share.nav"):
        assert load_reader(name)(ctx) is None, name


def test_spans_outside_the_slice_and_open_spans_are_left_out():
    from perfbench.harness.program_spans import on_clock
    rec = [("physics", None, 0.0, 5.0), ("physics.control", 0, 1.0, 2.0),
           ("physics", None, 10.0, 15.0), ("physics.control", 2, 11.0, 12.0),
           ("render", None, 20.0, None)]
    assert on_clock(rec, lambda h: h + 100.0, 105.0, 130.0) == [
        ("physics", None, 110.0, 115.0), ("physics.control", 0, 111.0, 112.0)]


def test_clock_follows_the_closing_synchronisations(monkeypatch):
    """Each port span moves by the offset read at the synchronisation that
    closed the benchmark's span around it, interpolated between two; the
    slice's offset alone where the closing synchronisations do not pair
    with the benchmark's spans."""
    from perfbench.harness.program_spans import clock
    ctx = _ctx(monkeypatch=monkeypatch, events=_events(closing_late=1.5))
    tr = ctx["trace"]
    assert tr.offset_us == pytest.approx(OFF)
    to_trace = clock(tr, ORDER)
    assert to_trace(63.0 - OFF) == pytest.approx(63.0)          # the first span's close
    assert to_trace(78.0 - OFF) == pytest.approx(79.5)          # the second's, 1.5 us late
    assert to_trace(70.5 - OFF) == pytest.approx(71.25)         # halfway: 0.75 us
    assert to_trace(0.0 - OFF) == pytest.approx(0.0)            # before the first: its offset
    assert to_trace(90.0 - OFF) == pytest.approx(91.5)          # after the last: its offset
    # one span too many: the slice's offset
    extra = ORDER + [("render", 78.2 - OFF, 79.0 - OFF)]
    assert clock(tr, extra)(78.0 - OFF) == pytest.approx(78.0)


def test_a_wrong_slice_offset_does_not_move_the_spans(monkeypatch):
    """The slice's offset 1.5 us off (matched at a synchronisation's end
    that reads late): the spans still land where their closing
    synchronisations put them."""
    from perfbench.harness.core import load_reader
    anchors = [ANCHORS[0] - 1.5, ANCHORS[1] - 1.5]
    ctx = _ctx(monkeypatch=monkeypatch, anchors=anchors)
    assert ctx["trace"].offset_us == pytest.approx(OFF + 1.5)
    assert load_reader("physics.host_launches")(ctx) == pytest.approx(2.0)
    assert load_reader("encode.device_ms.nav")(ctx) == pytest.approx(4.0e-3)


def test_the_port_applies_the_same_rules(monkeypatch):
    """profile_task's arithmetic in the port gives the benchmark's numbers
    on the same slice."""
    from aerial_gym_simulator_tpu_torch.utils import profiling
    from perfbench.harness.program_spans import attribute, clock, on_clock
    ctx = _ctx(monkeypatch=monkeypatch)
    tr = ctx["trace"]
    spans = on_clock(RECORDED, clock(tr, ORDER), tr.t0, tr.t1)
    ours = attribute(spans, tr.device, tr.busy, tr.t0, tr.t1)
    theirs = profiling.span_times(spans, tr.device, tr.busy, tr.t0, tr.t1)
    assert ours == theirs


def test_the_port_records_what_the_readers_read():
    """The port's recorder, under the profiler, gives the list the readers
    take (name, parent, start, end on the host's monotonic clock)."""
    import time

    import torch
    from aerial_gym_simulator_tpu_torch.utils import profiling
    from perfbench.harness.program_spans import port_spans
    profiling.clear_spans()
    t0 = time.monotonic_ns() * 1e-3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("physics"):
            with profiling.span("physics.control"):
                pass
    t1 = time.monotonic_ns() * 1e-3
    got = port_spans()
    profiling.clear_spans()
    assert [(n, p) for n, p, _, _ in got] == [("physics", None), ("physics.control", 0)]
    assert all(t0 <= s <= e <= t1 for _, _, s, e in got)
