"""Spans around the calls into each layer, the profiler over a slice of the
window, and the reading of its trace.

A span synchronises the device at both ends of a call into a layer, so
that its length on the host clock is the layer's whole time and the device
is drained at its edges. Spans exist only in the two slices of a
``--trace 1`` run; elsewhere ``Spans.__call__`` returns one shared no-op
context. In the first slice the spans' lengths are taken on the host clock
with no profiler running. In the second, ``torch.profiler`` records the
device alone (CUDA activity: kernels, copies, sets and the runtime calls
that launched them); recording the host's operators too lengthened the
obstacle step by 61% on the card, the device alone by 11%. The spans then
only mark, on the host's monotonic clock, where each layer's launches
begin and end; the slice's first and last ``cudaDeviceSynchronize`` give
the offset of the trace's clock, and a kernel belongs to the span during
which the host launched it (its runtime call, matched by correlation id).
The trace is written under ``TMPDIR``, read once and deleted.

Reading the trace follows the port's ``utils/profiling.op_breakdown``
(device events are the kernel, copy and set categories of the Chrome
trace), with the idle share taken from the same slice as its device time:
the union of the device intervals over the wall time between the slice's
first and last synchronisation.
"""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import tempfile
import time
from bisect import bisect_right

import torch

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SYNC = "cudaDeviceSynchronize"
_NULL = contextlib.nullcontext()


class Spans:
    """``spans(name)``: the span context of a layer, live only in a traced
    run's slices. ``timing``: lengths kept on the host clock; ``order``:
    (name, first launch, last launch) of the spans run while the profiler
    records, in us of the host's monotonic clock."""

    def __init__(self, device):
        self.device = device
        self.live = False
        self.timing = False
        self.recording = False
        self.times = {}
        self.order = []

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def _span(self, name):
        self.sync()
        t0 = time.perf_counter()
        launch0 = time.monotonic_ns()
        try:
            yield
        finally:
            launch1 = time.monotonic_ns()
            self.sync()
            if self.timing:
                self.times.setdefault(name, []).append(time.perf_counter() - t0)
            if self.recording:
                self.order.append((name, launch0 * 1e-3, launch1 * 1e-3))

    def span_ms(self, layer):
        """Mean host-clock length of a layer's spans in the timing slice (ms),
        or None."""
        t = self.times.get(layer)
        return sum(t) / len(t) * 1e3 if t else None

    def __call__(self, name):
        return self._span(name) if self.live else _NULL


class Slice:
    """The profiler over K steps of the window: ``start()`` before the
    first, ``stop()`` after the last; ``read()`` parses the trace."""

    def __init__(self, spans: Spans):
        self.spans = spans
        self.dir = tempfile.mkdtemp(prefix="perfbench_trace_")
        act = (torch.profiler.ProfilerActivity.CUDA if spans.device.type == "cuda"
               else torch.profiler.ProfilerActivity.CPU)
        self.prof = torch.profiler.profile(activities=[act], record_shapes=False,
                                           with_stack=False, profile_memory=False)

    def start(self):
        self.prof.__enter__()
        self.spans.sync()
        self.anchors = [time.monotonic_ns() * 1e-3]
        self.spans.live = self.spans.recording = True

    def stop(self):
        self.anchors.append(time.monotonic_ns() * 1e-3)
        self.spans.sync()
        self.spans.live = self.spans.recording = False
        self.prof.__exit__(None, None, None)

    def read(self):
        path = os.path.join(self.dir, "trace.json")
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)
        finally:
            shutil.rmtree(self.dir, ignore_errors=True)
        events = events.get("traceEvents", []) if isinstance(events, dict) else events
        return Trace(events, self.spans.order, self.anchors)


def _clock_offset(syncs, anchors, tolerance_us=2000.0):
    """The trace's clock minus the host's monotonic clock, from the slice's
    first synchronisation (the host's first anchor is taken as it returns)
    and its last (the second anchor is taken just before it starts); None
    when no pair of synchronisations agrees within ``tolerance_us``."""
    if len(syncs) < 2:
        return None
    starts = [a for a, _ in syncs]
    for _, end in syncs[:8]:
        off = end - anchors[0]
        k = min(range(len(starts)), key=lambda j: abs(starts[j] - (anchors[1] + off)))
        if abs(starts[k] - (anchors[1] + off)) <= tolerance_us:
            return off
    return None


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The slice's device work: ``device`` [(name, ts, dur, launch ts)],
    ``spans[layer]`` a list of dicts (start, end on the trace's clock in us,
    device_us, kernels [(name, us)]) when the clocks could be matched,
    ``busy_s`` and ``window_s``."""

    def __init__(self, events, order, anchors):
        xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
        runtime = sorted((e for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")),
                         key=lambda e: float(e["ts"]))
        syncs = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e in runtime if e["name"] == SYNC]
        launched = {(e.get("args") or {}).get("correlation"): float(e["ts"]) for e in runtime}
        self.device = []
        for e in xs:
            if e.get("cat") in DEVICE_CATEGORIES:
                corr = (e.get("args") or {}).get("correlation")
                self.device.append((e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
                                    launched.get(corr)))
        self.offset_us = _clock_offset(syncs, anchors)
        if self.offset_us is not None:
            self.t0, self.t1 = anchors[0] + self.offset_us, anchors[1] + self.offset_us
        elif xs:
            self.t0 = min(float(e["ts"]) for e in xs)
            self.t1 = max(float(e["ts"]) + float(e.get("dur", 0.0)) for e in xs)
        else:
            self.t0 = self.t1 = 0.0
        self.syncs = len(syncs)
        # each span's launches, on the trace's clock
        self.spans = {}
        self._named = []
        inst = []
        if self.offset_us is not None:
            for name, h0, h1 in order:
                d = dict(start=h0 + self.offset_us, end=h1 + self.offset_us, device_us=0.0,
                         kernels=[])
                self.spans.setdefault(name, []).append(d)
                self._named.append((d["start"], d["end"], name))
                inst.append(d)
            starts = [d["start"] for d in inst]
            for name, ts, dur, t_launch in self.device:
                if t_launch is None:
                    continue
                i = bisect_right(starts, t_launch) - 1
                if i >= 0 and t_launch <= inst[i]["end"]:
                    inst[i]["device_us"] += dur
                    inst[i]["kernels"].append((name, dur))
        inside = [(ts, ts + dur) for _, ts, dur, _ in self.device
                  if ts >= self.t0 and ts + dur <= self.t1]
        self.busy = _merge(inside)
        self.window_s = max(self.t1 - self.t0, 0.0) * 1e-6
        self.busy_s = sum(e - s for s, e in self.busy) * 1e-6
        self._runtime = [(float(e["ts"]), e["name"]) for e in runtime]

    def device_ops(self, top: int = 10):
        totals = {}
        for name, _, dur, _ in self.device:
            totals[name] = totals.get(name, 0.0) + dur
        rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top]
        return [[name[:200], us * 1e-6] for name, us in rows]

    def idle_gaps(self, top: int = 10):
        """The longest gaps between device work in the slice, each named by
        the span the host was in and the runtime call that ended the gap."""
        edges = [self.t0] + [x for iv in self.busy for x in iv] + [self.t1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                       for i in range(0, len(edges) - 1, 2) if edges[i + 1] > edges[i]),
                      reverse=True)[:top]
        times = [t for t, _ in self._runtime]
        out = []
        for length, start, end in gaps:
            span = next((n for s, e, n in self._named if s <= start <= e), "between spans")
            k = bisect_right(times, end) - 1
            call = self._runtime[k][1] if k >= 0 else "none"
            out.append([f"{span}: {call}", length * 1e-6])
        return out
