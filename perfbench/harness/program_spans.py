"""The port's own spans on the device trace's clock.

While a profiler records, the port notes a span at each of its layer
boundaries (``aerial_gym_simulator_tpu_torch.utils.profiling.span``): its
name, the index of the span it opened inside (None at the top), and its
start and end in us of the host's monotonic clock, the clock the slice's
anchors are taken on. Moved onto the trace's clock:

- a device event belongs to the innermost span during which the host
  launched it (``Trace.device``'s launch time; a launch on a span's edge
  is inside it);
- a span's launching calls are the distinct runtime or driver calls that
  enqueued its device events, told apart by their start times: a graph
  launch counts once, however many kernels it carries;
- a stretch of the device's idle time, the slice's wall time outside
  ``Trace.busy``, belongs to every span the host was inside during it.

A span's totals hold its children's; ``outside`` holds what no span
holds. A slice whose clocks were not matched (``Trace.offset_us`` None),
or in which the port recorded no span (a port without the recorder),
reads None.

The clocks. ``Trace.offset_us`` is matched once, at the end of the
slice's first synchronisation. On an H100 the two clocks drift apart by
a few ppm over a slice, a synchronisation's end reads 120-300 us off its
start's offset, and the harness once matched a wrong synchronisation
(2 ms off): enough to move a span's first launches, or the whole render,
into the next span. So a port span moves by the offset read where the
host left the benchmark's span around it: that span takes its last host
reading and then synchronises, and the synchronisation's start is on the
trace's clock; between two such readings the offset is interpolated.
Where the synchronisations that close the benchmark's spans (each the
first synchronisation after a call of another kind) do not pair one to
one with the spans, ``Trace.offset_us`` moves them.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right

SYNC = "cudaDeviceSynchronize"


def port_spans():
    """The port's recorded spans, or None where the port has no recorder."""
    try:
        from aerial_gym_simulator_tpu_torch.utils.profiling import recorded_spans
    except ImportError:
        return None
    return recorded_spans()


def clock(trace, order):
    """-> host us -> the trace's clock, from the benchmark's spans ``order``
    [(name, first host reading, last host reading)] and the slice's runtime
    calls ``trace._runtime`` [(ts, name)], sorted; ``trace.offset_us`` where
    the closing synchronisations do not pair with the spans."""
    closing, before = [], None
    for ts, name in trace._runtime:
        if name == SYNC and before is not None and before != SYNC:
            closing.append(ts)
        before = name
    if not order or len(closing) != len(order):
        return lambda h: h + trace.offset_us
    hosts = [h1 for _, _, h1 in order]
    offs = [ts - h1 for ts, h1 in zip(closing, hosts)]

    def to_trace(h):
        k = bisect_right(hosts, h)
        if k == 0 or k == len(hosts):
            return h + offs[min(k, len(hosts) - 1)]
        w = (h - hosts[k - 1]) / (hosts[k] - hosts[k - 1])
        return h + offs[k - 1] + w * (offs[k] - offs[k - 1])

    return to_trace


def on_clock(recorded, to_trace, t0, t1):
    """The closed spans that start inside [t0, t1], moved onto the trace's
    clock by ``to_trace``: [(name, parent index into the list or None,
    start, end)]."""
    kept, out = {}, []
    for i, (name, parent, h0, h1) in enumerate(recorded):
        if h1 is None or not t0 <= to_trace(h0) <= t1:
            continue
        kept[i] = len(out)
        out.append((name, kept.get(parent), to_trace(h0), to_trace(h1)))
    return out


def _owner(spans, starts, t):
    """The innermost span holding t, or None. Spans nest and are listed in
    the order they opened, so it is the last span opened at or before t or
    one of its ancestors."""
    i = bisect_right(starts, t) - 1
    while i is not None and i >= 0 and spans[i][3] < t:
        i = spans[i][1]
    return None if i is None or i < 0 else i


def _idle(busy, t0, t1):
    """The slice's wall time outside the merged busy intervals."""
    out, at = [], t0
    for s, e in busy:
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


def attribute(spans, device, busy, t0, t1):
    """spans [(name, parent, start, end)] on the trace's clock, a parent
    before its children; device [(name, ts, dur, launch ts or None)];
    busy the merged device intervals inside [t0, t1].
    -> ([dict(name, parent, start, end, device_us, launches, idle_us)],
    outside dict(device_us, launches, idle_us))."""
    rows = [dict(name=n, parent=p, start=s, end=e, device_us=0.0, launches=0, idle_us=0.0)
            for n, p, s, e in spans]
    starts = [s for _, _, s, _ in spans]
    calls = [set() for _ in spans]
    outside = dict(device_us=0.0, launches=0, idle_us=0.0)
    out_calls = set()
    for _, _, dur, launched in device:
        if launched is None:
            continue
        i = _owner(spans, starts, launched)
        if i is None:
            outside["device_us"] += dur
            out_calls.add(launched)
        else:
            rows[i]["device_us"] += dur
            calls[i].add(launched)
    outside["launches"] = len(out_calls)
    for r, c in zip(rows, calls):
        r["launches"] = len(c)
    for r in reversed(rows):          # a child after its parent: its totals are whole
        if r["parent"] is not None:
            rows[r["parent"]]["device_us"] += r["device_us"]
            rows[r["parent"]]["launches"] += r["launches"]
    idle = _idle(busy, t0, t1)
    i_starts = [s for s, _ in idle]
    i_ends = [e for _, e in idle]
    cum = [0.0]
    for s, e in idle:
        cum.append(cum[-1] + e - s)
    for r in rows:
        a, b = max(r["start"], t0), min(r["end"], t1)
        lo, hi = bisect_right(i_ends, a), bisect_left(i_starts, b)
        if b > a and hi > lo:
            r["idle_us"] = (cum[hi] - cum[lo] - max(0.0, a - i_starts[lo])
                            - max(0.0, i_ends[hi - 1] - b))
    outside["idle_us"] = cum[-1] - sum(r["idle_us"] for r in rows if r["parent"] is None)
    return rows, outside


def by_name(rows):
    """-> {name: dict(calls, host_us, device_us, launches, idle_us)}, summed
    over the spans of each name."""
    out = {}
    for r in rows:
        t = out.setdefault(r["name"], dict(calls=0, host_us=0.0, device_us=0.0, launches=0,
                                           idle_us=0.0))
        t["calls"] += 1
        t["host_us"] += r["end"] - r["start"]
        for k in ("device_us", "launches", "idle_us"):
            t[k] += r[k]
    return out


def mapped(ctx):
    """The traced slice's port spans with their totals -> (rows, outside),
    or None. Kept in ``ctx`` for the next reader."""
    if "program_spans" not in ctx:
        tr, recorded = ctx["trace"], port_spans()
        out = None
        if tr.offset_us is not None and recorded:
            spans = on_clock(recorded, clock(tr, ctx["spans"].order), tr.t0, tr.t1)
            if spans:
                out = attribute(spans, tr.device, tr.busy, tr.t0, tr.t1)
        ctx["program_spans"] = out
    return ctx["program_spans"]


def totals(ctx, name):
    """The slice's spans of one name, summed (``by_name``), or None."""
    m = mapped(ctx)
    return None if m is None else by_name(m[0]).get(name)
