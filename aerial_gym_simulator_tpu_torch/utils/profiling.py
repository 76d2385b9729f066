"""Profiling utilities (reference SURVEY 5.1).

Counterpart of ``aerial_gym_simulator_tpu/utils/profiling.py``. The
reference ships only a wall-clock FPS loop and NVTX remnants; here:

  * ``trace(logdir)``: a context manager around ``torch.profiler`` (CPU and,
    where a GPU is present, CUDA activity) that writes a Chrome trace of the
    wrapped region into ``logdir`` (open it in Perfetto or chrome://tracing),
  * ``Stopwatch``: phase timing with explicit device fences, so device work
    is charged to the phase that queued it,
  * ``measure_steps``: env-steps/s per device of any step callable,
  * ``op_breakdown``: the device time of a trace by kernel,
  * ``span(name)``: the simulator's own spans at its layer boundaries
    (below), read back with ``recorded_spans()``,
  * the command line (``python -m aerial_gym_simulator_tpu_torch.utils.profiling``),
    whose body is ``profile_task``: it times a task's step (or one PPO
    iteration), traces the same work, and prints where the device time
    went, by kernel and by span.

Spans. The simulator marks each layer of a step with ``span``:

  ========================  ==========================================================
  ``task``                  ``tasks/navigation_task.nav_step``: the whole task step
  ``physics``               ``sim/dynamics.env_step``: the substep loop
  ``physics.control``       each substep's controller and motor model
  ``physics.integrate``     each substep's integration (robot, joints, obstacles)
  ``physics.contact``       each substep's contact forces and collision flag
  ``reset``                 ``sim/dynamics.reset_envs``: the masked reset
  ``render``                ``sensors/raycast_sensor``: a capture (camera or lidar)
  ``encode``                ``models/vae.FrozenImageEncoder.encode``: the image encoder
  ========================  ==========================================================

A span records only while ``torch.profiler`` records. Otherwise ``span``
reads one flag and returns one shared no-op context: it allocates,
launches and synchronises nothing. While the profiler records, a span
appends (name, index of the span it opened inside or None, start, end)
to a bounded list, times in us of ``time.monotonic_ns()``, and opens a
``torch.profiler.record_function`` range of its name, so a CPU+CUDA trace
shows it. A span directly inside one of the same name records nothing
(a multi-sensor capture is one ``render``). Spans nest on the thread that
steps the simulator. A span holds no tensor operation. ``recorded_spans()``
reads the list and ``clear_spans()`` empties it.

Read against a trace, a device event belongs to the innermost span
during which the host launched it, and the device's idle time to every
span the host was inside while the device idled (``span_times``).
"""

from __future__ import annotations

import contextlib
import functools
import glob
import gzip
import json
import logging
import os
import tempfile
import time
from bisect import bisect_left, bisect_right
from typing import Callable, Dict

import torch
import torch.autograd.profiler as _autograd_profiler

logger = logging.getLogger("profiling")

TRACE_FILE = "trace.json"
# the Chrome-trace categories of work on the device: kernels, copies, sets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
# the host calls that enqueue device work, matched to it by correlation id
RUNTIME_CATEGORIES = ("cuda_runtime", "cuda_driver")
# the range profile_task opens around its traced steps
WINDOW = "profile_task.window"

MAX_SPANS = 1 << 16
_SPANS: list = []          # [name, parent index or None, t0 us, t1 us or None]
_OPEN: list = []           # (index, record) of the spans open now, innermost last
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "rec", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        self.rec = [self.name, _OPEN[-1][0] if _OPEN else None,
                    time.monotonic_ns() * 1e-3, None]
        _OPEN.append((len(_SPANS), self.rec))
        _SPANS.append(self.rec)

    def __exit__(self, *exc):
        self.rec[3] = time.monotonic_ns() * 1e-3
        if _OPEN and _OPEN[-1][1] is self.rec:
            _OPEN.pop()
        self.annotation.__exit__(*exc)
        return False


def span(name: str):
    """The span of a layer: a context that records while ``torch.profiler``
    records, and the shared no-op context otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    if len(_SPANS) >= MAX_SPANS or (_OPEN and _OPEN[-1][1][0] == name):
        return _OFF
    return _Span(name)


def spanned(name: str):
    """Decorator: the whole call inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def recorded_spans():
    """-> [(name, parent index or None, start us, end us or None)], in the
    order the spans opened (a parent before its children)."""
    return [tuple(r) for r in _SPANS]


def clear_spans():
    _SPANS.clear()
    _OPEN.clear()


@contextlib.contextmanager
def trace(logdir: str = None):
    """torch.profiler trace of the enclosed region, written to
    ``logdir/trace.json`` (default: a folder under the temporary
    directory)."""
    logdir = logdir or os.path.join(tempfile.gettempdir(), "aerial_gym_torch_trace")
    os.makedirs(logdir, exist_ok=True)
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
    logger.info(f"profiler trace written to {logdir}")


def _cuda_devices(x, out):
    """Collect the CUDA devices of every tensor in a nest of containers,
    NamedTuples and dataclasses."""
    if isinstance(x, torch.Tensor):
        if x.is_cuda:
            out.add(x.device)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _cuda_devices(v, out)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            _cuda_devices(getattr(x, name), out)
    return out


def _block_until_ready(x):
    """Wait for the CUDA devices of every tensor in ``x``; a CPU tensor has
    nothing to wait for. Returns ``x``."""
    for dev in _cuda_devices(x, set()):
        torch.cuda.synchronize(dev)
    return x


class Stopwatch:
    """Named phase timer with device fences.

    with sw.phase("render"): ...; sw.fence(pixels)
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        dt = time.perf_counter() - t0
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + 1

    def fence(self, x):
        """Inside a phase: wait for the devices ``x`` lives on, so their
        queued work is charged to the phase."""
        _block_until_ready(x)

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals):
            t, n = self.totals[name], self.counts[name]
            lines.append(f"{name:24s} {t:8.3f}s total  {1e3 * t / n:8.3f} ms/call"
                         f"  ({n} calls)")
        return "\n".join(lines)


def measure_steps(step_fn: Callable, state, actions, steps: int = 100,
                  warmup: int = 10, fence=lambda s: s):
    """env-steps/s (and per device) of a (state, actions) -> state
    callable. Per device means per visible CUDA device for actions on the
    card, per process on the CPU."""
    for _ in range(warmup):
        state = step_fn(state, actions)
    _block_until_ready(fence(state))
    t0 = time.perf_counter()
    for _ in range(steps):
        state = step_fn(state, actions)
    _block_until_ready(fence(state))
    dt = time.perf_counter() - t0
    num_envs = actions.shape[0]
    total = steps * num_envs
    devices = torch.cuda.device_count() if actions.is_cuda else 1
    return {"env_steps_per_s": total / dt,
            "env_steps_per_s_per_chip": total / dt / max(devices, 1),
            "wall_s": dt, "state": state}


def _read_trace(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _events(path: str) -> list:
    data = _read_trace(path)
    return data.get("traceEvents", []) if isinstance(data, dict) else data


def op_breakdown(trace_dir: str, iters: int = 1, top_k: int = 20):
    """Per-kernel device time of a ``trace`` -> ([(name, ms_per_iter,
    fraction)], total ms per iteration).

    Sums the durations of the Chrome trace's device events (kernels, copies
    and sets: ``DEVICE_CATEGORIES``) by name and sorts them by cost.
    ``iters`` is how many identical iterations the traced region held, so
    the table reads in ms per iteration. A trace of the CPU alone has no
    device events: the table is empty and the total 0.
    """
    files = sorted(glob.glob(os.path.join(trace_dir, "**", "*.json"), recursive=True)
                   + glob.glob(os.path.join(trace_dir, "**", "*.json.gz"), recursive=True),
                   key=os.path.getmtime)
    if not files:
        raise FileNotFoundError(f"no Chrome trace under {trace_dir}")
    events = _events(files[-1])
    totals: Dict[str, float] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            totals[ev["name"]] = totals.get(ev["name"], 0.0) + float(ev.get("dur", 0.0))
    s = sum(totals.values())
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top_k]
    return [(name, us / iters / 1e3, (us / s if s else 0.0))
            for name, us in rows], s / iters / 1e3


def _owner(spans, starts, t):
    """The innermost span holding t, or None. Spans nest and are listed in
    the order they opened, so it is the last span opened at or before t or
    one of its ancestors."""
    i = bisect_right(starts, t) - 1
    while i is not None and i >= 0 and spans[i][3] < t:
        i = spans[i][1]
    return None if i is None or i < 0 else i


def _idle(busy, t0, t1):
    """The window's wall time outside the merged busy intervals."""
    out, at = [], t0
    for s, e in busy:
        if s > at:
            out.append((at, min(s, t1)))
        at = max(at, e)
    if at < t1:
        out.append((at, t1))
    return [(s, e) for s, e in out if e > s]


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_times(spans, device, busy, t0, t1):
    """Device time, launching calls and idle time by span, on a trace's
    clock. ``spans`` [(name, parent index or None, start, end)], a parent
    before its children; ``device`` [(name, ts, dur, launch ts or None)];
    ``busy`` the merged device intervals inside the window [t0, t1].

    A device event belongs to the innermost span during which the host
    launched it (a launch on a span's edge is inside it); a span's launching
    calls are the distinct host calls that enqueued its device events (a
    graph launch counts once); the device's idle time in the window belongs
    to every span the host was inside during it. A span's totals hold its
    children's.

    -> ([dict(name, parent, start, end, device_us, launches, idle_us)],
    outside dict(device_us, launches, idle_us)): what no span holds."""
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


def read_window(events, recorded):
    """profile_task's traced window from a Chrome trace's events and the
    spans recorded meanwhile -> dict(t0, t1, device, busy, spans), the
    spans on the trace's clock as their ``record_function`` ranges place
    them (None where the ranges do not match the recorded spans one to
    one), or None without the window's range."""
    xs = [e for e in events if e.get("ph") == "X" and "ts" in e]
    marks = sorted((e for e in xs if e.get("cat") == "user_annotation"),
                   key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0))))
    window = next((e for e in marks if e["name"] == WINDOW), None)
    if window is None:
        return None
    t0 = float(window["ts"])
    t1 = t0 + float(window.get("dur", 0.0))
    launched = {(e.get("args") or {}).get("correlation"): float(e["ts"])
                for e in xs if e.get("cat") in RUNTIME_CATEGORIES}
    launched.pop(None, None)
    device = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)),
               launched.get((e.get("args") or {}).get("correlation")))
              for e in xs if e.get("cat") in DEVICE_CATEGORIES]
    busy = _merge([(ts, ts + dur) for _, ts, dur, _ in device if ts >= t0 and ts + dur <= t1])
    # each recorded span opened a range of its name around its clock
    # readings: matched in order, the ranges place the spans on the trace's
    # clock, each on its own
    names = {r[0] for r in recorded}
    marks = [e for e in marks if e["name"] in names]
    spans = None
    if recorded and len(marks) == len(recorded) and all(
            e["name"] == r[0] for e, r in zip(marks, recorded)):
        spans = [(r[0], r[1], float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                 for e, r in zip(marks, recorded)]
    return dict(t0=t0, t1=t1, device=device, busy=busy, spans=spans)


def span_table(window, iters: int = 1):
    """-> {span name: dict(calls, host_ms, device_ms, launches, idle_ms)}
    per iteration, in the order the spans first opened, and "(outside)":
    what no span holds (its host time is the window's outside every span);
    {} when the window's spans could not be matched."""
    if not window or not window["spans"]:
        return {}
    rows, outside = span_times(window["spans"], window["device"], window["busy"],
                               window["t0"], window["t1"])
    table = {}
    for r in rows:
        t = table.setdefault(r["name"], dict(calls=0, host_ms=0.0, device_ms=0.0, launches=0,
                                             idle_ms=0.0))
        t["calls"] += 1
        t["host_ms"] += (r["end"] - r["start"]) * 1e-3
        t["device_ms"] += r["device_us"] * 1e-3
        t["launches"] += r["launches"]
        t["idle_ms"] += r["idle_us"] * 1e-3
    top_host = sum(r["end"] - r["start"] for r in rows if r["parent"] is None)
    table["(outside)"] = dict(calls=0, host_ms=(window["t1"] - window["t0"] - top_host) * 1e-3,
                              device_ms=outside["device_us"] * 1e-3,
                              launches=outside["launches"], idle_ms=outside["idle_us"] * 1e-3)
    return {name: {k: v / iters for k, v in t.items()} for name, t in table.items()}


def _synchronize(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def profile_task(task, iters: int = 10, top: int = 20, ppo: bool = False,
                 horizon: int = 32, trace_dir: str = None, label: str = None,
                 echo: bool = True) -> dict:
    """Time ``iters`` env steps of a built task (``task.make_step_fn()``
    with zero actions), or ``iters`` PPO iterations (``ppo=True``:
    ``PPOTrainer.train_iteration``), then trace as many again and read the
    trace's device time by kernel. One untimed call comes first (warm-up).

    Returns {"label", "num_envs", "calls" (step or iteration calls in all),
    "wall_ms" (per call, untraced), "env_steps_per_s", "device_ms" (summed
    device time per call, from the trace), "idle_share" (1 - the union of
    the device's intervals over the traced calls' wall time, both from the
    trace), "rows" (op_breakdown's table), "spans" (``span_table``: the
    simulator's spans per call), "step_graphs" (the physics steps of all
    the calls by what they ran: captured, replayed from a CUDA graph or
    eager; ``dynamics.STEP_GRAPHS``), "trace_dir"}; with ``echo`` it prints the
    command line's report. The trace records the host and the device, so
    its calls run slower than the untimed ones.
    """
    name = getattr(task, "task_name", None) or type(task).__name__
    n = task.num_envs
    device = torch.device(task.device)
    if ppo:
        from ..rl.ppo import PPOConfig, PPOTrainer

        cfg = PPOConfig(num_envs=n, horizon=horizon,
                        minibatch_size=min(8192, n * horizon), seed=0)
        trainer = PPOTrainer(task, cfg)
        unit_steps = n * horizon

        def step_once():
            trainer.train_iteration()

        label = label or f"{name} PPO iteration"
    else:
        task.reset()
        step_fn, carry, _obs = task.make_step_fn()
        actions = torch.zeros((n, task.action_space_dim), device=device)
        unit_steps = n
        box = [carry]

        def step_once():
            box[0] = step_fn(box[0], actions)[0]

        label = label or f"{name} env step"

    from ..sim.dynamics import STEP_GRAPHS
    graphs0 = dict(STEP_GRAPHS)
    step_once()                                   # warm-up
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step_once()
    _synchronize(device)
    wall = (time.perf_counter() - t0) / iters

    tdir = trace_dir or tempfile.mkdtemp(prefix="agtorch_prof_")
    clear_spans()
    with trace(tdir):
        with torch.profiler.record_function(WINDOW):
            for _ in range(iters):
                step_once()
            _synchronize(device)
    recorded = recorded_spans()
    rows, total_ms = op_breakdown(tdir, iters=iters, top_k=top)
    window = read_window(_events(os.path.join(tdir, TRACE_FILE)), recorded)
    idle_share = None
    if window is not None and window["t1"] > window["t0"]:
        busy = sum(e - s for s, e in window["busy"])
        idle_share = 1.0 - busy / (window["t1"] - window["t0"])
    spans = span_table(window, iters)
    step_graphs = {k: v - graphs0[k] for k, v in STEP_GRAPHS.items()}
    if not ppo and hasattr(task, "set_carry"):
        task.set_carry(box[0])
    report = {"label": label, "num_envs": n, "calls": 1 + 2 * iters, "wall_ms": wall * 1e3,
              "env_steps_per_s": unit_steps / wall, "device_ms": total_ms,
              "idle_share": idle_share, "rows": rows, "spans": spans,
              "step_graphs": step_graphs, "trace_dir": tdir}
    if echo:
        idle = "unread" if idle_share is None else f"{idle_share:.3f}"
        print(f"\n{label} @ {n} envs: "
              f"{wall * 1e3:.2f} ms wall "
              f"({unit_steps / wall / 1e3:.1f}k env-steps/s), "
              f"{total_ms:.2f} ms summed device ops "
              f"(device idle share {idle} in the traced calls)\n")
        print(f"{'ms/step':>9}  {'share':>6}  op")
        for op, ms, frac in rows:
            print(f"{ms:9.3f}  {100 * frac:5.1f}%  {op[:100]}")
        print("\nphysics steps (dynamics.STEP_GRAPHS): "
              + ", ".join(f"{k} {v}" for k, v in step_graphs.items()))
        if spans:
            print(f"\n{'span':24s} {'calls':>7} {'host ms':>9} {'device ms':>10} "
                  f"{'launches':>9} {'idle ms':>9}   (per step, children included)")
            for name, t in spans.items():
                print(f"{name:24s} {t['calls']:7.1f} {t['host_ms']:9.3f} {t['device_ms']:10.3f} "
                      f"{t['launches']:9.1f} {t['idle_ms']:9.3f}")
    return report


def build_parser():
    import argparse

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--task", default="position_setpoint_task")
    p.add_argument("--num_envs", type=int, default=1024)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--top", type=int, default=20)
    p.add_argument("--ppo", action="store_true",
                   help="trace a whole PPO train iteration (rollout + GAE + "
                        "update) instead of one env step")
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--trace_dir", default=None,
                   help="keep the Chrome trace here")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p


def main(argv=None):
    """Trace a task's step at scale and print where device time goes.

        python -m aerial_gym_simulator_tpu_torch.utils.profiling \\
            --task navigation_task --num_envs 1024 --iters 10

    The reference's only profiling tool is a wall-clock FPS loop
    (examples/benchmark.py:67-84); this is the counterpart of its abandoned
    NVTX annotations (warp_cam.py:1).
    """
    args = build_parser().parse_args(argv)
    from .device import resolve_device

    device = resolve_device("cpu" if args.cpu else None)
    import aerial_gym_simulator_tpu_torch as port

    task = port.task_registry.make_task(args.task, num_envs=args.num_envs, seed=0,
                                        device=device)
    return profile_task(task, iters=args.iters, top=args.top, ppo=args.ppo,
                        horizon=args.horizon, trace_dir=args.trace_dir,
                        label=f"{args.task} PPO iteration" if args.ppo
                        else f"{args.task} env step")


if __name__ == "__main__":
    # the simulator records its spans in this module as the package imported
    # it, not in the copy ``python -m`` runs: run that one's main
    from aerial_gym_simulator_tpu_torch.utils import profiling

    profiling.main()
