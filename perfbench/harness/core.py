"""One run of one cell: set-up, warm-up, the measured window, the traced
slice, the comparison that decides ``correct``, and the result line.

This module holds nothing of a configuration, a traffic mix, a kind of loop
or a metric. Each sits in a file of its own that it finds by the names in
``BENCHMARK.json``:

- ``configs/<config>.json``, the configuration's ``file``: what the kind
  builds the port from, and every constant the references rebuild;
- ``traffic/<traffic>.json``: the mix's parameters; its ``kind`` names the
  loop that reads them, ``kinds/<kind>.py``;
- ``kinds/<kind>.py``: ``Loop`` (builds the port's objects from the
  configuration and the seed, runs one step per ``step(i, spans, cap)``,
  counts its ``work`` per step, names its native ``libraries()``, its launch
  counters ``launches()``, and the least time of a step's counted work
  ``bounds()``; a kind that runs on several cards adds ``peak_bytes()``,
  the peak of the fullest card, and ``busy_s(trace)``, the traced slice's
  busy time averaged over its cards) and ``Check`` (the program's outputs at a capture, the plain
  references' at the configuration's precision or the control's, and the
  numbers that compare them);
- ``end_to_end/<metric>.py`` and ``per_layer/<metric>.py``: a reader
  ``read(ctx)`` that returns a number, or None where it finds nothing to read;
- ``limits/<workload>.json``: each compared number's limit.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .checks import worst
from .tracing import Slice, Spans

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "perfbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "aerial_gym_simulator_tpu")


class Refused(Exception):
    """A run that prints no result (exit code 2)."""


def _load(folder: str, name: str):
    path = BENCH / folder / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {folder}/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"perfbench.{folder}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(kind: str):
    return _load("kinds", kind)


def load_reader(metric: str, folder: str = "per_layer"):
    return _load(folder, metric).read


def load_cell(name: str):
    """-> (cell, configuration, traffic, limits, end-to-end metrics, per-layer
    metrics) of a workload of ``BENCHMARK.json``."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"unknown workload {name!r}; known: {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    cfg = json.loads((ROOT / config["file"]).read_text())
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())

    def applies(metric):
        return name in metric["workloads"] if "workloads" in metric else True

    e2e = [m for m in spec["end_to_end"] if applies(m)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return cell, cfg, traffic, limits, e2e, per_layer


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line():
    """The card's name and power limit, for an earlier line of the output."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class StepClock:
    """End-of-step marks: CUDA events read after the window on the card,
    the host clock on the CPU (tests)."""

    def __init__(self, device, capacity=8192):
        self.cuda = device.type == "cuda"
        self.marks = []
        if self.cuda:
            self._pool = [torch.cuda.Event(enable_timing=True) for _ in range(capacity)]

    def mark(self):
        if self.cuda:
            if len(self.marks) == len(self._pool):
                self._pool.append(torch.cuda.Event(enable_timing=True))
            ev = self._pool[len(self.marks)]
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def gaps_ms(self):
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(self.marks[:-1], self.marks[1:])]
        return [(b - a) * 1e3 for a, b in zip(self.marks[:-1], self.marks[1:])]


def plan_captures(traffic, num_envs, seed, device):
    """The capture steps and the compared envs, drawn from the seed."""
    rng = np.random.default_rng(seed)
    capture = traffic["capture"]
    steps = sorted(rng.choice(int(capture["first_steps"]), size=int(capture["steps"]),
                              replace=False).tolist())
    rows = np.sort(rng.choice(num_envs, size=min(int(capture["envs"]), num_envs), replace=False))
    return steps, torch.as_tensor(rows, device=device)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(name, seed, seconds, trace, t_start, device="cuda", overrides=None):
    """One run -> (result line, [(number, value, limit)], run info).
    ``overrides`` (tests): ``envs``, and what the kind reads (``camera_hw``)."""
    overrides = overrides or {}
    cell, cfg, traffic, limits, e2e, per_layer = load_cell(name)
    kind = load_kind(traffic["kind"])
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise Refused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise Refused(f"{torch.cuda.device_count()} cards, the cell asks for {cell['chips']}")
        torch.cuda.reset_peak_memory_stats(device)
    loop = kind.Loop(cfg, traffic, device, seed, overrides)
    if device.type == "cuda":
        from aerial_gym_simulator_tpu_torch.ops._build import build_all
        build_all(loop.libraries())          # the first run in a checkout compiles here
    cap_steps, rows = plan_captures(traffic, loop.num_envs, seed, device)
    spans = Spans(device)
    for i in range(int(traffic["warmup_steps"])):
        loop.step(-1 - i, spans)
    _sync(device)
    gc.collect()                  # set-up's garbage goes before the window, not into it
    setup_s = time.perf_counter() - t_start

    # the measured window
    caps = []
    clock = StepClock(device)
    _sync(device)
    clock.mark()
    t0 = time.perf_counter()
    i = 0
    while True:
        cap = None
        if i in cap_steps:
            cap = {"rows": rows, "step": i}
            caps.append(cap)
        loop.step(i, spans, cap)
        clock.mark()
        i += 1
        if time.perf_counter() - t0 >= seconds and i > max(cap_steps):
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = i
    if hasattr(loop, "peak_bytes"):
        peak = loop.peak_bytes()      # a kind that runs on several cards: the fullest one's
    else:
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    gaps = clock.gaps_ms()

    if trace:
        # the traced run goes on for two slices of K steps: spans timed on
        # the host clock with no profiler, then the profiler over the device
        # (it is never on before the window closes: its callbacks slow the
        # eager launches that follow it)
        k = int(traffic["trace"]["steps"])
        spans.live = spans.timing = True
        for _ in range(k):
            loop.step(i, spans)
            i += 1
        spans.live = spans.timing = False
        sl = Slice(spans)
        launches0 = loop.launches()
        sl.start()
        for j in range(k):
            loop.step(i, spans)
            i += 1
            if j == 0:
                bound_inputs = loop.bound_inputs()
        sl.stop()
        launches = {key: v - launches0.get(key, 0) for key, v in loop.launches().items()}

    metrics = {}
    breakdown = None
    dev_info, trace_info = {}, None
    if not trace:
        ctx = dict(window_s=window_s, steps=steps, step_gaps_ms=gaps, setup_s=setup_s,
                   work={k: v * steps for k, v in loop.work.items()})
        readers = [(m, load_reader(m["name"], "end_to_end")) for m in e2e]
    else:
        tr_data = sl.read()
        ctx = dict(trace=tr_data, spans=spans, step_s=sum(gaps) / len(gaps) * 1e-3,
                   bounds=loop.bounds(bound_inputs, device), launches=launches)
        readers = [(m, load_reader(m["name"])) for m in per_layer]
        # a kind that runs on several cards averages the busy time over them
        busy_s = loop.busy_s(tr_data) if hasattr(loop, "busy_s") else tr_data.busy_s
        dev_info = dict(busy_s=busy_s, window_s=tr_data.window_s)
        trace_info = dict(syncs=tr_data.syncs, offset_us=tr_data.offset_us,
                          spans={k: len(v) for k, v in tr_data.spans.items()},
                          device_events=len(tr_data.device), launches=launches)
        breakdown = dict(device_ops=tr_data.device_ops(), idle_gaps=tr_data.idle_gaps())
    for m, read in readers:
        value = read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    # the comparison, once the program's state is freed
    num_envs = loop.num_envs
    kept = loop.close()
    del loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    check = kind.Check(cfg, traffic, device, overrides, kept)
    with torch.no_grad():
        numbers = worst([check.compare(check.program(cap), check.reference(cap), cap)
                         for cap in caps])
    compared = [(k, numbers.get(k, float("nan")), float(limits[k])) for k in sorted(limits)]
    failed = sum(1 for _, v, lim in compared if not v <= lim)
    result = {
        "correct": failed == 0,
        "attempted": len(compared),
        "failed": failed,
        "metrics": metrics,
        "device": dict(platform="gpu" if device.type == "cuda" else device.type,
                       kind=(torch.cuda.get_device_name(device) if device.type == "cuda"
                             else "cpu"),
                       count=int(cell["chips"]), memory_peak_bytes=int(peak), **dev_info),
    }
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in compared}
    info = dict(steps=steps, window_s=window_s, setup_s=setup_s, envs=num_envs,
                capture_steps=cap_steps, card=card_line() if device.type == "cuda" else "cpu",
                memory_peak_bytes=int(peak), step_gaps_ms=gaps)
    if trace_info is not None:
        info["trace"] = trace_info
    return result, compared, info
