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
  * the command line (``python -m aerial_gym_simulator_tpu_torch.utils.profiling``),
    whose body is ``profile_task``: it times a task's step (or one PPO
    iteration), traces the same work, and prints where the device time
    went.
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import logging
import os
import tempfile
import time
from typing import Callable, Dict

import torch

logger = logging.getLogger("profiling")

TRACE_FILE = "trace.json"
# the Chrome-trace categories of work on the device: kernels, copies, sets
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


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
    events = _read_trace(files[-1])
    events = events.get("traceEvents", []) if isinstance(events, dict) else events
    totals: Dict[str, float] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") in DEVICE_CATEGORIES:
            totals[ev["name"]] = totals.get(ev["name"], 0.0) + float(ev.get("dur", 0.0))
    s = sum(totals.values())
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:top_k]
    return [(name, us / iters / 1e3, (us / s if s else 0.0))
            for name, us in rows], s / iters / 1e3


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
    device time per call, from the trace), "rows" (op_breakdown's table),
    "trace_dir"}; with ``echo`` it prints the command line's report.
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

    step_once()                                   # warm-up
    _synchronize(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step_once()
    _synchronize(device)
    wall = (time.perf_counter() - t0) / iters

    tdir = trace_dir or tempfile.mkdtemp(prefix="agtorch_prof_")
    with trace(tdir):
        for _ in range(iters):
            step_once()
        _synchronize(device)
    rows, total_ms = op_breakdown(tdir, iters=iters, top_k=top)
    if not ppo and hasattr(task, "set_carry"):
        task.set_carry(box[0])
    report = {"label": label, "num_envs": n, "calls": 1 + 2 * iters, "wall_ms": wall * 1e3,
              "env_steps_per_s": unit_steps / wall, "device_ms": total_ms, "rows": rows,
              "trace_dir": tdir}
    if echo:
        print(f"\n{label} @ {n} envs: "
              f"{wall * 1e3:.2f} ms wall "
              f"({unit_steps / wall / 1e3:.1f}k env-steps/s), "
              f"{total_ms:.2f} ms summed device ops "
              f"(device idle share {1.0 - total_ms / (wall * 1e3):.3f})\n")
        print(f"{'ms/step':>9}  {'share':>6}  op")
        for op, ms, frac in rows:
            print(f"{ms:9.3f}  {100 * frac:5.1f}%  {op[:100]}")
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
    main()
