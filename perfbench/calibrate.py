"""Readings for the limits of a cell's compared numbers, on the card.

    python3 perfbench/calibrate.py --workload <name> --seeds <n> [<n> ...] [--seconds <s>]

For each seed: builds the cell, runs a short window at the cell's own load
(long enough to pass its capture steps), and prints one JSON line with the
program's numbers against the references at the configuration's precision
("program") and the control's numbers: the references at the next precision
below, put in the program's place ("control"). The lower reading of a
number is the largest "program" value over the seeds, the upper reading the
smallest "control" value. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(name, seed, seconds, device="cuda", overrides=None):
    """-> {"program": {...}, "control": {...}, "steps": n} of one seed."""
    import torch

    from perfbench.harness import core
    from perfbench.harness.checks import worst
    from perfbench.harness.tracing import Spans

    overrides = overrides or {}
    _, cfg, traffic, _, _, _ = core.load_cell(name)
    kind = core.load_kind(traffic["kind"])
    dev = torch.device(device)
    loop = kind.Loop(cfg, traffic, dev, seed, overrides)
    cap_steps, rows = core.plan_captures(traffic, loop.num_envs, seed, dev)
    spans = Spans(dev)
    caps = []
    t0 = time.perf_counter()
    i = 0
    while i <= max(cap_steps) or time.perf_counter() - t0 < seconds:
        cap = {"rows": rows, "step": i} if i in cap_steps else None
        if cap is not None:
            caps.append(cap)
        loop.step(i, spans, cap)
        i += 1
    check = kind.Check(cfg, traffic, dev, overrides, loop.close())
    prog, ctrl = [], []
    with torch.no_grad():
        for cap in caps:
            ref = check.reference(cap)
            prog.append(check.compare(check.program(cap), ref, cap))
            ctrl.append(check.compare(check.reference(cap, "control"), ref, cap))
    return {"program": worst(prog), "control": worst(ctrl), "steps": i}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    for seed in args.seeds:
        out = readings(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
