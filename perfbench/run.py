"""Run one cell of the benchmark once.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, on standard output, the card and its power limit, the peak device
memory and the run's step count on earlier lines, and the result as one
JSON object on the last line. The numbers that decided ``correct`` go to
standard error as its last lines, each beside its limit, and into the
result under ``compared``. Exits 2 without a result when the card, or the
cards the cell asks for, are missing, and 3 when a module of JAX or of the
JAX package is loaded after the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".perfbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every cache of the program and its libraries at a fixed path in the checkout
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    sys.path.insert(0, str(ROOT))
    try:
        import aerial_gym_simulator_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port is not in this checkout: {e}", file=sys.stderr)
        return 1
    import torch
    torch.set_num_threads(1)     # load from one host thread: the loops are launch-bound
    from perfbench.harness import core

    try:
        result, compared, info = core.run_cell(args.workload, args.seed, args.seconds,
                                               bool(args.trace), T_START)
    except core.Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print("modules of JAX or of the JAX package are loaded: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print(f"card: {info['card']}")
    print(f"memory_peak_bytes: {info['memory_peak_bytes']}")
    keys = ("envs", "steps", "window_s", "setup_s", "capture_steps", "trace")
    print("run: " + json.dumps({k: info[k] for k in keys if k in info}))
    sys.stdout.flush()
    for name, value, limit in compared:
        print(f"{name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
