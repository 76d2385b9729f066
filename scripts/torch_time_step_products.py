"""Time the PyTorch port's sim step and its obstacle-frame packing on a GPU.

The port is imported from the checkout given by ``--root`` (this one's by
default), so two checkouts can be compared on one card, one process each,
in turns (A, B, B, A)::

    python scripts/torch_time_step_products.py --root /path/to/other/checkout --label parent
    python scripts/torch_time_step_products.py --label change

For each env count it builds the obstacle env (``base_quadrotor_with_camera``
under ``lee_velocity_control`` in ``env_with_obstacles``), then times
``dynamics.env_step`` and ``raycast_cuda.pack_prims_world`` on the card:
after a warm-up, ``--windows`` windows of ``--iters`` calls each, the device
synchronised at both ends of a window. Both are launch-bound eager code, so
a window's wall time over its calls is the cost of a call. Prints one JSON
line with every window's ms per call and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


def windows_ms(torch, fn, iters: int, windows: int):
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3 / iters)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    help="the checkout whose aerial_gym_simulator_tpu_torch is timed")
    ap.add_argument("--label", default="")
    ap.add_argument("--envs", type=int, nargs="+", default=[1024, 16384])
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--windows", type=int, default=5)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        print("torch_time_step_products: CUDA is not available", file=sys.stderr)
        return 1
    import aerial_gym_simulator_tpu_torch as port
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda
    from aerial_gym_simulator_tpu_torch.sim import dynamics

    assert os.path.dirname(os.path.abspath(port.__file__)).startswith(os.path.abspath(args.root))
    names = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
             "lee_velocity_control")
    result = {"label": args.label, "root": os.path.abspath(args.root), "card": card_line(),
              "iters": args.iters, "cells": []}
    for n in args.envs:
        env = port.SimBuilder().build_env(*names, num_envs=n, seed=3)
        env.reset()
        action = torch.full((n, 4), 0.1, device=env.device)
        state = env.state

        def step():
            dynamics.env_step(env.params, state, action)

        def pack():
            raycast_cuda.pack_prims_world(env.params.scene, state.obstacle_pos,
                                          state.obstacle_quat)

        result["cells"].append({"num_envs": n,
                                "env_step_ms": windows_ms(torch, step, args.iters, args.windows),
                                "pack_prims_world_ms": windows_ms(torch, pack, args.iters,
                                                                  args.windows)})
        del env, state, action
        torch.cuda.empty_cache()
    print("STEP_PRODUCTS " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
