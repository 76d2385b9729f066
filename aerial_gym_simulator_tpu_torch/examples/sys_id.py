"""Motor-model system identification (reference examples/sys_id.py and
sim2real/motorid_utilities/).

Counterpart of the repository's ``examples/sys_id.py``: writes the
simulated motor step response as CSV, for both Euler and RK4 integration,
for comparison against test-bench data; ``--fit CSV`` instead fits the
asymmetric first-order time constants from a measured (time, thrust)
trace.

    python -m aerial_gym_simulator_tpu_torch.examples.sys_id [--robot base_quadrotor]
        [--dt 0.01] [--steps 100] [--ref_thrust 1.5] [--out FILE] [--fit CSV] [--cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import tempfile

import numpy as np
import torch

from ..ops.motor_model import motor_step
from ..registry.registries import robot_registry
from ..sim.params import build_motor_params
from ..utils.device import resolve_device


def simulate_step_response(robot_name, scheme, dt, steps, ref_value, device=None):
    """The first motor's thrust over ``steps`` motor steps from rest towards
    ``ref_value`` (N), with the robot's motor model integrated by
    ``scheme`` ("euler" or "rk4") -> (steps,) float64 numpy."""
    dev = resolve_device(device)
    cfg = robot_registry.make(robot_name)
    cfg.control_allocator_config.motor_model_config.integration_scheme = scheme
    mp = build_motor_params(cfg, dev)
    M = mp.num_motors
    full = lambda v: torch.full((1, M), v, dtype=torch.float32, device=dev)
    thrust = full(0.0)
    tau_i, tau_d = full(mp.tau_inc_min), full(mp.tau_dec_min)
    kt = full((mp.thrust_constant_min + mp.thrust_constant_max) / 2)
    ref = full(ref_value)
    out = []
    for _ in range(steps):
        thrust = motor_step(mp, dt, ref, thrust, tau_i, tau_d, kt)
        out.append(thrust[0, 0])
    return torch.stack(out).cpu().numpy().astype(np.float64)


def fit_time_constants(times, thrusts):
    """Fit asymmetric first-order time constants from a measured motor step
    trace (the reference's motorid workflow,
    sim2real/motorid_utilities/motor_model_identification.ipynb): split the
    trace into rising and falling segments against the steady levels and
    least-squares fit tau on log(1 - normalized response)."""
    times = np.asarray(times, np.float64)
    thrusts = np.asarray(thrusts, np.float64)
    lo, hi = thrusts.min(), thrusts.max()
    grad = np.gradient(thrusts, times)
    # settled plateaus are left out of both segments: near-zero-gradient
    # samples carry no time-constant information and would anchor the
    # falling fit at a plateau's timestamp
    moving = np.abs(grad) > 0.05 * np.abs(grad).max()
    rising = (grad > 0) & moving

    def fit(mask, target, start):
        t = times[mask]
        y = thrusts[mask]
        if len(t) < 4 or abs(target - start) < 1e-9:
            return float("nan")
        u = 1.0 - (y - start) / (target - start)
        # converged samples go: the settled tail carries no slope
        # information and (clipped) would bias the fit
        keep = u > 1e-3
        if keep.sum() < 4:
            return float("nan")
        t, u = t[keep], u[keep]
        # log(u) = -(t - t0)/tau  ->  slope = -1/tau
        A = np.vstack([t - t[0], np.ones_like(t)]).T
        slope, _ = np.linalg.lstsq(A, np.log(u), rcond=None)[0]
        return -1.0 / slope if slope < 0 else float("nan")

    tau_inc = fit(rising, hi, lo)
    tau_dec = fit((grad < 0) & moving, lo, hi)
    return tau_inc, tau_dec


def read_trace_csv(path):
    """(times, thrusts) from a time,thrust CSV; a first line that is not
    numeric is taken as a header."""
    with open(path) as f:
        first = f.readline()
    try:
        float(first.split(",")[0])
        skip = 0
    except ValueError:
        skip = 1
    rows = np.loadtxt(path, delimiter=",", skiprows=skip, ndmin=2)
    return rows[:, 0], rows[:, 1]


def build_parser():
    p = argparse.ArgumentParser(description="motor step response and time-constant fit")
    p.add_argument("--robot", default="base_quadrotor")
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--ref_thrust", type=float, default=1.5)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                 "motor_step_response.csv"))
    p.add_argument("--fit", default=None, metavar="CSV",
                   help="fit tau_inc/tau_dec from a measured time,thrust "
                        "CSV (motor test-bench trace) instead of simulating")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if args.fit:
        ti, td = fit_time_constants(*read_trace_csv(args.fit))
        print(f"fitted tau_inc={ti:.4f}s tau_dec={td:.4f}s from {args.fit}")
        return ti, td

    euler = simulate_step_response(args.robot, "euler", args.dt, args.steps,
                                   args.ref_thrust, device)
    rk4 = simulate_step_response(args.robot, "rk4", args.dt, args.steps,
                                 args.ref_thrust, device)
    with open(args.out, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["t", "thrust_euler", "thrust_rk4"])
        for i in range(args.steps):
            w.writerow([i * args.dt, euler[i], rk4[i]])
    # the analytic first-order response, for reference
    tau = 0.04
    t63 = np.argmax(rk4 >= (1 - np.exp(-1)) * args.ref_thrust) * args.dt
    print(f"wrote {args.out}")
    print(f"63% time: {t63:.3f}s (configured tau ~ {tau}s domain-dependent)")
    print(f"final: euler {euler[-1]:.4f}  rk4 {rk4[-1]:.4f}  "
          f"ref {args.ref_thrust}")
    return euler, rk4


if __name__ == "__main__":
    main()
