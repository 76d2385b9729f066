"""IMU data collection (reference examples/imu_data_collection.py).

Counterpart of the repository's ``examples/imu_data_collection.py``: logs
the simulated IMU stream (accelerometer and gyro with white noise and a
bias random walk) of a hovering quad to CSV, for noise and Allan-variance
analysis; ``utils/imu_to_rosbag`` reads the file. The measurement's normal
draws come from a ``torch.Generator`` seeded with 0.

    python -m aerial_gym_simulator_tpu_torch.examples.imu_data_collection
        [--steps 2000] [--out FILE] [--cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import tempfile

import numpy as np
import torch

from ..sensors.imu import imu_measurement, sample_imu_draws
from ..sim.sim_builder import SimBuilder
from ..sim.structs import replace
from ..utils.device import resolve_device

HEADER = ["t", "ax", "ay", "az", "gx", "gy", "gz"]


def build(device=None):
    env = SimBuilder().build_env("base_sim", "empty_env", "base_quadrotor_with_imu",
                                 "lee_position_control", num_envs=1, seed=0,
                                 device=resolve_device(device))
    env.reset()
    return env


def collect(env, steps, draws=None):
    """``steps`` of hover (zero position-setpoint actions), one IMU
    measurement after each, its biases written back -> (steps, 7) float64
    rows (t, ax, ay, az, gx, gy, gz) of env 0. ``draws(i)`` gives step i's
    ``ImuDraws``; by default they come from a generator seeded 0."""
    dev = env.state.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    hold = torch.zeros((env.state.num_envs, 4), device=dev)
    dt = float(env.params.dt)
    out = []
    for i in range(steps):
        env.step(hold)
        d = draws(i) if draws is not None else sample_imu_draws(gen, env.state.num_envs, dev)
        accel, gyro, new_ab, new_gb = imu_measurement(env.params, env.state, d)
        env.state = replace(env.state, imu_accel_bias=new_ab, imu_gyro_bias=new_gb)
        out.append(torch.cat([accel[0], gyro[0]]))
    values = torch.stack(out).cpu().numpy().astype(np.float64)
    t = np.arange(steps, dtype=np.float64)[:, None] * dt
    return np.concatenate([t, values], axis=1)


def write_csv(path, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(HEADER)
        for row in rows:
            w.writerow([float(v) for v in row])


def build_parser():
    p = argparse.ArgumentParser(description="log a hovering quad's IMU stream to CSV")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "imu_log.csv"))
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    env = build("cpu" if args.cpu else None)
    rows = collect(env, args.steps)
    write_csv(args.out, rows)
    print(f"wrote {args.steps} IMU samples to {args.out}")
    return rows


if __name__ == "__main__":
    main()
