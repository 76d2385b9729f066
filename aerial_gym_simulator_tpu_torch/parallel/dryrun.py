"""Multi-process dry run: sharded PPO on a world of n processes.

Counterpart of ``aerial_gym_simulator_tpu/parallel/dryrun.py:18-60``. The
JAX package jits its train step over n virtual devices in one process; the
port runs n processes, one rank each, at tiny shapes: position PPO with the
env axis sharded and the learner replicated, then one iteration of
navigation PPO with the ray-cast renderer and the encoder in every rank's
rollout. Each rank asserts that its learner is bit-identical to every
other's and that its state holds exactly its block of the env axis.

    python -m aerial_gym_simulator_tpu_torch.parallel.dryrun 2 [--cpu]

The ranks run on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import sys


def run_rank(process_id: int, n_devices: int, coordinator: str, device: str) -> None:
    """One rank of the dry run."""
    import numpy as np
    import torch

    from .. import task_registry
    from ..rl.ppo import PPOConfig, PPOTrainer
    from .distributed import initialize_multihost, shard_trainer
    from .multiproc import backend_for, param_norms_equal

    if device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(coordinator, n_devices, process_id, require=True,
                         backend=backend_for(device, n_devices))
    num_envs = 4 * n_devices                      # tiny but shardable
    task = task_registry.make_task("position_setpoint_task", num_envs=num_envs, seed=0,
                                   device=device)
    cfg = PPOConfig(num_envs=num_envs, horizon=4, minibatch_size=num_envs * 4 // 2, epochs=2,
                    seed=0)
    trainer = PPOTrainer(task, cfg)
    shard_trainer(trainer)
    hist = trainer.train(total_env_steps=num_envs * cfg.horizon, log_every=1)
    same, _ = param_norms_equal(trainer.network, trainer.shard)
    assert np.isfinite(hist[-1]["reward_mean"]) and same
    assert trainer.env_carry.pos.shape[0] == num_envs // n_devices, "state not sharded"
    if process_id == 0:
        print(f"dryrun_multichip OK: {n_devices} processes, {num_envs} envs sharded, "
              f"reward_mean={hist[-1]['reward_mean']:.3f}", flush=True)

    # the vision pipeline: ray cast + encoder in every rank's rollout
    nav_envs = 2 * n_devices
    nav_task = task_registry.make_task("navigation_task", num_envs=nav_envs, seed=1,
                                       device=device)
    nav_cfg = PPOConfig(num_envs=nav_envs, horizon=2, minibatch_size=nav_envs, epochs=1, seed=1)
    nav_trainer = PPOTrainer(nav_task, nav_cfg)
    shard_trainer(nav_trainer)
    hist = nav_trainer.train(total_env_steps=nav_envs * nav_cfg.horizon, log_every=1)
    same, _ = param_norms_equal(nav_trainer.network, nav_trainer.shard)
    assert np.isfinite(hist[-1]["reward_mean"]) and same
    assert nav_trainer.env_carry.sim.pos.shape[0] == nav_envs // n_devices
    if process_id == 0:
        print(f"dryrun_multichip OK (navigation): {n_devices} processes, {nav_envs} envs, "
              f"render+encoder in the sharded rollout, "
              f"reward_mean={hist[-1]['reward_mean']:.3f}", flush=True)
    print(f"DRYRUN_RANK_OK {process_id}/{n_devices}", flush=True)


def run_dryrun(n_devices: int, device: str = "cuda", timeout_s: float = 600.0) -> None:
    """Spawn the n ranks, check each, print rank 0's lines; raises on any
    failure."""
    from .multiproc import free_port, spawn, worker_env

    port = free_port()
    argvs = [[sys.executable, "-m", "aerial_gym_simulator_tpu_torch.parallel.dryrun",
              str(n_devices), "--process_id", str(pid), "--coordinator",
              f"127.0.0.1:{port}"] + (["--cpu"] if device == "cpu" else [])
             for pid in range(n_devices)]
    rcs, outputs = spawn(argvs, timeout_s, env=worker_env())
    for pid, (rc, out) in enumerate(zip(rcs, outputs)):
        if rc != 0 or f"DRYRUN_RANK_OK {pid}/{n_devices}" not in out:
            tail = "\n".join(out.splitlines()[-25:])
            raise RuntimeError(f"dry run rank {pid} failed (rc={rc}):\n{tail}")
    for line in outputs[0].splitlines():
        if line.startswith("dryrun_multichip"):
            print(line, flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("n_devices", type=int)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is CUDA, which must be available)")
    ap.add_argument("--process_id", type=int, default=None, help="(a rank of the run)")
    ap.add_argument("--coordinator", default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.process_id is None:
        run_dryrun(args.n_devices, device)
    else:
        run_rank(args.process_id, args.n_devices, args.coordinator, device)


if __name__ == "__main__":
    main()
