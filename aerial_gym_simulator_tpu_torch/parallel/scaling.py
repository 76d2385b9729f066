"""Scaling harness: the same sharded PPO run in one process and in N.

Counterpart of ``aerial_gym_simulator_tpu/parallel/scaling.py``. Runs the
same PPO training in (a) a process group of one and (b) one of N processes
(one device each), times the steady state of each and emits one JSON line
with the aggregate env-steps/s: weak scaling (``run_rehearsal``: the envs
per process held constant, an efficiency) or strong scaling
(``run_strong_rehearsal``: the same global env count, a throughput ratio).

On one host whose processes share cores or one GPU, these numbers check the
harness and are not efficiencies: the legs contend for the same silicon.
On N GPUs, each leg's processes own their device; run per host::

    torchrun --nproc_per_node=G --nnodes=H ... \\
        -m aerial_gym_simulator_tpu_torch.parallel.scaling --worker

and compare against a one-process run of the same per-device config. Every
process runs on CUDA unless ``--cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def timed_train_steps_per_s(task_name: str, num_envs: int, horizon: int, warmup_iters: int,
                            timed_iters: int, seed: int = 0, device: str = "cuda") -> float:
    """Build the task and a PPO trainer at ``num_envs`` global envs, shard
    it over the world, run ``warmup_iters``, then time ``timed_iters``
    iterations -> aggregate env-steps/s (the device synchronized at both
    ends of the timed span)."""
    import torch

    from .. import task_registry
    from ..rl.ppo import PPOConfig, PPOTrainer
    from .distributed import shard_trainer

    task = task_registry.make_task(task_name, num_envs=num_envs, seed=seed, device=device)
    cfg = PPOConfig(num_envs=num_envs, horizon=horizon,
                    minibatch_size=max(num_envs * horizon // 4, 1), epochs=1, seed=seed)
    trainer = PPOTrainer(task, cfg)
    shard_trainer(trainer)
    steps_per_iter = num_envs * horizon

    def sync():
        if trainer.device.type == "cuda":
            torch.cuda.synchronize(trainer.device)

    trainer.train(total_env_steps=steps_per_iter * warmup_iters, log_every=max(warmup_iters, 1))
    sync()
    t0 = time.perf_counter()
    trainer.train(total_env_steps=steps_per_iter * timed_iters, log_every=max(timed_iters, 1))
    sync()
    return steps_per_iter * timed_iters / (time.perf_counter() - t0)


def dry_topology(num_hosts: int, chips_per_host: int, num_envs: int,
                 task_name: str = "position_setpoint_task") -> dict:
    """The layout a cluster run would use, by arithmetic alone (no process
    group, no device): one process per GPU, one 1-D ``env`` axis over all of
    them, every env-batched tensor in blocks on it, the learner replicated,
    the gradient and metric reductions all-reduced."""
    n_devices = num_hosts * chips_per_host
    if num_envs % n_devices:
        raise ValueError(f"num_envs {num_envs} must divide over {n_devices} devices "
                         f"({num_hosts} hosts x {chips_per_host} chips)")
    return {
        "metric": "scaling_dry_topology",
        "task": task_name,
        "num_hosts": num_hosts,
        "chips_per_host": chips_per_host,
        "mesh_shape": [n_devices],
        "mesh_axes": ["env"],
        "num_envs": num_envs,
        "envs_per_device": num_envs // n_devices,
        "shardings": {
            "sim_state": "a contiguous block of the leading env axis per rank",
            "observations/rollouts": "the same block",
            "learner_params/opt_state": "replicated (broadcast from rank 0)",
            "generators": "replicated; each env-batched draw made at the global count, "
                          "this rank's rows kept (utils/env_rng)",
        },
        "collectives": {
            "gradient": "all_reduce (SUM) of one flat buffer per minibatch step over the "
                        "env group (NCCL: NVLink within a host, the network across hosts)",
            "metrics": "all_reduce (SUM) over the env group",
        },
        "launch": [
            f"torchrun --nnodes={num_hosts} --nproc_per_node={chips_per_host} "
            "--rdzv_endpoint=host0:port -m aerial_gym_simulator_tpu_torch.rl.ppo --multichip",
        ],
    }


def run_worker(process_id: int, num_processes: int, coordinator: str, device: str,
               task_name: str, envs_per_device: int, horizon: int, warmup_iters: int,
               timed_iters: int, total_envs: int = 0) -> None:
    """One timing process. With ``num_processes`` 1 it is the one-process
    baseline, on the same code path. Rank 0 prints ``SCALING_RESULT
    {json}``."""
    import torch

    from . import mesh as meshlib
    from .distributed import initialize_multihost
    from .multiproc import backend_for

    if device == "cpu":
        torch.set_num_threads(1)
    initialize_multihost(coordinator, num_processes, process_id, require=True,
                         backend=backend_for(device, num_processes))
    num_envs = total_envs if total_envs else envs_per_device * num_processes
    sps = timed_train_steps_per_s(task_name, num_envs, horizon, warmup_iters, timed_iters,
                                  device=device)
    meshlib.barrier(meshlib.make_mesh(), torch.device(device))
    if process_id == 0:
        print("SCALING_RESULT " + json.dumps({"num_processes": num_processes,
                                              "global_devices": num_processes,
                                              "num_envs": num_envs, "steps_per_s": sps}),
              flush=True)
    print(f"SCALING_WORKER_OK {process_id}/{num_processes}", flush=True)


def _spawn_leg(num_processes: int, task_name: str, envs_per_device: int, horizon: int,
               warmup_iters: int, timed_iters: int, timeout_s: float, device: str,
               total_envs: int = 0) -> dict:
    """One timing leg (1 or N processes) -> its SCALING_RESULT dict."""
    from .multiproc import free_port, spawn, worker_env

    port = free_port()
    argvs = [[sys.executable, "-m", "aerial_gym_simulator_tpu_torch.parallel.scaling",
              "--process_id", str(pid), "--num_processes", str(num_processes),
              "--coordinator", f"127.0.0.1:{port}", "--task", task_name,
              "--envs_per_device", str(envs_per_device), "--horizon", str(horizon),
              "--warmup_iters", str(warmup_iters), "--timed_iters", str(timed_iters),
              "--total_envs", str(total_envs)] + (["--cpu"] if device == "cpu" else [])
             for pid in range(num_processes)]
    rcs, outputs = spawn(argvs, timeout_s, env=worker_env())
    for pid, (rc, out) in enumerate(zip(rcs, outputs)):
        if rc != 0:
            tail = "\n".join(out.splitlines()[-25:])
            raise RuntimeError(f"scaling worker {pid} failed (rc={rc}):\n{tail}")
    for line in outputs[0].splitlines():
        if line.startswith("SCALING_RESULT "):
            return json.loads(line[len("SCALING_RESULT "):])
    raise RuntimeError("no SCALING_RESULT line from process 0:\n" + outputs[0][-2000:])


def _mode(device: str, num_processes: int) -> str:
    import torch
    if device == "cuda" and torch.cuda.device_count() >= num_processes:
        return ("one process per GPU on one host: the efficiency measures the collectives and "
                "the host's shared cores, not a multi-host pod")
    return ("one-host rehearsal of the cluster harness: the processes share this host's cores "
            "or one GPU, so the efficiency measures contention, NOT scaling")


def run_rehearsal(num_processes: int = 2, task_name: str = "position_setpoint_task",
                  envs_per_device: int = 64, horizon: int = 16, warmup_iters: int = 3,
                  timed_iters: int = 20, timeout_s: float = 600.0, verbose: bool = True,
                  device: str = "cuda") -> dict:
    """The one-process baseline and the N-process cluster with the same
    envs per process -> one summary (aggregate env-steps/s of both, the
    weak-scaling efficiency). On one shared host a harness check only."""
    single = _spawn_leg(1, task_name, envs_per_device, horizon, warmup_iters, timed_iters,
                        timeout_s, device)
    multi = _spawn_leg(num_processes, task_name, envs_per_device, horizon, warmup_iters,
                       timed_iters, timeout_s, device)
    scaleup = multi["global_devices"] / single["global_devices"]
    efficiency = multi["steps_per_s"] / (single["steps_per_s"] * scaleup)
    summary = {
        "metric": "scaling_efficiency_rehearsal",
        "mode": _mode(device, num_processes),
        "host_cpu_count": os.cpu_count(),
        "device": device,
        "task": task_name,
        "weak_scaling_envs_per_device": envs_per_device,
        "single_process": single,
        "multi_process": multi,
        "efficiency": round(efficiency, 4),
        "baseline_target": ">=0.80 at N>=2 hosts (measure with one GPU per process)",
    }
    if verbose:
        print(json.dumps(summary), flush=True)
    return summary


def run_strong_rehearsal(num_processes: int = 2, task_name: str = "position_setpoint_task",
                         total_envs: int = 128, horizon: int = 16, warmup_iters: int = 3,
                         timed_iters: int = 20, timeout_s: float = 600.0,
                         verbose: bool = True, device: str = "cuda") -> dict:
    """The same global env count through 1 and N processes -> one summary
    with the throughput ratio: a sanity signal (its bounds belong to the
    caller), not an efficiency."""
    single = _spawn_leg(1, task_name, 0, horizon, warmup_iters, timed_iters, timeout_s,
                        device, total_envs=total_envs)
    multi = _spawn_leg(num_processes, task_name, 0, horizon, warmup_iters, timed_iters,
                       timeout_s, device, total_envs=total_envs)
    assert single["num_envs"] == multi["num_envs"] == total_envs
    summary = {
        "metric": "scaling_strong_rehearsal",
        "mode": "strong-scaling rehearsal: the same total envs through 1 vs N processes on one "
                "host, a throughput-ratio sanity signal, NOT an efficiency",
        "host_cpu_count": os.cpu_count(),
        "device": device,
        "task": task_name,
        "total_envs": total_envs,
        "single_process": single,
        "multi_process": multi,
        "throughput_ratio": round(multi["steps_per_s"] / single["steps_per_s"], 4),
        "pod_note": "with one GPU per process run the weak-scaling mode and compare against "
                    "the >=0.80 target",
    }
    if verbose:
        print(json.dumps(summary), flush=True)
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rehearse", type=int, default=None, metavar="N",
                    help="run the 1-vs-N-process rehearsal locally")
    ap.add_argument("--strong", action="store_true",
                    help="with --rehearse: strong scaling (the same total envs in both legs)")
    ap.add_argument("--dry_topology", nargs=3, type=int, default=None,
                    metavar=("HOSTS", "CHIPS", "ENVS"),
                    help="print the layout a cluster run would use and exit")
    ap.add_argument("--worker", action="store_true",
                    help="one timing process of a world torchrun set up (RANK, WORLD_SIZE)")
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is CUDA, which must be available)")
    ap.add_argument("--task", default="position_setpoint_task")
    ap.add_argument("--envs_per_device", type=int, default=64)
    ap.add_argument("--horizon", type=int, default=16)
    ap.add_argument("--warmup_iters", type=int, default=3)
    ap.add_argument("--timed_iters", type=int, default=20)
    ap.add_argument("--total_envs", type=int, default=0,
                    help="strong scaling: a fixed global env count (0: --envs_per_device)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.dry_topology is not None:
        hosts, chips, envs = args.dry_topology
        print(json.dumps(dry_topology(hosts, chips, envs, args.task)))
        return
    if args.rehearse is not None:
        if args.strong:
            run_strong_rehearsal(args.rehearse, args.task, args.total_envs or 128, args.horizon,
                                 args.warmup_iters, args.timed_iters, device=device)
        else:
            run_rehearsal(args.rehearse, args.task, args.envs_per_device, args.horizon,
                          args.warmup_iters, args.timed_iters, device=device)
        return
    if args.worker:
        args.process_id = int(os.environ["RANK"])
        args.num_processes = int(os.environ["WORLD_SIZE"])
        args.coordinator = f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    if args.process_id is None or args.coordinator is None:
        ap.error("worker mode needs --process_id and --coordinator (or --worker under "
                 "torchrun, --rehearse N, --dry_topology)")
    run_worker(args.process_id, args.num_processes, args.coordinator, device, args.task,
               args.envs_per_device, args.horizon, args.warmup_iters, args.timed_iters,
               total_envs=args.total_envs)


if __name__ == "__main__":
    main()
