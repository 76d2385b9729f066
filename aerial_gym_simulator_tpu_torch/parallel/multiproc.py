"""A real multi-process cluster, brought up and checked.

Counterpart of ``aerial_gym_simulator_tpu/parallel/multiproc.py``. The
worker runs what a multi-GPU or multi-host launch hits first and no
single-process test reaches:

  * the rendezvous through ``distributed.initialize_multihost``,
  * a collective across the process boundary (a global sum),
  * sharded position PPO, whose gradient all-reduce crosses the boundary,
    with the learner bit-identical on every rank afterwards,
  * a training-state save, perturb and restore in which every rank takes
    part (the carry gathered whole, written by rank 0, cut again on load),
    and an iteration after it,
  * LiDAR-navigation PPO with its whole sensor pipeline (the ray cast, K2 on
    the card, in every rank's rollout), the learner again identical.

Worker (one per process)::

    python -m aerial_gym_simulator_tpu_torch.parallel.multiproc \\
        --process_id 0 --num_processes 2 --coordinator 127.0.0.1:NNNN [--cpu]

Launcher (the whole local cluster, every worker checked, one summary JSON
line)::

    python -m aerial_gym_simulator_tpu_torch.parallel.multiproc --launch 2 [--cpu] [--timeout S]

The workers run on CUDA unless ``--cpu`` is given. Several ranks on one GPU
use gloo (``distributed.default_backend``).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Sequence, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(argvs: Sequence[Sequence[str]], timeout_s: float, env=None,
          cwd: str = REPO_ROOT) -> Tuple[List[int], List[str]]:
    """Run one process per argv, all at once -> (return codes, outputs).

    The workers write to temporary files, not pipes: the launcher waits on
    them in turn and collectives couple them, so a worker blocked on a full
    pipe while an earlier one is drained would turn any failure into the
    whole timeout. A worker past the deadline is killed by its own PID
    (never by a pattern) and gets return code -9."""
    procs, logs = [], []
    try:
        for i, argv in enumerate(argvs):
            log = tempfile.NamedTemporaryFile(mode="w+", prefix=f"worker{i}_", suffix=".log",
                                              delete=False)
            logs.append(log)
            procs.append(subprocess.Popen(list(argv), cwd=cwd, env=env, stdout=log,
                                          stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + timeout_s
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        outputs = []
        for log in logs:
            log.flush()
            log.seek(0)
            outputs.append(log.read())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
            os.unlink(log.name)
    return [p.returncode for p in procs], outputs


def worker_env(threads: int = 1) -> dict:
    """The launcher's environment for its workers, with the repo importable
    and the intra-op threads of each worker capped (the workers share the
    host's cores)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO_ROOT, env.get("PYTHONPATH")]))
    env["OMP_NUM_THREADS"] = str(threads)
    return env


def backend_for(device: str, num_processes: int) -> str:
    """gloo on the CPU and when this host's ranks (``LOCAL_WORLD_SIZE``, else
    all ``num_processes``) outnumber its GPUs."""
    import torch

    from .distributed import default_backend
    local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    gpus = torch.cuda.device_count() if device == "cuda" else 0
    return default_backend(device, -(-local // gpus) if gpus else local)


# -- the worker -------------------------------------------------------------------


def param_norms_equal(module, shard) -> Tuple[bool, float]:
    """Every rank's parameter norm, gathered (a zero-padded all-reduce) ->
    (all bit-identical, this rank's norm)."""
    import torch

    from . import mesh as meshlib
    params = list(module.parameters())
    norm = torch.sqrt(sum((p.detach() ** 2).sum() for p in params))
    norms = torch.zeros(shard.world, device=norm.device)
    norms[shard.rank] = norm
    meshlib.all_reduce_(norms, shard)
    return bool((norms == norms[0]).all()), float(norm)


def run_worker(process_id: int, num_processes: int, coordinator: str, device: str,
               ckpt_dir: str) -> dict:
    """One cluster process: rendezvous, the checks of the module docstring
    in order, each asserted loudly; -> what it saw."""
    import numpy as np
    import torch

    from .. import task_registry
    from ..rl.ppo import PPOConfig, PPOTrainer
    from . import mesh as meshlib
    from .distributed import initialize_multihost, shard_trainer

    if device == "cpu":
        torch.set_num_threads(1)
    backend = backend_for(device, num_processes)
    initialize_multihost(coordinator, num_processes, process_id, require=True, backend=backend)
    world = meshlib._dist().get_world_size()
    assert world == num_processes, (world, num_processes)
    dev = torch.device(device)

    # a global arange, each rank its block, summed across the boundary
    shard = meshlib.env_sharding(meshlib.make_mesh(), 8 * world)
    n_elem = 8 * world
    part = torch.arange(n_elem, dtype=torch.float32, device=dev)[shard.offset:
                                                                 shard.offset + shard.n_local]
    total = meshlib.all_reduce_(part.sum(), shard).item()
    assert total == n_elem * (n_elem - 1) / 2, total
    print(f"[mp {process_id}] collectives ok: global sum {total:.0f} over {world} processes "
          f"({backend})", flush=True)

    # sharded position PPO: the gradient all-reduce across processes
    num_envs = 4 * world
    task = task_registry.make_task("position_setpoint_task", num_envs=num_envs, seed=0,
                                   device=device)
    cfg = PPOConfig(num_envs=num_envs, horizon=4, minibatch_size=num_envs * 4 // 2, epochs=2,
                    seed=0)
    trainer = PPOTrainer(task, cfg)
    shard_trainer(trainer)
    hist = trainer.train(total_env_steps=num_envs * cfg.horizon * 2, log_every=1)
    assert np.isfinite(hist[-1]["reward_mean"])
    same, pnorm = param_norms_equal(trainer.network, trainer.shard)
    assert same, "parameters differ across processes"
    print(f"[mp {process_id}] train step ok: reward_mean={hist[-1]['reward_mean']:.3f}, "
          f"param_norm identical across processes ({pnorm:.6f})", flush=True)

    # the training state saved whole, perturbed, restored exactly
    trainer.save_training_state(ckpt_dir)
    before = [p.detach().clone() for p in trainer.network.parameters()]
    pos_before = meshlib.gather_env_pytree(trainer.env_carry.pos, trainer.shard)
    with torch.no_grad():
        for p in trainer.network.parameters():
            p.add_(1.0)
    resumed = trainer.restore_training_state(ckpt_dir)
    assert all(torch.equal(b, p) for b, p in zip(before, trainer.network.parameters()))
    assert torch.equal(pos_before, meshlib.gather_env_pytree(trainer.env_carry.pos,
                                                             trainer.shard))
    print(f"[mp {process_id}] checkpoint roundtrip ok (resumed iter {resumed})", flush=True)
    hist2 = trainer.train(total_env_steps=num_envs * cfg.horizon, log_every=1)
    assert np.isfinite(hist2[-1]["reward_mean"])

    # LiDAR navigation: the whole sensor pipeline in every rank's rollout
    lidar_envs = 4 * world
    lidar_task = task_registry.make_task("lidar_navigation_task", num_envs=lidar_envs, seed=7,
                                         device=device)
    lidar_cfg = PPOConfig(num_envs=lidar_envs, horizon=2, minibatch_size=lidar_envs, epochs=1,
                          seed=7)
    lidar_tr = PPOTrainer(lidar_task, lidar_cfg)
    shard_trainer(lidar_tr)
    lhist = lidar_tr.train(total_env_steps=lidar_envs * lidar_cfg.horizon, log_every=1)
    assert np.isfinite(lhist[-1]["reward_mean"])
    same, lnorm = param_norms_equal(lidar_tr.network, lidar_tr.shard)
    assert same, "lidar-nav parameters differ across processes"
    print(f"[mp {process_id}] lidar-nav step ok: reward_mean={lhist[-1]['reward_mean']:.3f}, "
          f"param_norm identical across processes ({lnorm:.6f})", flush=True)
    print(f"MULTIPROC_LIDAR_OK {process_id}/{num_processes}", flush=True)
    meshlib.barrier(shard, dev)
    print(f"MULTIPROC_WORKER_OK {process_id}/{num_processes} backend={backend}", flush=True)
    return {"backend": backend, "param_norm": pnorm, "lidar_param_norm": lnorm}


# -- the launcher -------------------------------------------------------------------


def launch_cluster(num_processes: int = 2, device: str = "cuda", timeout_s: float = 600.0,
                   verbose: bool = True) -> dict:
    """Spawn a local ``num_processes`` cluster of this module's worker and
    check every worker -> a summary dict (JAX's keys; also printed as one
    JSON line). Raises on any worker failure: a multi-process path skipped
    in silence is worse than a loud one. The checkpoint directory is
    removed afterwards. A worker still running after ``timeout_s`` is
    killed and the tail of every worker's log is printed: keep the timeout
    under the caller's own limit, or nothing of where it stopped is seen."""
    port = free_port()
    ckpt_dir = tempfile.mkdtemp(prefix="mp_ckpt_")
    argvs = [[sys.executable, "-m", "aerial_gym_simulator_tpu_torch.parallel.multiproc",
              "--process_id", str(pid), "--num_processes", str(num_processes),
              "--coordinator", f"127.0.0.1:{port}", "--ckpt_dir", ckpt_dir]
             + (["--cpu"] if device == "cpu" else []) for pid in range(num_processes)]
    try:
        rcs, outputs = spawn(argvs, timeout_s, env=worker_env())
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    ok = all(rc == 0 for rc in rcs)
    markers = [f"MULTIPROC_WORKER_OK {pid}/{num_processes}" in out
               for pid, out in enumerate(outputs)]
    lidar = [f"MULTIPROC_LIDAR_OK {pid}/{num_processes}" in out
             for pid, out in enumerate(outputs)]
    backend = next((line.rsplit("backend=", 1)[1].strip() for line in outputs[0].splitlines()
                    if line.startswith("MULTIPROC_WORKER_OK")), None)
    passed = ok and all(markers)
    summary = {
        "multiproc_cluster": "ok" if passed else "FAILED",
        "num_processes": num_processes,
        "local_devices_per_process": 1,
        "global_devices": num_processes,
        "collectives": backend,
        "train_step_cross_process": bool(passed),
        "lidar_nav_full_sensor_cross_process": bool(ok and all(lidar)),
        # the JAX package's key: there an orbax save; here the gathered
        # training state written by rank 0 and cut again on restore
        "orbax_multiprocess_roundtrip": bool(passed),
        "device": device,
    }
    if verbose:
        print(json.dumps(summary), flush=True)
    if not passed:
        for pid, out in enumerate(outputs):
            tail = "\n".join(out.splitlines()[-25:])
            print(f"--- worker {pid} (rc={rcs[pid]}) ---\n{tail}", file=sys.stderr, flush=True)
        raise RuntimeError("multi-process cluster FAILED (see worker logs)")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--launch", type=int, default=None, metavar="N",
                    help="spawn an N-process local cluster and check it")
    ap.add_argument("--process_id", type=int, default=None)
    ap.add_argument("--num_processes", type=int, default=2)
    ap.add_argument("--coordinator", default=None, help="host:port of rank 0")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is CUDA, which must be available)")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="with --launch: seconds before the workers are killed and their logs "
                         "printed")
    ap.add_argument("--ckpt_dir", default=None)
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    if args.launch is not None:
        launch_cluster(args.launch, device, timeout_s=args.timeout)
        return
    if args.process_id is None or args.coordinator is None:
        ap.error("worker mode needs --process_id and --coordinator (or use --launch N)")
    run_worker(args.process_id, args.num_processes, args.coordinator, device,
               args.ckpt_dir or tempfile.mkdtemp(prefix="mp_ckpt_"))


if __name__ == "__main__":
    main()
