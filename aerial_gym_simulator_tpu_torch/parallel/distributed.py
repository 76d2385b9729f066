"""Multi-process initialization and the one-call sharding of the trainers.

Counterpart of ``aerial_gym_simulator_tpu/parallel/distributed.py``. Call
``initialize_multihost`` once at process start in every process (torchrun
sets the variables it reads); afterwards ``shard_trainer`` /
``shard_bptt_trainer`` cut a trainer built at the global env count down to
this rank's block of the env axis and replicate its learner from the first
rank. The trainers then make every reduction over the env axis global
(``rl/ppo.py``, ``rl/bptt.py``): a W-rank run equals the one-rank run up to
the order of float sums.

The backend is chosen by rule, never by trial: NCCL when each rank owns its
own GPU, gloo on the CPU and when several ranks share one card (NCCL refuses
two ranks on one device). The port's collectives are ``all_reduce`` and
``broadcast`` only, the two gloo runs on CUDA tensors.
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from ..utils.env_rng import set_shard
from . import mesh as meshlib

logger = logging.getLogger("distributed")


def default_backend(device_type: str, ranks_per_device: int = 1) -> str:
    """NCCL for one rank per GPU, gloo on the CPU or for ranks sharing a
    GPU."""
    return "nccl" if device_type == "cuda" and ranks_per_device == 1 else "gloo"


def _env_int(name: str, default=None):
    value = os.environ.get(name)
    return default if value in (None, "") else int(value)


def initialize_multihost(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, require: bool = False,
                         backend: Optional[str] = None) -> bool:
    """``torch.distributed.init_process_group`` from explicit arguments or
    torchrun's environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``) -> whether a process group is up.

    ``coordinator_address`` is ``host:port``. With no coordinator configured
    and ``require=False`` the process logs and stays single-process, JAX's
    rule; ``require=True`` without one raises, and any failure while a
    coordinator is configured re-raises: a pod launch silently degraded to
    N lone runs is worse than a crash. ``backend`` None: NCCL when CUDA is
    available and the host's ranks do not outnumber its GPUs, else gloo
    (``default_backend``). With CUDA each rank takes GPU ``LOCAL_RANK``
    modulo the GPU count."""
    dist = meshlib._dist()
    if dist.is_initialized():
        return True
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        port = os.environ.get("MASTER_PORT", "29500")
        coordinator_address = f"{os.environ['MASTER_ADDR']}:{port}"
    if coordinator_address is None:
        if require:
            raise RuntimeError("initialize_multihost(require=True): no coordinator configured "
                               "(pass coordinator_address or launch with torchrun)")
        logger.info("no coordinator configured: single process")
        return False
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise RuntimeError(f"coordinator {coordinator_address} configured without the world "
                           f"size and this process's rank (WORLD_SIZE / RANK)")
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    cuda = torch.cuda.is_available()
    if backend is None:
        gpus = torch.cuda.device_count() if cuda else 0
        per_device = -(-local_world // gpus) if gpus else local_world
        backend = default_backend("cuda" if cuda else "cpu", per_device)
    if cuda:
        torch.cuda.set_device(_env_int("LOCAL_RANK", rank) % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=world, rank=rank)
    logger.info("process group up: rank %d of %d, backend %s", rank, world, backend)
    return True


def _broadcast_learner(module: torch.nn.Module, optimizer, src) -> None:
    """The network, Adam's state and the lr tensor from the root."""
    meshlib.broadcast_(list(module.parameters()) + list(module.buffers()), src)
    state = [t for st in optimizer.state.values() for t in st.values()
             if isinstance(t, torch.Tensor)]
    lrs = [g["lr"] for g in optimizer.param_groups if isinstance(g["lr"], torch.Tensor)]
    meshlib.broadcast_(state + lrs, src)


def shard_ppo_trainer(trainer, shard: meshlib.EnvShard) -> None:
    """Place one PPOTrainer on ``shard``: its task, env carry and
    observation cut to the block, every generator told of it, the learner
    and normalizer broadcast from the shard's root."""
    n = trainer.cfg.num_envs
    if shard.n_global != n:
        raise ValueError(f"shard of {shard.n_global} envs for a trainer of {n}")
    meshlib.shard_task(trainer.task, shard)
    trainer.env_carry = meshlib.shard_env_pytree(trainer.env_carry, shard, n)
    trainer.obs = meshlib.shard_env_pytree(trainer.obs, shard, n)
    meshlib.register_generators(trainer.env_carry, shard)
    set_shard(trainer.generator, shard)
    if hasattr(trainer.task, "set_carry"):
        trainer.task.set_carry(trainer.env_carry[0] if trainer.cfg.rnn else trainer.env_carry)
    _broadcast_learner(trainer.network, trainer.optimizer, shard)
    meshlib.replicate_pytree(trainer.norm, shard)
    trainer.shard = shard


def shard_trainer(trainer, n_devices: Optional[int] = None) -> meshlib.Mesh:
    """Shard a PPOTrainer's env axis over the mesh of ``n_devices`` ranks
    (all of them by default) and replicate its learner: the one-call
    scale-out for ``rl/ppo.py``. In a world of one the trainer is left as it
    is, so it gives exactly the unsharded numbers."""
    m = meshlib.make_mesh(n_devices)
    shard = meshlib.env_sharding(m, trainer.cfg.num_envs)
    if m.size > 1 and shard is not None:
        shard_ppo_trainer(trainer, shard)
    if meshlib.is_root():
        logger.info("trainer over %d process(es) (env axis): %s envs each", m.size,
                    trainer.cfg.num_envs // m.size)
    return m


def shard_bptt_trainer(trainer, n_devices: Optional[int] = None) -> meshlib.Mesh:
    """The same for the first-order trainer (``rl/bptt.py``): env carry and
    observation sharded, policy and Adam replicated; its window losses are
    global means and its gradients all-reduced."""
    m = meshlib.make_mesh(n_devices)
    n = trainer.cfg.num_envs
    shard = meshlib.env_sharding(m, n)
    if m.size > 1 and shard is not None:
        meshlib.shard_task(trainer.task, shard)
        trainer.carry = meshlib.shard_env_pytree(trainer.carry, shard, n)
        trainer.obs = meshlib.shard_env_pytree(trainer.obs, shard, n)
        meshlib.register_generators(trainer.carry, shard)
        if hasattr(trainer.task, "set_carry"):
            trainer.task.set_carry(trainer.carry)
        _broadcast_learner(trainer.policy, trainer.optimizer, shard)
        trainer.shard = shard
    if meshlib.is_root():
        logger.info("bptt trainer over %d process(es) (env axis)", m.size)
    return m
