"""The env axis over processes: one process per device, each holding a block.

Counterpart of ``aerial_gym_simulator_tpu/parallel/mesh.py``. The JAX
package lays one array over a device mesh inside one program and lets XLA
insert the collectives. The torch idiom is one process per device, joined
in a ``torch.distributed`` process group:

  * the mesh is a process group (the default one, or a ``new_group`` of its
    first n ranks) with one axis, ``env``;
  * each rank holds a contiguous block ``[offset, offset + n_local)`` of
    the env axis of every env-batched tensor (state, observations,
    rollouts, the scene's per-env tables);
  * the learner (network, Adam, normalizer) is replicated: the same on
    every rank, broadcast from the group's first rank;
  * generators and scalars (``NavState.curriculum_level``) are replicated,
    never sliced; each generator knows its shard (``utils/env_rng``), so a
    rank draws exactly the rows the unsharded run draws for its envs.

Only ``all_reduce`` and ``broadcast`` are used: they are the two
collectives gloo runs on CUDA tensors (the backend the card's machine needs
when several ranks share one card), and NCCL runs every one.
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ..utils.env_rng import set_shard

ENV_AXIS = "env"


def _dist():
    import torch.distributed as dist
    return dist


def world_initialized() -> bool:
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def global_rank() -> int:
    return _dist().get_rank() if world_initialized() else 0


def is_root() -> bool:
    """True on the process that logs, writes metrics and saves: global rank
    0, or the only process."""
    return global_rank() == 0


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the global ranks in mesh order and their process group
    (None: the default group, or no group at all in a world of one)."""
    ranks: Tuple[int, ...]
    group: Any = None

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def root(self) -> int:
        """The global rank broadcasts come from."""
        return self.ranks[0]

    def index(self) -> Optional[int]:
        """This process's position in the mesh, or None outside it."""
        r = global_rank()
        return self.ranks.index(r) if r in self.ranks else None


@dataclass(frozen=True)
class EnvShard:
    """This rank's block of an env axis of ``n_global`` envs over a group of
    ``world`` ranks: rows ``[offset, offset + n_local)``. ``rank`` is the
    position in the group, ``root`` the global rank of its first member."""
    rank: int
    world: int
    offset: int
    n_local: int
    n_global: int
    group: Any = None
    root: int = 0


def make_mesh(n_devices: Optional[int] = None) -> Mesh:
    """The default group's ranks, or a ``new_group`` of its first
    ``n_devices`` (every rank must call it, as ``new_group`` requires). A
    process outside any world is a mesh of one."""
    if not world_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"a mesh of {n_devices} devices needs a process group of that "
                             f"many ranks (parallel/distributed.initialize_multihost)")
        return Mesh((0,))
    dist = _dist()
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return Mesh(tuple(range(world)))
    if not 0 < n_devices <= world:
        raise ValueError(f"n_devices {n_devices} outside the world of {world}")
    ranks = tuple(range(n_devices))
    return Mesh(ranks, dist.new_group(list(ranks)))


def block(n_global: int, rank: int, world: int) -> Tuple[int, int]:
    """(offset, n_local) of ``rank``'s block; the env count must divide."""
    if n_global % world:
        raise ValueError(f"num_envs {n_global} must be a multiple of the {world} devices "
                         f"of the env axis")
    n = n_global // world
    return rank * n, n


def env_sharding(mesh: Mesh, num_envs: int) -> Optional[EnvShard]:
    """This process's block of a ``num_envs`` env axis over ``mesh`` (None
    when the process is outside the mesh)."""
    i = mesh.index()
    offset, n = block(num_envs, 0 if i is None else i, mesh.size)
    if i is None:
        return None
    return EnvShard(i, mesh.size, offset, n, num_envs, mesh.group, mesh.root)


def replicated(mesh: Mesh) -> Tuple[int, Any]:
    """Where a replicated value comes from: (global root rank, group)."""
    return mesh.root, mesh.group


# -- trees ---------------------------------------------------------------------


def map_tree(tree, fn):
    """fn applied to every tensor of a tree of dataclass records, tuples,
    lists and dicts; generators and Python values stay as they are."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{f.name: map_tree(getattr(tree, f.name), fn)
                                            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_tree(x, fn) for x in tree)
    if isinstance(tree, dict):
        return {k: map_tree(v, fn) for k, v in tree.items()}
    return tree


def tree_items(tree, kind) -> list:
    """Every leaf of type ``kind`` in a tree, in field order."""
    if isinstance(tree, kind):
        return [tree]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in tree_items(v, kind)]
    return []


def _leading_env_dim(tree) -> Optional[int]:
    dims = Counter(t.shape[0] for t in tree_items(tree, torch.Tensor) if t.dim() >= 1)
    return dims.most_common(1)[0][0] if dims else None


def shard_env_pytree(tree, shard: EnvShard, num_envs: Optional[int] = None):
    """This rank's block of every tensor whose leading dim is ``num_envs``
    (the most common leading dim when not given, JAX's rule); every other
    leaf, generators included, is kept whole."""
    n = _leading_env_dim(tree) if num_envs is None else num_envs
    if n is None:
        return tree
    if n != shard.n_global:
        raise ValueError(f"env axis of {n} envs, the shard is of {shard.n_global}")
    keep = lambda t: (t.narrow(0, shard.offset, shard.n_local).clone()
                      if t.dim() >= 1 and t.shape[0] == n else t)
    return map_tree(tree, keep)


def all_reduce_(x: torch.Tensor, shard) -> torch.Tensor:
    """Sum ``x`` in place over the shard's group (bool as uint8)."""
    if x.dtype == torch.bool:
        y = x.to(torch.uint8)
        _dist().all_reduce(y, group=shard.group)
        x.copy_(y.to(torch.bool))
    else:
        _dist().all_reduce(x, group=shard.group)
    return x


def barrier(shard, device) -> None:
    """Wait, on the host, for every rank of the shard's group: an all-reduce
    (so that it runs on the group's own backend and device) whose result is
    read back. NCCL only enqueues the collective on the device, so without
    the read a rank runs on before the others arrive (a file one rank
    writes before the barrier is then not there yet for the others)."""
    token = torch.zeros(1, device=device)
    _dist().all_reduce(token, group=shard.group)
    token.item()


def gather_env_pytree(tree, shard: EnvShard):
    """The inverse of ``shard_env_pytree`` on every rank: each env-batched
    tensor (leading dim n_local) whole again, in env order. Collective: a
    zero-padded buffer all-reduced."""

    def whole(t):
        if t.dim() == 0:
            return t
        if t.shape[0] != shard.n_local:
            raise ValueError(f"a {tuple(t.shape)} leaf in an env tree of {shard.n_local} envs")
        out = torch.zeros((shard.n_global,) + tuple(t.shape[1:]), dtype=t.dtype,
                          device=t.device)
        out.narrow(0, shard.offset, shard.n_local).copy_(t)
        return all_reduce_(out, shard)

    return map_tree(tree, whole)


def broadcast_(tensors, src) -> None:
    """Overwrite each tensor in place with the root's copy. ``src`` is a
    Mesh, an EnvShard, or a (root, group) pair from ``replicated``."""
    root, group = (src if isinstance(src, tuple) else (src.root, src.group))
    dist = _dist()
    for t in tensors:
        dist.broadcast(t.data if isinstance(t, torch.nn.Parameter) else t, src=root,
                       group=group)


def replicate_pytree(tree, src):
    """Every tensor of ``tree`` overwritten in place by the root's (a
    broadcast); -> the tree."""
    broadcast_(tree_items(tree, torch.Tensor), src)
    return tree


def register_generators(tree, shard: Optional[EnvShard]) -> None:
    """Tell every generator of ``tree`` which rows this rank draws."""
    for g in tree_items(tree, torch.Generator):
        set_shard(g, shard)


# -- tasks -----------------------------------------------------------------------


def shard_params_(params, shard: EnvShard) -> None:
    """Slice a SimParams record's per-env tables in place (its scene's
    ``env_*`` tables and ``cull_rank``, and ``env.num_envs``): every step
    function of the task holds this record, so it sees the block."""
    sc = params.scene
    if sc is not None and sc.env_asset_variant.shape[0] == shard.n_global:
        params.scene = dataclasses.replace(sc, **{
            f.name: getattr(sc, f.name).narrow(0, shard.offset, shard.n_local).clone()
            for f in dataclasses.fields(sc)
            if f.name.startswith("env_") or f.name == "cull_rank"})
    params.env = dataclasses.replace(params.env, num_envs=shard.n_local)


def _shard_attributes(obj, shard: EnvShard, skip=()) -> None:
    """Slice an object's env-batched attributes in place: tensors with
    leading dim n_global, records and dicts holding them; ``num_envs``."""
    for name, value in list(vars(obj).items()):
        if name in skip:
            continue
        if isinstance(value, torch.Tensor):
            if value.dim() >= 1 and value.shape[0] == shard.n_global:
                setattr(obj, name, value.narrow(0, shard.offset, shard.n_local).clone())
        elif isinstance(value, dict) or (dataclasses.is_dataclass(value)
                                         and not isinstance(value, type)):
            if any(t.dim() >= 1 and t.shape[0] == shard.n_global
                   for t in tree_items(value, torch.Tensor)):
                setattr(obj, name, shard_env_pytree(value, shard, shard.n_global))
    if getattr(obj, "num_envs", None) == shard.n_global:
        obj.num_envs = shard.n_local


def shard_task(task, shard: EnvShard) -> None:
    """Cut a task built at the global env count down to this rank's block,
    in place: its SimParams' per-env tables, its env-batched attributes
    (targets, observations, its state records) and its env manager's, and
    the generators those hold told of the shard. A task built at its block
    (``make_task(..., shard=)``) is left as it is."""
    if getattr(task, "shard", None) == shard:
        return
    sim_env = getattr(task, "sim_env", None)
    seen = set()
    for owner in (task, sim_env):
        params = getattr(owner, "params", None)
        if params is not None and id(params) not in seen:
            seen.add(id(params))
            shard_params_(params, shard)
    skip = ("params", "sim_env", "vae", "task_config")
    _shard_attributes(task, shard, skip)
    if sim_env is not None:
        _shard_attributes(sim_env, shard, skip)
        register_generators(sim_env.state, shard)
    for name, value in vars(task).items():
        if name not in skip:
            register_generators(value, shard)
    for owner in (task, sim_env):
        if owner is not None:
            owner.shard = shard
