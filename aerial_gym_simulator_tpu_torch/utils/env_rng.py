"""One draw rule for every shard of the env axis.

The JAX package draws each env's randomness from that env's own key, so
sharding the env axis changes the layout of a run and never its numbers.
The port draws every env-batched random tensor in one call of shape
``(N, ...)`` from one ``torch.Generator``. To keep JAX's property, every
rank of a sharded run holds the same generators (the same seed, advanced in
lockstep), each env-batched draw is made at the global env count, and a rank
keeps its own rows ``[offset, offset + n_local)``. A sharded rollout then
equals the unsharded one row for row, resets and action noise included.

The shard rides with the generator: ``set_shard(gen, shard)`` (done by
``parallel.mesh.register_generators`` when a trainer is sharded) tells every
draw from ``gen`` which block of the env axis this rank owns. A generator
without a shard makes exactly the call the port always made, so a world of
one is bit-equal to the unsharded port. The cost of the rule is W times the
random numbers on each of W ranks, small next to a step.

Draws that are not batched over envs (the VAE's reparameterisation and
``train_vae``'s batch sampler, the PPO minibatch permutation, which every
rank draws whole) stay plain calls.

``env_sums`` and ``env_count`` are the two cross-env reductions a task step
makes (the curriculum's outcome counts, the env-step counter): global over
the shard's process group, local without a shard.
"""

from __future__ import annotations

from typing import Sequence

import torch

# id(generator) -> (generator, shard). The entry holds the generator itself,
# so its id cannot be reused while the entry lives (a torch.Generator takes
# no attribute, and some builds refuse a weak reference to one).
_SHARDS: dict = {}


def set_shard(gen: torch.Generator, shard) -> None:
    """Draws from ``gen`` keep the rows of ``shard`` (an object with
    ``offset``, ``n_local``, ``n_global`` and ``group``); ``None`` clears it."""
    if shard is None:
        _SHARDS.pop(id(gen), None)
    else:
        _SHARDS[id(gen)] = (gen, shard)


def shard_of(gen):
    """The shard registered for ``gen``, or None."""
    entry = None if gen is None else _SHARDS.get(id(gen))
    return entry[1] if entry is not None and entry[0] is gen else None


def _draw(fn, gen, shape: Sequence[int], dim: int, kwargs):
    shard = shard_of(gen)
    if shard is None:
        return fn(tuple(shape), generator=gen, **kwargs)
    if shape[dim] != shard.n_local:
        raise ValueError(f"an env-batched draw of shape {tuple(shape)} (env axis {dim}) from a "
                         f"generator sharded to {shard.n_local} of {shard.n_global} envs")
    full = list(shape)
    full[dim] = shard.n_global
    out = fn(tuple(full), generator=gen, **kwargs).narrow(dim, shard.offset, shard.n_local)
    return out if dim == 0 else out.contiguous()


def env_rand(gen: torch.Generator, shape: Sequence[int], dim: int = 0, **kwargs):
    """``torch.rand(shape, generator=gen, **kwargs)`` whose axis ``dim`` is
    the env axis: drawn at the global env count when ``gen`` is sharded."""
    return _draw(torch.rand, gen, shape, dim, kwargs)


def env_randn(gen: torch.Generator, shape: Sequence[int], dim: int = 0, **kwargs):
    """``torch.randn`` under the same rule as ``env_rand``."""
    return _draw(torch.randn, gen, shape, dim, kwargs)


def env_sums(gen: torch.Generator, *xs: torch.Tensor):
    """The sums of ``xs`` over every env: one all-reduce over the shard's
    group when ``gen`` is sharded. -> a tuple of 0-d tensors."""
    shard = shard_of(gen)
    if shard is None:
        return tuple(x.sum() for x in xs)
    import torch.distributed as dist

    sums = torch.stack([x.sum() for x in xs])
    dist.all_reduce(sums, group=shard.group)
    return tuple(sums.unbind())


def env_count(gen: torch.Generator, n_local: int) -> int:
    """The global env count when ``gen`` is sharded, else ``n_local``."""
    shard = shard_of(gen)
    return n_local if shard is None else shard.n_global
