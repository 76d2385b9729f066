"""Population training: K independent PPO learners, with population-based
training (PBT) between iterations.

Counterpart of ``aerial_gym_simulator_tpu/rl/population.py``. Each member is
a ``PPOTrainer`` built exactly as a standalone trainer with seed
``cfg.seed + i``: its own task and env batch, network, Adam (with its own
learning-rate tensor), normalizer, generator and env carry. One iteration
runs ``train_iteration`` on every member in turn, so member i reproduces a
standalone run with its seed bit for bit.

The JAX package vmaps the members into one compiled program. That is a
compilation choice of the TPU build; its contract is the per-member
equality above, which batching members here would break: each member draws
from its own generators, and stacking the K env batches into one would
merge their streams. Batching the members is later work for the captured
step (ROADMAP.md §A2).

Use cases: seed sweeps for variance bars in one run, learning-rate
populations (per-member initial lr; the adaptive-KL schedule then moves
each member's on its own), PBT (Jaderberg et al. 2017, arXiv:1711.09846),
and pick-best-and-deploy (any member saves as a standard checkpoint).

Over several processes (``shard``), the members are dealt out over the
ranks: rank r of a world of W = P x E trains the members of population row
r // E, each whole (E = 1, no collective at all) or with its env batch
sharded over the E ranks of its row (``env_devices`` = E). Every member keeps
its own generators, so it is the same member as in the unsharded run. PBT
decides on the reward vector all-reduced from the rows; a winner's learner
goes to the loser's rank by a broadcast from the winner's row.

``python -m aerial_gym_simulator_tpu_torch.rl.population`` is the command
line (``main``; on CUDA unless ``--cpu``).
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..parallel import mesh as meshlib
from .ppo import PPOConfig, PPOTrainer, init_multi_device, log_to_stdout

logger = logging.getLogger("population")


def _same_params(a, b) -> bool:
    """Two task-parameter records equal leaf by leaf: tensors by
    torch.equal, arrays by np.array_equal, everything else by ==."""
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b))
    if dataclasses.is_dataclass(a):
        return (type(a) is type(b)
                and all(_same_params(getattr(a, f.name), getattr(b, f.name))
                        for f in dataclasses.fields(a)))
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(_same_params(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return (isinstance(b, (list, tuple)) and len(a) == len(b)
                and all(_same_params(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    return a == b


class PopulationTrainer:
    """K PPO members trained in turn.

    task_factory(seed) must build a fresh task instance (e.g. ``lambda s:
    port.task_registry.make_task(name, num_envs=N, seed=s)``). member_lrs:
    per-member initial learning rates (needs cfg.lr_schedule ==
    "adaptive", where the lr is state that PBT may perturb)."""

    def __init__(self, task_factory: Callable[..., object], cfg: PPOConfig, num_seeds: int,
                 seeds: Optional[Sequence[int]] = None,
                 member_lrs: Optional[Sequence[float]] = None, build: bool = True):
        """``build=False`` defers the members to ``shard``, which builds only
        this rank's (at their env blocks with ``env_devices`` > 1, where
        ``task_factory(seed, shard)`` builds a task at an EnvShard); a world
        of one then builds them all."""
        self.cfg = cfg
        self.seeds = (list(seeds) if seeds is not None
                      else [cfg.seed + i for i in range(num_seeds)])
        if len(self.seeds) != num_seeds:
            raise ValueError("len(seeds) != num_seeds")
        if member_lrs is not None:
            if cfg.lr_schedule != "adaptive":
                raise ValueError(
                    "member_lrs needs lr_schedule='adaptive' (a per-member lr is state the "
                    "schedule and PBT move; a 'fixed' lr is the config's)")
            if len(member_lrs) != num_seeds:
                raise ValueError("len(member_lrs) != num_seeds")
        self.num_seeds = num_seeds
        self.task_factory, self.member_lrs = task_factory, member_lrs
        self.members = [None] * num_seeds
        self.last_metrics = None
        self.local = list(range(num_seeds))   # the members this process trains
        self.layout = None                     # set by shard()
        if build:
            self._build(self.local)

    def _build(self, local, shard=None):
        """Build members ``local`` (at ``shard``'s block when given)."""
        for i in local:
            s = self.seeds[i]
            task = self.task_factory(s) if shard is None else self.task_factory(s, shard)
            m = PPOTrainer(task, dataclasses.replace(self.cfg, seed=s))
            if self.member_lrs is not None:
                m.lr.fill_(float(self.member_lrs[i]))
            self.members[i] = m
        m0 = self.members[local[0]]
        self.task, self.network = m0.task, m0.network
        # the members' tasks must share their parameters: seeds randomize
        # state, parameters come from the config (as in the JAX package,
        # whose members run member 0's compiled step)
        p0 = getattr(m0.task, "params", None)
        if p0 is not None:
            for i in local[1:]:
                if not _same_params(p0, getattr(self.members[i].task, "params", None)):
                    raise ValueError(
                        f"task_factory({self.seeds[i]}) built different SimParams than "
                        f"task_factory({self.seeds[local[0]]}): the population shares one "
                        f"step function, so task params must be seed-independent "
                        f"(seed-dependent randomization belongs in the state/reset path)")

    def shard(self, n_devices: Optional[int] = None, env_devices: int = 1):
        """Deal the members out over the mesh of ``n_devices`` ranks (all by
        default), laid out as (population rows) x ``env_devices``: this rank
        trains the members of its row; with ``env_devices`` > 1 each such
        member's env batch is sharded over its row's ranks (a ``new_group``
        each). A population built with ``build=False`` builds only those
        members, each at its env block; one built whole drops the others and
        cuts the kept ones. Every rank must call it. -> the mesh."""
        mesh = meshlib.make_mesh(n_devices)
        n_devices = mesh.size
        if n_devices % env_devices:
            raise ValueError(f"n_devices {n_devices} must be a multiple of env_devices "
                             f"{env_devices}")
        pop_devices = n_devices // env_devices
        if self.num_seeds % pop_devices:
            raise ValueError(f"num_seeds {self.num_seeds} must be a multiple of the population "
                             f"mesh axis {pop_devices}")
        if self.cfg.num_envs % env_devices:
            raise ValueError(f"num_envs {self.cfg.num_envs} must be a multiple of env_devices "
                             f"{env_devices}")
        index = mesh.index()
        built = self.members[0] is not None or self.layout is not None
        if index is None or n_devices == 1:
            if not built:
                self._build(self.local)
            return mesh
        rows = [mesh.ranks[r * env_devices:(r + 1) * env_devices] for r in range(pop_devices)]
        groups = [meshlib._dist().new_group(list(ranks)) if env_devices > 1 else None
                  for ranks in rows]              # every rank creates every group
        row, col = divmod(index, env_devices)
        per_row = self.num_seeds // pop_devices
        self.local = list(range(row * per_row, (row + 1) * per_row))
        shard = None
        if env_devices > 1:
            offset, n = meshlib.block(self.cfg.num_envs, col, env_devices)
            shard = meshlib.EnvShard(col, env_devices, offset, n, self.cfg.num_envs,
                                     groups[row], rows[row][0])
        if not built:
            self._build(self.local, shard)
        else:
            for i in range(self.num_seeds):
                if i not in self.local:
                    self.members[i].task.close()
                    self.members[i] = None
            if shard is not None:
                from ..parallel.distributed import shard_ppo_trainer
                for i in self.local:
                    shard_ppo_trainer(self.members[i], shard)
        self.layout = {"mesh": mesh, "rows": rows, "row": row, "col": col,
                       "per_row": per_row}
        m0 = self.members[self.local[0]]
        self.task, self.network = m0.task, m0.network
        if meshlib.is_root():
            logger.info("population over %d processes (%d pop x %d env; %d members per row)",
                        n_devices, pop_devices, env_devices, per_row)
        return mesh

    def _owner_root(self, i: int) -> int:
        """The global rank of the first process of member i's row."""
        lay = self.layout
        return lay["rows"][i // lay["per_row"]][0]

    def _learner_tensors(self, m: PPOTrainer):
        """A member's learner as a list of tensors: parameters, Adam's state
        (a fresh Adam's zeros where it has not stepped), lr, normalizer."""
        adam = m._adam_state()
        return (list(m.network.parameters())
                + [adam[i][k] for i in sorted(adam) for k in ("step", "exp_avg", "exp_avg_sq")]
                + [m.lr] + [m.norm[k] for k in sorted(m.norm)])

    def _broadcast_learner(self, src: int, dst: int):
        """Member src's learner to member dst across processes: a broadcast
        from src's row over the mesh, written into dst's tensors on the
        ranks that hold dst."""
        template = self.members[src] if src in self.local else self.members[self.local[0]]
        bufs = [t.detach().clone() if src in self.local else torch.zeros_like(t)
                for t in self._learner_tensors(template)]
        meshlib.broadcast_(bufs, (self._owner_root(src), self.layout["mesh"].group))
        if dst not in self.local:
            return
        l = self.members[dst]
        params = list(l.network.parameters())
        with torch.no_grad():
            for p, b in zip(params, bufs):
                p.copy_(b)
            k = len(params)
            for i, p in enumerate(params):
                step, m1, m2 = bufs[k + 3 * i:k + 3 * i + 3]
                l.optimizer.state[p] = {"step": step, "exp_avg": m1, "exp_avg_sq": m2}
            k += 3 * len(params)
            l.lr.copy_(bufs[k])
        l.norm = dict(zip(sorted(l.norm), bufs[k + 1:]))

    def _copy_learner(self, src: int, dst: int):
        """Member dst takes a copy of member src's network parameters, Adam
        state, learning rate and normalizer, written into dst's own tensors
        (no tensor is shared afterwards); its env carry and generators stay.
        When another process holds src, it comes by broadcast."""
        if self.layout is not None and not (src in self.local and dst in self.local):
            self._broadcast_learner(src, dst)
            return
        w, l = self.members[src], self.members[dst]
        with torch.no_grad():
            for pw, pl in zip(w.network.parameters(), l.network.parameters()):
                pl.copy_(pw)
                st = w.optimizer.state.get(pw)
                if st:
                    l.optimizer.state[pl] = {k: v.clone() for k, v in st.items()}
                else:
                    l.optimizer.state.pop(pl, None)
            l.lr.copy_(w.lr)
        l.norm = {k: v.clone() for k, v in w.norm.items()}

    def _pbt_step(self, rewards: np.ndarray, rng: np.random.Generator,
                  fraction: float = 0.25, lr_perturb: Sequence[float] = (0.8, 1.25)):
        """One PBT step: each bottom-``fraction`` member copies the learner
        state of a random top-``fraction`` member (exploit), then multiplies
        its learning rate by a factor drawn from ``lr_perturb``, clipped to
        [min_lr, max_lr] (explore). -> [(dst, src, factor)]."""
        if self.cfg.lr_schedule != "adaptive":
            raise ValueError(
                "PBT needs lr_schedule='adaptive': with 'fixed' the lr is the config's and "
                "the explore step cannot perturb it")
        if not 0.0 < fraction <= 0.5:
            raise ValueError(f"pbt fraction must be in (0, 0.5] so winners and losers cannot "
                             f"overlap (got {fraction})")
        K = self.num_seeds
        q = min(max(int(round(K * fraction)), 1), K // 2)
        if q < 1:
            raise ValueError(f"population of {K} is too small for PBT")
        order = np.argsort(rewards)           # ascending
        losers, winners = order[:q], order[K - q:]
        events = []
        for dst in losers:
            src, dst = int(rng.choice(winners)), int(dst)
            self._copy_learner(src, dst)
            factor = float(rng.choice(lr_perturb))
            if dst in self.local:
                lr = self.members[dst].lr
                lr.copy_(torch.clamp(lr * factor, self.cfg.min_lr, self.cfg.max_lr))
            events.append((dst, src, factor))
        return events

    def train(self, total_env_steps: Optional[int] = None, log_every: int = 10,
              pbt_every: int = 0, pbt_fraction: float = 0.25):
        """Run ``total_env_steps // (num_envs * horizon)`` iterations of every
        member (at least one) -> history, one dict per log point with each
        metric a (K,) array. ``pbt_every`` > 0 runs a PBT step after every
        ``pbt_every`` iterations but the last. ``env_steps_per_s`` is the
        population's aggregate rate from the end of the first iteration."""
        cfg = self.cfg
        if self.members[self.local[0]] is None:               # build=False, never sharded
            self._build(self.local)
        steps_per_iter = cfg.num_envs * cfg.horizon           # per member
        iters = max((total_env_steps or cfg.total_env_steps) // steps_per_iter, 1)
        history, pbt_rng = [], np.random.default_rng(cfg.seed)
        t_start, t_steady, steps_steady = time.perf_counter(), None, 0
        root = meshlib.is_root()
        for it in range(iters):
            each = {i: self.members[i].train_iteration() for i in self.local}
            stacked, names = self._stack_metrics(each)
            if t_steady is None:
                if self.task.device.type == "cuda":
                    torch.cuda.synchronize(self.task.device)
                t_steady, steps_steady = time.perf_counter(), (it + 1) * steps_per_iter
            if pbt_every and (it + 1) % pbt_every == 0 and it != iters - 1:
                rewards = stacked[names.index("reward_mean")].cpu().numpy()
                for dst, src, f in self._pbt_step(rewards, pbt_rng, pbt_fraction):
                    if root:
                        logger.info("pbt it %d: member %d (reward %.3f) <- member %d (reward "
                                    "%.3f), lr x%s", it, dst, rewards[dst], src, rewards[src],
                                    f)
            if it % log_every == 0 or it == iters - 1:
                m = dict(zip(names, stacked.cpu().numpy()))                # one read-back
                now = time.perf_counter()
                m.update(iter=it, env_steps=(it + 1) * steps_per_iter, wall_s=now - t_start)
                dt, dsteps = now - t_steady, m["env_steps"] - steps_steady
                sps = dsteps / dt if dsteps > 0 and dt > 0 else m["env_steps"] / m["wall_s"]
                m["env_steps_per_s"] = self.num_seeds * sps
                history.append(m)
                r = m["reward_mean"]
                if root:
                    logger.info("it %4d steps/member %.2e reward best %7.3f / mean %7.3f / worst "
                            "%7.3f sps(all) %.0f", it, m["env_steps"], r.max(), r.mean(),
                                r.min(), m["env_steps_per_s"])
        for i in self.local:
            m = self.members[i]
            if hasattr(m.task, "set_carry"):
                m.task.set_carry(m.env_carry[0] if cfg.rnn else m.env_carry)
        self.last_metrics = history[-1] if history else None
        return history

    def _stack_metrics(self, each):
        """{member: metrics} -> ((n_metrics, K) tensor, names). Sharded,
        the rows' first ranks write their members' columns into a zero
        buffer that is all-reduced over the mesh, so every rank holds all K."""
        names = sorted(next(iter(each.values())))
        if self.layout is None:
            return torch.stack([torch.stack([each[i][k].float() for i in self.local])
                                for k in names]), names
        dev = self.task.device
        out = torch.zeros((len(names), self.num_seeds), device=dev)
        if self.layout["col"] == 0:
            for i in self.local:
                out[:, i] = torch.stack([each[i][k].float() for k in names])
        meshlib.all_reduce_(out, self.layout["mesh"])
        return out, names

    def best_member(self, metric: str = "reward_mean") -> int:
        if self.last_metrics is None:
            raise RuntimeError("train() first")
        return int(np.argmax(self.last_metrics[metric]))

    def member_checkpoint(self, i: int, path: str):
        """Save member i as a standard PPOTrainer checkpoint (its own seed
        in the config): ``PPOTrainer.load_checkpoint`` and
        ``sim2real.policy.export_policy_npz`` read it. Sharded, the first
        rank of member i's row writes it; the others return."""
        if self.layout is not None and not (i in self.local and self.layout["col"] == 0):
            return
        self.members[i].save_checkpoint(path)
        logger.info("member %d (seed %d) saved to %s", i, self.seeds[i], path)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m aerial_gym_simulator_tpu_torch.rl.population",
        description="Train a population of PPO policies, optionally with PBT (on CUDA "
                    "unless --cpu).")
    p.add_argument("--task", default="position_setpoint_task")
    p.add_argument("--num_envs", type=int, default=1024, help="envs per member")
    p.add_argument("--num_seeds", type=int, default=8)
    p.add_argument("--total_steps", type=int, default=2_000_000, help="env steps per member")
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--seed", type=int, default=42,
                   help="first member seed (members use seed..seed+K-1)")
    p.add_argument("--lr_sweep", type=float, nargs=2, default=None, metavar=("LO", "HI"),
                   help="log-spaced per-member initial learning rates")
    p.add_argument("--multichip", action="store_true",
                   help="deal the members out over every process of the world torchrun set "
                        "up (torchrun --nproc_per_node=N -m ... --multichip); a world of one "
                        "without torchrun")
    p.add_argument("--env_devices", type=int, default=1,
                   help="with --multichip: each member's env batch over this many processes")
    p.add_argument("--save_best", default=None, help="write the best member's checkpoint here")
    p.add_argument("--pbt_every", type=int, default=0,
                   help="population-based training: exploit/explore every N iterations "
                        "(0 = plain population)")
    p.add_argument("--pbt_fraction", type=float, default=0.25)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The command line -> arguments; ``--env_devices`` above 1 without
    ``--multichip`` is a parser error."""
    p = _parser()
    args = p.parse_args(argv)
    if args.env_devices > 1 and not args.multichip:
        p.error("--env_devices needs --multichip")
    return args


def main(argv=None):
    """``python -m aerial_gym_simulator_tpu_torch.rl.population [flags]``:
    train the population, print the best member and every member's reward,
    optionally save the best -> the trainer."""
    args = parse_args(argv)
    log_to_stdout()
    args.multihost = False
    multi = init_multi_device(args)
    from ..registry.registries import task_registry
    cfg = PPOConfig(num_envs=args.num_envs, horizon=args.horizon,
                    minibatch_size=min(8192, args.num_envs * args.horizon),
                    total_env_steps=args.total_steps, seed=args.seed)
    lrs = None
    if args.lr_sweep:
        lrs = list(np.geomspace(args.lr_sweep[0], args.lr_sweep[1],
                                args.num_seeds).astype(np.float32))
        logger.info("lr population: %s", lrs)
    device = "cpu" if args.cpu else None
    pop = PopulationTrainer(
        lambda s, shard=None: task_registry.make_task(args.task, num_envs=args.num_envs,
                                                      seed=s, device=device, shard=shard),
        cfg, num_seeds=args.num_seeds, member_lrs=lrs, build=not multi)
    if multi:
        pop.shard(env_devices=args.env_devices)     # builds this rank's members alone
    pop.train(pbt_every=args.pbt_every, pbt_fraction=args.pbt_fraction)
    best = pop.best_member()
    r = pop.last_metrics["reward_mean"]
    if args.save_best:
        pop.member_checkpoint(best, args.save_best)
    if not meshlib.is_root():
        return pop
    print(f"best member: {best} (seed {pop.seeds[best]}) reward {r[best]:.3f}; population "
          f"rewards: {np.array2string(r, precision=3)}")
    return pop


if __name__ == "__main__":
    main()
