"""First-order policy optimization through the differentiable simulator.

Counterpart of ``aerial_gym_simulator_tpu/rl/bptt.py``. BPTT ("analytic
policy gradient") training: the policy is optimized by backpropagating
straight through the task's step (controller, motor lag, drag, 6-DoF
integration, reward) over short rollout windows, instead of PPO's
score-function gradient.

  * The objective must be smooth: the task's exp-shaped reward has
    vanishing gradients at distance, so training minimizes a quadratic
    surrogate (``default_cost``: squared position error plus action effort;
    override with ``cost_fn``) while the task reward is tracked.
  * Windows are truncated BPTT: each update backpropagates through
    ``horizon`` steps, and the next window continues from the final state,
    detached.
  * Deterministic BPTT oscillates late, so the trainer keeps the parameters
    that set the best EMA of the task reward and restores them at the end.

An update reads nothing back to the host: the EMA, the best EMA and the
best parameters are updated with ``torch.where`` on the device, the clip
by the global norm scales by a device value (optax's
``clip_by_global_norm``: g / norm * max_norm once the norm reaches
max_norm), and Adam takes optax's defaults (eps 1e-8). ``train`` reads
the metrics at its log points only.

``remat=True`` runs each step under ``torch.utils.checkpoint`` and
recomputes it in the backward. The checkpoint keeps only the global RNG
states, not the ``torch.Generator`` objects a task's carry holds (a
``SimState.rng`` draws the resets and the disturbances every step), so
each checkpointed step saves their states before it runs, replays its
recomputation from them, and puts back the state the recomputation found.

Sharded (``parallel/distributed.shard_bptt_trainer``), each rank holds a
block of the env axis and the same policy; the window's cost and task
reward are global means and the gradients are all-reduced before the clip,
so every rank takes the same step.

``python -m aerial_gym_simulator_tpu_torch.rl.bptt`` is the command line
(``main``; on CUDA unless ``--cpu``).
"""

from __future__ import annotations

import argparse
import logging
import math
import time
from dataclasses import dataclass
from typing import Callable, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .networks import _lecun_dense
from ..parallel import mesh as meshlib
from ..parallel.distributed import env_block, place_bptt_trainer
from .ppo import add_multi_device_flags, init_multi_device, log_to_stdout

logger = logging.getLogger("bptt")


@dataclass
class BPTTConfig:
    num_envs: int = 256
    horizon: int = 16          # truncated-BPTT window length
    lr: float = 2e-3
    max_grad_norm: float = 1.0
    iters: int = 1500
    hidden: Tuple[int, ...] = (64, 64)
    action_scale: float = 1.0  # tanh-bounded actions * scale
    act_reg: float = 0.01      # action-effort weight in the default cost
    ema: float = 0.98          # task-reward smoothing for the best-parameter pick
    seed: int = 0
    remat: bool = False        # checkpoint each step (recomputed in the backward)


class TanhPolicy(nn.Module):
    """ELU MLP of ``hidden`` widths (flax's lecun-normal kernels, zero
    biases), a last layer with orthogonal(0.5) weights and a zero bias,
    then ``scale * tanh``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Tuple[int, ...] = (64, 64),
                 scale: float = 1.0):
        super().__init__()
        widths = [obs_dim, *hidden]
        self.hidden = nn.ModuleList(_lecun_dense(a, b) for a, b in zip(widths[:-1], widths[1:]))
        self.head = nn.Linear(widths[-1], action_dim)
        nn.init.orthogonal_(self.head.weight, gain=0.5)
        nn.init.zeros_(self.head.bias)
        self.scale = scale

    def forward(self, x):
        for layer in self.hidden:
            x = F.elu(layer(x))
        return self.scale * torch.tanh(self.head(x))


def default_cost(obs, action, cfg: BPTTConfig):
    """Quadratic tracking surrogate for the position-setpoint family:
    obs[:, :3] is the world-frame position error target - pos. The squared
    norm is frame-invariant; a cost_fn that weights axes differently must
    rotate into the frame it wants."""
    return torch.sum(obs[:, :3] ** 2, dim=1) + cfg.act_reg * torch.sum(action ** 2, dim=1)


def detach_carry(carry):
    """The carry with every tensor detached from the graph; its generators
    are the same objects, so their streams go on."""
    return meshlib.map_tree(carry, torch.Tensor.detach)


def remat_step(step_fn):
    """step_fn run under torch.utils.checkpoint: its activations are
    recomputed in the backward instead of kept. The recomputation draws
    what the forward drew: the carry's generators are set to their states
    from before the forward while it runs, then put back as it found them."""

    def step(carry, action):
        gens = meshlib.tree_items(carry, torch.Generator)
        before = [g.get_state() for g in gens]
        calls = []

        def run(carry, action):
            if not calls:                       # the forward
                calls.append(True)
                return step_fn(carry, action)
            now = [g.get_state() for g in gens]
            for g, s in zip(gens, before):
                g.set_state(s)
            try:
                return step_fn(carry, action)
            finally:                            # also when the recomputation stops early
                for g, s in zip(gens, now):
                    g.set_state(s)

        return checkpoint(run, carry, action, use_reentrant=False, preserve_rng_state=False)

    return step


def clip_by_global_norm_(grads, max_norm: float):
    """optax.clip_by_global_norm in place, on the device: below max_norm the
    gradients stay, at or above it each becomes g / norm * max_norm."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


class BPTTTrainer:
    """The window update and the loop around it (rl/ppo.PPOTrainer's
    analog), on the task's device.

    cost_fn(obs_next, action) -> (N,) per-env cost; defaults to the
    quadratic position surrogate. The task reward is only monitored."""

    def __init__(self, task, cfg: BPTTConfig, cost_fn: Optional[Callable] = None):
        self.task, self.cfg = task, cfg
        self.device = task.device
        step_fn, self.carry, self.obs = task.make_step_fn()
        self.step_fn = remat_step(step_fn) if cfg.remat else step_fn
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            policy = TanhPolicy(self.obs.shape[-1], int(task.task_config.action_space_dim),
                                cfg.hidden, cfg.action_scale)
        self.policy = policy.to(self.device)
        self.cost = cost_fn or (lambda o, a: default_cost(o, a, cfg))
        how = {"fused": True} if self.device.type == "cuda" else {"foreach": False}
        self.optimizer = torch.optim.Adam(self.policy.parameters(), lr=cfg.lr, eps=1e-8, **how)
        self.best_ema = None
        self.shard = None           # this rank's block: the task's, or shard_bptt_trainer's
        if getattr(task, "shard", None) is not None:
            # a task built at this rank's block (make_task(..., shard=))
            place_bptt_trainer(self, task.shard)

    @property
    def params(self):
        return list(self.policy.parameters())

    def window(self):
        """``horizon`` steps under the policy from the current carry ->
        (mean cost, (final carry, final obs, mean task reward)); the
        trainer's state is not changed, the carry's generators advance."""
        carry, obs = self.carry, self.obs
        costs, rewards = [], []
        for _ in range(self.cfg.horizon):
            a = self.policy(obs)
            carry, obs, r, _, _ = self.step_fn(carry, a)
            costs.append(self.cost(obs, a))
            rewards.append(r)
        if self.shard is None:
            return torch.stack(costs).mean(), (carry, obs, torch.stack(rewards).mean())
        # this rank's share of the global means (update() all-reduces them)
        n = self.cfg.horizon * self.shard.n_global
        return torch.stack(costs).sum() / n, (carry, obs, torch.stack(rewards).sum() / n)

    def update(self, it: int, ema, best_ema, best_params):
        """One window and one Adam step. The EMA of the task reward is
        tracked on the device; when it beats ``best_ema`` the window's input
        parameters (the ones that earned it) are copied into
        ``best_params``. -> (ema, best_ema, surrogate, mean task reward)."""
        cfg = self.cfg
        loss, (carry, obs, rmean) = self.window()
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss, rmean = loss.detach(), rmean.detach()
        if self.shard is not None:
            loss, rmean = self._all_reduce_grads(torch.stack([loss, rmean]))
        ema = rmean if it == 0 else cfg.ema * ema + (1.0 - cfg.ema) * rmean
        better = ema > best_ema
        best_ema = torch.where(better, ema, best_ema)
        with torch.no_grad():
            for b, p in zip(best_params, self.params):
                b.copy_(torch.where(better, p, b))
            clip_by_global_norm_([p.grad for p in self.params], cfg.max_grad_norm)
        self.optimizer.step()
        self.carry, self.obs = detach_carry(carry), obs.detach()
        return ema, best_ema, loss, rmean

    def _all_reduce_grads(self, stats):
        """Sum the gradients and ``stats`` over the ranks in one flat
        all-reduce -> the global stats."""
        grads = [p.grad for p in self.params]
        flat = meshlib.all_reduce_(torch.cat([g.reshape(-1) for g in grads] + [stats]),
                                   self.shard)
        i = 0
        for p, g in zip(self.params, grads):
            p.grad = flat[i:i + g.numel()].view_as(g)
            i += g.numel()
        return flat[i:].unbind()

    def train(self, iters: Optional[int] = None, log_every: int = 100):
        """Run ``iters`` (default cfg.iters) updates -> history, one dict of
        floats per log point (iter, task_reward, task_reward_ema, surrogate,
        env_steps, wall_s). Ends with the best-EMA parameters restored and
        ``self.best_ema`` set."""
        cfg = self.cfg
        iters = iters or cfg.iters
        ema = torch.zeros((), device=self.device)
        best_ema = torch.full((), -math.inf, device=self.device)
        best_params = [p.detach().clone() for p in self.params]
        t0 = time.perf_counter()
        history = []
        for it in range(iters):
            ema, best_ema, loss, rmean = self.update(it, ema, best_ema, best_params)
            if it % log_every == 0 or it == iters - 1:
                r, e, s = torch.stack([rmean, ema, loss]).tolist()      # one read-back
                m = {"iter": it, "task_reward": r, "task_reward_ema": e, "surrogate": s,
                     "env_steps": (it + 1) * cfg.num_envs * cfg.horizon,
                     "wall_s": time.perf_counter() - t0}
                history.append(m)
                if meshlib.is_root():
                    logger.info("it %5d surrogate %.4f task reward %7.3f (ema %6.3f) steps %.2e",
                                it, s, r, e, m["env_steps"])
        with torch.no_grad():
            for p, b in zip(self.params, best_params):
                p.copy_(b)
        self.best_ema = float(best_ema)
        if meshlib.is_root():
            logger.info("best task-reward EMA %.3f; best-EMA parameters restored",
                        self.best_ema)
        return history

    @torch.no_grad()
    def act(self, obs):
        return self.policy(torch.as_tensor(obs, dtype=torch.float32, device=self.device))


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m aerial_gym_simulator_tpu_torch.rl.bptt",
        description="Train a tanh policy by BPTT through the simulator (on CUDA unless --cpu).")
    p.add_argument("--task", default="position_setpoint_task")
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--horizon", type=int, default=16)
    p.add_argument("--iters", type=int, default=1500)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--seed", type=int, default=0)
    add_multi_device_flags(p)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p


def parse_args(argv=None) -> argparse.Namespace:
    """The command line -> arguments."""
    return _parser().parse_args(argv)


def main(argv=None):
    """``python -m aerial_gym_simulator_tpu_torch.rl.bptt [flags]``: train,
    print the final task reward -> the trainer."""
    args = parse_args(argv)
    log_to_stdout()
    multi = init_multi_device(args)
    from ..registry.registries import task_registry
    task = task_registry.make_task(args.task, num_envs=args.num_envs, seed=args.seed,
                                   device="cpu" if args.cpu else None,
                                   shard=env_block(args.num_envs) if multi else None)
    cfg = BPTTConfig(num_envs=args.num_envs, horizon=args.horizon, iters=args.iters,
                     lr=args.lr, seed=args.seed)
    trainer = BPTTTrainer(task, cfg)        # on the task's block, if it has one
    hist = trainer.train()
    if not meshlib.is_root():
        return trainer
    print(f"final task reward {hist[-1]['task_reward']:.3f} "
          f"(ema {hist[-1]['task_reward_ema']:.3f}) after {hist[-1]['env_steps']:.2e} "
          f"env-steps, {hist[-1]['wall_s']:.1f}s wall")
    return trainer


if __name__ == "__main__":
    main()
