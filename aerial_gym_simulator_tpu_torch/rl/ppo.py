"""PPO learner: rollout and update on the task's device.

Counterpart of ``aerial_gym_simulator_tpu/rl/ppo.py``: clipped PPO,
GAE(lambda), advantage normalization per minibatch, entropy bonus, bounds
loss, value bootstrap at truncations, optional value normalization, and the
adaptive learning rate that follows the policy's KL divergence per
minibatch. Defaults follow the reference's ppo_aerial_quad.yaml (8192 envs,
horizon 32, minibatch 8192, gamma 0.99).

``rnn="gru"`` trains the recurrent ``ActorCriticGRU``: the env carry becomes
``(task_carry, hidden, done_prev)`` and the hidden state is zeroed at
episode boundaries; the update minibatches over envs (whole sequences) and
replays each from its stored rollout-start hidden with the current
parameters.

The rollout and the update run eagerly. Nothing in an iteration reads a
device value back to the host: the learning rate lives in a 0-d tensor that
``_adapt_lr`` moves with ``torch.where``, ``torch.optim.Adam`` takes it as a
tensor (the fused implementation on a GPU), the clip by the global norm
scales by a device value, and metrics stay on the device until a log point.

A run is resumable: ``train(ckpt_dir=..., save_every=..., resume=True)``
saves and restores the whole training state (``save_training_state``),
every random stream included, so a resumed run continues the straight run
bit for bit. ``python -m aerial_gym_simulator_tpu_torch.rl.ppo`` is the
command line (``main``).

Sharded (``parallel/distributed.shard_trainer``, ``self.shard`` set), each
rank holds a block of the env axis and the same learner, and every
reduction over envs is global: the normalizer's moments, the minibatches
(one permutation of the global batch drawn by every rank from the same
generator; each rank takes the rows it owns, its loss their sum over the
global minibatch size), the advantage's mean and std, the gradients
(all-reduced before the clip), the KL of the lr schedule and the metrics.
A W-rank update equals the one-rank update up to the order of float sums.
The training state is saved whole, the env carry gathered in env order, so
a checkpoint loads at any world size.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import logging
import os
import pickle
import re
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..parallel import mesh as meshlib
from ..utils import checkpoint
from ..utils.env_rng import set_shard
from ..utils.metrics import MetricsWriter
from .networks import (
    ActorCritic,
    ActorCriticGRU,
    gaussian_entropy,
    gaussian_logp,
    sample_action,
)

logger = logging.getLogger("ppo")


@dataclass
class PPOConfig:
    """Defaults follow rl_training/rl_games/ppo_aerial_quad.yaml.

    ``rnn``: None (MLP) or "gru" (a recurrent policy of ``rnn_hidden``
    units). ``matmul_precision`` is kept so that configs carry across, and
    is without effect: the networks' products run in full f32 here whatever
    it says."""
    num_envs: int = 8192
    horizon: int = 32
    minibatch_size: int = 8192
    epochs: int = 4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    value_coef: float = 2.0
    entropy_coef: float = 0.0
    lr: float = 3e-4
    # "adaptive" raises / lowers the lr by 1.5x per minibatch when the
    # approximate policy KL leaves [kl_threshold / 2, 2 kl_threshold];
    # "fixed" keeps lr
    lr_schedule: str = "adaptive"
    kl_threshold: float = 0.016
    min_lr: float = 1e-6
    max_lr: float = 1e-2
    max_grad_norm: float = 1.0
    total_env_steps: int = 50_000_000
    hidden: Tuple[int, ...] = (256, 128, 64)
    activation: str = "elu"
    normalize_advantage: bool = True
    normalize_obs: bool = True
    # value_bootstrap adds gamma * V(s_t) to the reward at truncated steps,
    # so a timeout is not treated as a terminal; bounds_loss penalizes policy
    # means outside [-1.1, 1.1]; normalize_value trains the critic in
    # running-normalized return space
    value_bootstrap: bool = True
    bounds_loss_coef: float = 0.0001
    normalize_value: bool = False
    reward_scale: float = 0.1
    seed: int = 42
    rnn: Optional[str] = None
    rnn_hidden: int = 256
    matmul_precision: str = "bfloat16"


class RunningMeanStd:
    """Running observation normalizer; the state is a dict of tensors."""

    @staticmethod
    def init(dim: int, device=None) -> Dict[str, torch.Tensor]:
        return {"mean": torch.zeros(dim, device=device),
                "var": torch.ones(dim, device=device),
                "count": torch.tensor(1e-4, device=device)}

    @staticmethod
    def update(s, batch2d, shard=None):
        """Fold a batch of rows into the stats; with ``shard`` the batch is
        every rank's rows together (all-reduced moments)."""
        if shard is None:
            b_mean = batch2d.mean(dim=0)
            b_var = batch2d.var(dim=0, unbiased=False)
            b_count = float(batch2d.shape[0])
        else:
            b_mean, b_var, b_count = _global_moments(batch2d, shard)
        delta = b_mean - s["mean"]
        tot = s["count"] + b_count
        m2 = s["var"] * s["count"] + b_var * b_count + delta * delta * s["count"] * b_count / tot
        out = dict(s)                 # keeps the value-return stats beside them
        out.update(mean=s["mean"] + delta * b_count / tot, var=m2 / tot, count=tot)
        return out

    @staticmethod
    def normalize(s, x):
        return torch.clamp((x - s["mean"]) / torch.sqrt(s["var"] + 1e-8), -5.0, 5.0)


def _global_moments(batch2d, shard):
    """Mean and variance over dim 0 of every rank's rows (equal blocks), and
    their count: two all-reduces, the variance about the global mean."""
    count = float(batch2d.shape[0] * shard.world)
    mean = meshlib.all_reduce_(batch2d.sum(dim=0), shard) / count
    var = meshlib.all_reduce_(((batch2d - mean) ** 2).sum(dim=0), shard) / count
    return mean, var, count


def _vstats_update(norm, x, shard=None):
    """Update the scalar value-return running stats kept beside the obs
    stats (keys v_mean, v_var, v_count)."""
    if shard is None:
        b_mean, b_var, b_count = x.mean(), x.var(unbiased=False), float(x.numel())
    else:
        b_mean, b_var, b_count = _global_moments(x.reshape(-1), shard)
    delta = b_mean - norm["v_mean"]
    tot = norm["v_count"] + b_count
    m2 = (norm["v_var"] * norm["v_count"] + b_var * b_count
          + delta * delta * norm["v_count"] * b_count / tot)
    out = dict(norm)
    out.update(v_mean=norm["v_mean"] + delta * b_count / tot, v_var=m2 / tot, v_count=tot)
    return out


def _v_normalize(norm, v):
    return (v - norm["v_mean"]) / torch.sqrt(norm["v_var"] + 1e-8)


def _v_unnormalize(norm, v):
    return v * torch.sqrt(norm["v_var"] + 1e-8) + norm["v_mean"]


def _bounds_loss(mean, reduce=torch.mean):
    """Quadratic penalty on policy means outside the 1.1 soft bound."""
    high = torch.clamp(mean - 1.1, min=0.0) ** 2
    low = torch.clamp(mean + 1.1, max=0.0) ** 2
    return reduce(torch.sum(high + low, dim=-1))


def _gae(gamma: float, lam: float, values, rewards, dones, last_value):
    """GAE(lambda) over a time-major (T, N) rollout -> (advantages,
    returns)."""
    v_next = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rewards + gamma * v_next * (1.0 - dones) - values
    decay = gamma * lam * (1.0 - dones)
    adv = torch.empty_like(values)
    gae = torch.zeros_like(last_value)
    for t in range(values.shape[0] - 1, -1, -1):
        gae = deltas[t] + decay[t] * gae
        adv[t] = gae
    return adv, adv + values


def _adapt_lr(cfg: PPOConfig, lr: torch.Tensor, kl: torch.Tensor) -> torch.Tensor:
    """Per minibatch: shrink the lr 1.5x when the policy moved too far
    (kl > 2 threshold), grow it 1.5x when it barely moved (kl < threshold /
    2), clamped to [min_lr, max_lr]. ``lr`` and ``kl`` are 0-d tensors."""
    if cfg.lr_schedule != "adaptive":
        return lr
    return torch.where(kl > 2.0 * cfg.kl_threshold, torch.clamp(lr / 1.5, min=cfg.min_lr),
                       torch.where(kl < 0.5 * cfg.kl_threshold,
                                   torch.clamp(lr * 1.5, max=cfg.max_lr), lr))


def ppo_loss(cfg: PPOConfig, network, minibatch, denom=None):
    """Clipped PPO loss on one minibatch (obs, action, old_logp, old_value,
    advantage, return) -> (total, (pg_loss, v_loss, entropy, kl)). With
    ``denom`` the minibatch is this rank's share of a global one of
    ``denom`` samples: each mean becomes a sum over ``denom``, so the ranks'
    losses add up to the global minibatch's."""
    obs, action, old_logp, old_value, adv, ret = minibatch
    mean, log_std, value = network(obs)
    return _clipped_loss(cfg, mean, log_std, value, action, old_logp, old_value, adv, ret,
                         denom)


def ppo_loss_rnn(cfg: PPOConfig, network, minibatch, h0, denom=None):
    """The recurrent loss on a minibatch of whole env sequences: fields
    (E, T, ...) of (obs, action, old_logp, old_value, advantage, return,
    done_prev), replayed time-major from the rollout-start hidden h0 (E, H)
    with the current parameters, the hidden zeroed after each episode end."""
    obs, action, old_logp, old_value, adv, ret, done_prev = (
        x.transpose(0, 1) for x in minibatch)                      # (T, E, ...)
    h, means, values = h0, [], []
    for t in range(obs.shape[0]):
        h = h * (1.0 - done_prev[t])[:, None]
        mean, _, value, h = network(obs[t], h)
        means.append(mean)
        values.append(value)
    return _clipped_loss(cfg, torch.stack(means), network.log_std, torch.stack(values),
                         action, old_logp, old_value, adv, ret, denom)


def _clipped_loss(cfg: PPOConfig, mean, log_std, value, action, old_logp, old_value, adv,
                  ret, denom=None):
    reduce = torch.mean if denom is None else (lambda x: x.sum() / denom)
    logp = gaussian_logp(mean, log_std, action)
    d = logp - old_logp
    ratio = torch.exp(d)
    pg1 = -adv * ratio
    pg2 = -adv * torch.clamp(ratio, 1.0 - cfg.clip_eps, 1.0 + cfg.clip_eps)
    pg_loss = reduce(torch.maximum(pg1, pg2))
    v_clipped = old_value + torch.clamp(value - old_value, -cfg.clip_eps, cfg.clip_eps)
    v_loss = 0.5 * reduce(torch.maximum((value - ret) ** 2, (v_clipped - ret) ** 2))
    ent = torch.mean(gaussian_entropy(log_std))
    if denom is not None:
        ent = ent * (pg1.numel() / denom)        # this rank's share of the samples
    # non-negative approximate KL(old || new), for the lr schedule only
    kl = reduce(ratio - 1.0 - d).detach()
    total = pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * ent
    if cfg.bounds_loss_coef:
        total = total + cfg.bounds_loss_coef * _bounds_loss(mean, reduce)
    return total, (pg_loss.detach(), v_loss.detach(), ent.detach(), kl)


def make_optimizer(network, lr: float) -> torch.optim.Adam:
    """Adam with eps 1e-5 and the learning rate as a 0-d tensor on the
    network's device, so that the schedule can move it without a read-back:
    the fused implementation on a GPU, the per-tensor loop on the CPU (the
    only two that take a tensor lr without graph capture)."""
    device = next(network.parameters()).device
    how = {"fused": True} if device.type == "cuda" else {"foreach": False}
    return torch.optim.Adam(network.parameters(), lr=torch.tensor(float(lr), device=device),
                            eps=1e-5, **how)


def clip_and_step(optimizer: torch.optim.Adam, max_grad_norm: float):
    """Clip the gradients in ``.grad`` by their global norm, then Adam."""
    params = [p for group in optimizer.param_groups for p in group["params"]]
    torch.nn.utils.clip_grad_norm_(params, max_grad_norm)
    optimizer.step()


def _map_leaves(tree, kind, fn):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, kind, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, kind) else tree


@dataclass
class Rollout:
    """One horizon of experience, time-major (T, N, ...)."""
    norm_obs: torch.Tensor
    actions: torch.Tensor
    logps: torch.Tensor
    values: torch.Tensor
    rewards: torch.Tensor           # scaled, with the truncation bootstrap
    dones: torch.Tensor
    terms: torch.Tensor
    done_prev: Optional[torch.Tensor] = None    # recurrent: the mask before each step
    h0: Optional[torch.Tensor] = None           # recurrent: the rollout-start hidden (N, H)


class PPOTrainer:
    """The training loop around a task's ``make_step_fn`` protocol. Runs on
    the task's device."""

    def __init__(self, task, cfg: PPOConfig):
        if cfg.rnn not in (None, "gru"):
            raise ValueError(f"unknown rnn type {cfg.rnn!r} (None or 'gru')")
        if cfg.lr_schedule not in ("adaptive", "fixed"):
            raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r} ('adaptive' or 'fixed')")
        self.task, self.cfg = task, cfg
        self.device = task.device
        self.obs_dim = int(task.task_config.observation_space_dim)
        self.action_dim = int(task.task_config.action_space_dim)

        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            if cfg.rnn == "gru":
                network = ActorCriticGRU(self.obs_dim, self.action_dim, cfg.hidden,
                                         cfg.rnn_hidden, cfg.activation)
            else:
                network = ActorCritic(self.obs_dim, self.action_dim, cfg.hidden,
                                      cfg.activation)
        self.network = network.to(self.device)
        self.optimizer = make_optimizer(self.network, cfg.lr)
        self.norm = RunningMeanStd.init(self.obs_dim, self.device)
        # scalar running stats of the value targets, carried even when
        # normalize_value is off so that a checkpoint's layout does not
        # depend on the config
        self.norm.update(v_mean=torch.zeros((), device=self.device),
                         v_var=torch.ones((), device=self.device),
                         v_count=torch.tensor(1e-4, device=self.device))
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(cfg.seed)
        self._iter = 0
        self.shard = None           # parallel/distributed.shard_trainer sets this rank's block
        self._act_h = None          # the recurrent act()'s hidden state

        self.step_fn, self.env_carry, self.obs = task.make_step_fn()
        N, T = cfg.num_envs, cfg.horizon
        batch = N * T
        if cfg.rnn == "gru":
            # the policy's hidden state and the episode-boundary mask ride
            # in the env carry
            self.env_carry = (self.env_carry,
                              torch.zeros((N, cfg.rnn_hidden), device=self.device),
                              torch.zeros((N,), device=self.device))
            # minibatches of whole env sequences
            self.mb_envs = max(min(cfg.minibatch_size // T, N), 1)
            self.n_minibatches = max(N // self.mb_envs, 1)
            self.mb_size = self.mb_envs * T
            if self.mb_size != min(cfg.minibatch_size, batch):
                logger.info("rnn minibatches are whole env sequences: effective minibatch is "
                            "%d envs x %d steps = %d samples (requested minibatch_size %d)",
                            self.mb_envs, T, self.mb_size, cfg.minibatch_size)
            if N % self.mb_envs:
                logger.warning("num_envs %d is not a multiple of the %d-env sequence "
                               "minibatch: %d env sequences are dropped from every epoch "
                               "(a random subset per shuffle)", N, self.mb_envs,
                               N - self.n_minibatches * self.mb_envs)
        else:
            self.mb_size = min(cfg.minibatch_size, batch)
            self.n_minibatches = batch // self.mb_size
            if self.mb_size != cfg.minibatch_size:
                logger.info("minibatch_size %d > rollout batch %d: clamped to one minibatch",
                            cfg.minibatch_size, batch)
            if batch % self.mb_size:
                logger.warning("batch %d is not a multiple of minibatch_size %d: %d samples "
                               "are dropped from every epoch (a random subset per shuffle)",
                               batch, self.mb_size, batch - self.n_minibatches * self.mb_size)

    @property
    def lr(self) -> torch.Tensor:
        return self.optimizer.param_groups[0]["lr"]

    @lr.setter
    def lr(self, value: torch.Tensor):
        self.optimizer.param_groups[0]["lr"] = value

    # -- one iteration ------------------------------------------------------

    def _normalize(self, obs):
        return RunningMeanStd.normalize(self.norm, obs) if self.cfg.normalize_obs else obs

    @torch.no_grad()
    def collect_rollout(self) -> Rollout:
        """Step the task ``horizon`` times with sampled actions."""
        cfg = self.cfg
        recurrent = cfg.rnn == "gru"
        if recurrent:
            carry, h, done_prev = self.env_carry
            h0 = h
        else:
            carry = self.env_carry
        obs, traj = self.obs, []
        for _ in range(cfg.horizon):
            norm_obs = self._normalize(obs)
            if recurrent:
                mean, log_std, value, h = self.network(norm_obs,
                                                       h * (1.0 - done_prev)[:, None])
            else:
                mean, log_std, value = self.network(norm_obs)
            if cfg.normalize_value:
                value = _v_unnormalize(self.norm, value)
            action, logp = sample_action(mean, log_std, self.generator)
            carry, obs, reward, term, trunc = self.step_fn(carry, action)
            shaped = reward * cfg.reward_scale
            if cfg.value_bootstrap:
                shaped = shaped + cfg.gamma * value * trunc     # a timeout is no terminal
            done = torch.maximum(term, trunc)
            traj.append((norm_obs, action, logp, value, shaped, done, term)
                        + ((done_prev,) if recurrent else ()))
            if recurrent:
                done_prev = done
        self.obs = obs
        ro = Rollout(*(torch.stack(x) for x in zip(*traj)))
        if recurrent:
            self.env_carry = (carry, h, done_prev)
            ro.h0 = h0
        else:
            self.env_carry = carry
        return ro

    def _last_value(self):
        """V of the observation after the rollout."""
        norm_obs = self._normalize(self.obs)
        if self.cfg.rnn == "gru":
            _, h, done_prev = self.env_carry
            return self.network(norm_obs, h * (1.0 - done_prev)[:, None])[2]
        return self.network(norm_obs)[2]

    def update(self, ro: Rollout) -> Dict[str, torch.Tensor]:
        """GAE, then ``epochs`` passes over shuffled minibatches; returns the
        iteration's metrics as 0-d tensors on the device."""
        cfg, sh = self.cfg, self.shard
        T, N = ro.values.shape
        batch = T * N
        with torch.no_grad():
            if cfg.normalize_obs:
                self.norm = RunningMeanStd.update(self.norm, ro.norm_obs.reshape(batch, -1), sh)
            last_value = self._last_value()
            if cfg.normalize_value:
                last_value = _v_unnormalize(self.norm, last_value)
            adv, ret = _gae(cfg.gamma, cfg.gae_lambda, ro.values, ro.rewards, ro.dones,
                            last_value)
            values_st, ret_st = ro.values, ret
            if cfg.normalize_value:
                # stats on the values, normalize; then on the returns, normalize
                self.norm = _vstats_update(self.norm, ro.values, sh)
                values_st = _v_normalize(self.norm, ro.values)
                self.norm = _vstats_update(self.norm, ret, sh)
                ret_st = _v_normalize(self.norm, ret)
            if cfg.rnn == "gru":
                col = lambda x: x[..., None]
                # whole sequences as per-env rows: (T, N, D) -> (N, T, D)
                data = torch.cat([ro.norm_obs, ro.actions, col(ro.logps), col(values_st),
                                  col(adv), col(ret_st), col(ro.done_prev)],
                                 dim=-1).transpose(0, 1)
            else:
                col = lambda x: x.reshape(batch, 1)
                data = torch.cat([ro.norm_obs.reshape(batch, -1),
                                  ro.actions.reshape(batch, -1), col(ro.logps),
                                  col(values_st), col(adv), col(ret_st)], dim=1)
        aux = (self._update_rnn(data, ro.h0) if cfg.rnn == "gru"
               else self._update_mlp(data, batch))
        pg_loss, v_loss, ent, kl = torch.stack(aux).mean(dim=0)
        if sh is None:
            means = (ro.rewards.mean(), ro.dones.mean(), ro.terms.mean(), ro.values.mean())
        else:
            sums = torch.stack([ro.rewards.sum(), ro.dones.sum(), ro.terms.sum(),
                                ro.values.sum()])
            means = (meshlib.all_reduce_(sums, sh) / float(batch * sh.world)).unbind()
        return {"reward_mean": means[0] / cfg.reward_scale,
                "done_rate": means[1], "crash_rate": means[2],
                "pg_loss": pg_loss, "v_loss": v_loss, "entropy": ent, "approx_kl": kl,
                "lr": self.lr, "value_mean": means[3]}

    def _step(self, total, stats):
        self.optimizer.zero_grad(set_to_none=True)
        total.backward()
        stats = torch.stack(stats)
        if self.shard is not None:
            stats = self._all_reduce_grads(stats)
        clip_and_step(self.optimizer, self.cfg.max_grad_norm)
        self.lr = _adapt_lr(self.cfg, self.lr, stats[3])
        return stats

    def _all_reduce_grads(self, stats):
        """Sum every gradient and the loss terms over the ranks, in one
        all-reduce of a flat buffer -> the global loss terms."""
        params = list(self.network.parameters())
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in params]
        flat = meshlib.all_reduce_(torch.cat([g.reshape(-1) for g in grads] + [stats]),
                                   self.shard)
        i = 0
        for p, g in zip(params, grads):
            p.grad = flat[i:i + g.numel()].view_as(g)
            i += g.numel()
        return flat[i:]

    def _normalized_advantage(self, adv, denom=None):
        """Minibatch-normalized advantages; sharded, over the global
        minibatch of ``denom`` samples (all-reduced mean, then variance)."""
        if not self.cfg.normalize_advantage:
            return adv
        if self.shard is None:
            return (adv - adv.mean()) / (adv.std(unbiased=False) + 1e-8)
        mean = meshlib.all_reduce_(adv.sum(), self.shard) / denom
        var = meshlib.all_reduce_(((adv - mean) ** 2).sum(), self.shard) / denom
        return (adv - mean) / (torch.sqrt(var) + 1e-8)

    def _owned(self, g, per_env: int):
        """The local rows of the global indices ``g`` this rank owns: index
        g counts env-major within each of ``per_env``-wide time rows of the
        global batch ((t, env) flattened, or env alone for whole sequences)."""
        sh = self.shard
        t, e = g // sh.n_global, g % sh.n_global
        own = (e >= sh.offset) & (e < sh.offset + sh.n_local)
        return (t * per_env + (e - sh.offset))[own]

    def _update_mlp(self, data, batch):
        """Epochs of shuffled sample minibatches; -> per-step loss terms.
        Sharded: one permutation of the global batch, every rank's own rows
        of each global minibatch."""
        cfg, sh = self.cfg, self.shard
        o, a = self.obs_dim, self.obs_dim + self.action_dim
        global_batch = batch if sh is None else batch * sh.world
        aux = []
        for _ in range(cfg.epochs):
            perm = torch.randperm(global_batch, generator=self.generator, device=self.device)
            shuffled = data[perm] if sh is None else None
            for i in range(self.n_minibatches):
                if sh is None:
                    mb, denom = shuffled[i * self.mb_size:(i + 1) * self.mb_size], None
                else:
                    g = perm[i * self.mb_size:(i + 1) * self.mb_size]
                    mb, denom = data[self._owned(g, sh.n_local)], self.mb_size
                aux.append(self._step(*ppo_loss(cfg, self.network, (
                    mb[:, :o], mb[:, o:a], mb[:, a], mb[:, a + 1],
                    self._normalized_advantage(mb[:, a + 2], denom), mb[:, a + 3]), denom)))
        return aux

    def _update_rnn(self, rows, h0):
        """Epochs of minibatches of whole env sequences, the permutation
        drawn over envs (over every rank's envs when sharded); -> per-step
        loss terms."""
        cfg, sh = self.cfg, self.shard
        o, a = self.obs_dim, self.obs_dim + self.action_dim
        n_envs = rows.shape[0] if sh is None else sh.n_global
        aux = []
        for _ in range(cfg.epochs):
            perm = torch.randperm(n_envs, generator=self.generator, device=self.device)
            if sh is None:
                shuffled, h0_perm = rows[perm], h0[perm]
            for i in range(self.n_minibatches):
                sl = slice(i * self.mb_envs, (i + 1) * self.mb_envs)
                if sh is None:
                    mb, h_mb, denom = shuffled[sl], h0_perm[sl], None
                else:
                    idx = self._owned(perm[sl], 0)
                    mb, h_mb, denom = rows[idx], h0[idx], self.mb_envs * rows.shape[1]
                aux.append(self._step(*ppo_loss_rnn(cfg, self.network, (
                    mb[..., :o], mb[..., o:a], mb[..., a], mb[..., a + 1],
                    self._normalized_advantage(mb[..., a + 2], denom), mb[..., a + 3],
                    mb[..., a + 4]), h_mb, denom)))
        return aux

    def train_iteration(self) -> Dict[str, torch.Tensor]:
        metrics = self.update(self.collect_rollout())
        self._iter += 1
        return metrics

    # -- the loop -------------------------------------------------------------

    def train(self, total_env_steps: Optional[int] = None, log_every: int = 10,
              logdir: Optional[str] = None, track: Optional[str] = None,
              ckpt_dir: Optional[str] = None, save_every: int = 0, resume: bool = False):
        """Run ``total_env_steps // (num_envs * horizon)`` iterations (at
        least one) -> history, one dict of floats per log point. Metrics are
        read back from the device at the log points only.

        ``logdir`` / ``track``: the log points also go to a
        ``utils/metrics.MetricsWriter`` (``metrics.jsonl``, TensorBoard,
        wandb). ``ckpt_dir`` / ``save_every``: the whole training state is
        saved every ``save_every`` iterations and at the end;
        ``resume=True`` first restores the newest state under ``ckpt_dir``
        and continues from its iteration (nothing to train, and ``[]``
        returned, when it is already at or past the requested ones).

        ``env_steps_per_s`` is the steady rate from the end of the first
        iteration of this call (the device is synchronized once there);
        ``env_steps_per_s_cumulative`` counts this call's wall time from
        its start. Sharded, every rank trains and returns the same history;
        only the root logs, writes the metrics and writes the checkpoints
        (every rank takes part in gathering them)."""
        cfg = self.cfg
        steps_per_iter = cfg.num_envs * cfg.horizon
        iters = max((total_env_steps or cfg.total_env_steps) // steps_per_iter, 1)
        start_iter = 0
        if resume and ckpt_dir and os.path.isdir(ckpt_dir):
            start_iter = self.restore_training_state(ckpt_dir)
        if start_iter >= iters:
            logger.info("resume: checkpoint already at iter %d >= %d requested; nothing to "
                        "train", start_iter, iters)
            return []
        last_saved = start_iter if start_iter else None
        root = meshlib.is_root()
        writer = MetricsWriter(logdir if root else None, track=track if root else None)
        history, t_start = [], time.perf_counter()
        t_steady, steps_steady = None, 0
        for it in range(start_iter, iters):
            metrics = self.train_iteration()
            if t_steady is None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                t_steady, steps_steady = time.perf_counter(), (it + 1) * steps_per_iter
            if ckpt_dir and save_every and (it + 1) % save_every == 0:
                self.save_training_state(ckpt_dir)
                last_saved = it + 1
            if it % log_every == 0 or it == iters - 1:
                names = sorted(metrics)
                values = torch.stack([metrics[k].float() for k in names]).tolist()  # one sync
                now = time.perf_counter()
                m = dict(zip(names, values))
                m.update(iter=it, env_steps=(it + 1) * steps_per_iter, wall_s=now - t_start)
                run_steps = m["env_steps"] - start_iter * steps_per_iter
                m["env_steps_per_s_cumulative"] = run_steps / max(m["wall_s"], 1e-9)
                dt, dsteps = now - t_steady, m["env_steps"] - steps_steady
                m["env_steps_per_s"] = (dsteps / dt if dsteps > 0 and dt > 0
                                        else m["env_steps_per_s_cumulative"])
                history.append(m)
                writer.write(m["env_steps"], m)
                if root:
                    logger.info("it %4d steps %.2e reward %7.3f crash %.3f sps %.0f wall %.1fs",
                                it, m["env_steps"], m["reward_mean"], m["crash_rate"],
                                m["env_steps_per_s"], m["wall_s"])
        writer.close()
        if ckpt_dir and save_every and last_saved != iters:
            self.save_training_state(ckpt_dir)
        if hasattr(self.task, "set_carry"):
            # the recurrent carry holds (task carry, hidden, done_prev)
            self.task.set_carry(self.env_carry[0] if cfg.rnn else self.env_carry)
        return history

    # -- resumable training state ---------------------------------------------
    # The bundle holds everything an iteration reads or draws from: the
    # network, Adam's moments and step counts with the current lr, the
    # normalizer, the env carry (with its generators) and observation, the
    # trainer's generator (actions, shuffles), the task's host RNG where it
    # has one, and the iteration count. Files are iter_<n>.pt under the
    # directory, written atomically; the older of two is deleted only after
    # the new one is in place.

    def _adam_state(self):
        """Adam's per-parameter state, with a fresh Adam's zeros for a
        parameter it has not stepped yet, so the layout never depends on
        whether an update ran."""
        out = {}
        for i, p in enumerate(self.network.parameters()):
            st = self.optimizer.state.get(p, {})
            out[i] = {"step": st.get("step", torch.zeros((), device=p.device)),
                      "exp_avg": st.get("exp_avg", torch.zeros_like(p)),
                      "exp_avg_sq": st.get("exp_avg_sq", torch.zeros_like(p))}
        return out

    def _task_py_rng(self):
        sim_env = getattr(self.task, "sim_env", None)
        return getattr(sim_env, "_py_rng", None)

    def _training_bundle(self):
        """The state to save; sharded, the env carry and observation are
        gathered whole in env order (collective), so the file is the one an
        unsharded trainer writes."""
        py_rng = self._task_py_rng()
        carry, obs = self.env_carry, self.obs
        if self.shard is not None:
            carry = meshlib.gather_env_pytree(carry, self.shard)
            obs = meshlib.gather_env_pytree(obs, self.shard)
        return {"network": dict(self.network.state_dict()), "optimizer": self._adam_state(),
                "lr": self.lr, "norm": dict(self.norm), "env_carry": carry,
                "obs": obs, "generator": self.generator,
                "task_py_rng": None if py_rng is None else py_rng.getstate(),
                "iter": self._iter}

    @staticmethod
    def _checkpoints(dir_path: str):
        """{iteration: path} of the training states under ``dir_path``."""
        found = {}
        for name in os.listdir(dir_path):
            m = re.fullmatch(r"iter_(\d+)\.pt", name)
            if m:
                found[int(m.group(1))] = os.path.join(dir_path, name)
        return found

    def save_training_state(self, dir_path: str) -> str:
        """Write the whole training state to ``<dir_path>/iter_<n>.pt``
        (atomic); keep it and the newest earlier one, delete the rest.
        Sharded: every rank gathers, the root writes, the others wait."""
        path = os.path.join(dir_path, f"iter_{self._iter}.pt")
        bundle = self._training_bundle()
        if meshlib.is_root():
            os.makedirs(dir_path, exist_ok=True)
            checkpoint.save_state(path, bundle)
            older = sorted(n for n in self._checkpoints(dir_path) if n != self._iter)
            for n in older[:-1]:
                os.unlink(os.path.join(dir_path, f"iter_{n}.pt"))
            logger.info("training state saved to %s (iter %d)", path, self._iter)
        if self.shard is not None:
            meshlib.barrier(self.shard, self.device)
        return path

    def restore_training_state(self, dir_path: str) -> int:
        """Restore the newest training state under ``dir_path`` -> the
        iteration to resume from (0, with a warning, when there is none).
        This trainer is the template: the file must come from the same
        configuration, on the same device type, at any world size: sharded,
        the saved carry is cut to this rank's block."""
        found = self._checkpoints(dir_path) if os.path.isdir(dir_path) else {}
        if not found:
            logger.warning("no training state under %s; starting fresh", dir_path)
            return 0
        path = found[max(found)]
        saved = checkpoint.load_state(path, like=self._training_bundle())
        self.network.load_state_dict(saved["network"])
        state = self.optimizer.state_dict()
        state["state"] = saved["optimizer"]
        self.optimizer.load_state_dict(state)
        self.lr = saved["lr"]
        self.norm = saved["norm"]
        self.env_carry, self.obs = saved["env_carry"], saved["obs"]
        self.generator = saved["generator"]
        if self.shard is not None:
            n = self.cfg.num_envs
            self.env_carry = meshlib.shard_env_pytree(self.env_carry, self.shard, n)
            self.obs = meshlib.shard_env_pytree(self.obs, self.shard, n)
            meshlib.register_generators(self.env_carry, self.shard)
            set_shard(self.generator, self.shard)
        if saved["task_py_rng"] is not None:
            self._task_py_rng().setstate(saved["task_py_rng"])
        self._iter = int(saved["iter"])
        self._act_h = None          # a hidden state of the old parameters means nothing
        logger.info("training state restored from %s (resuming at iter %d)", path, self._iter)
        return self._iter

    # -- inference and checkpoints -------------------------------------------

    def reset_act_hidden(self, env_ids=None):
        """Zero the recurrent hidden state that ``act`` carries: of all envs,
        or of ``env_ids`` (no-op for an MLP policy). A caller whose envs
        reset themselves can pass the previous step's dones to ``act``
        instead."""
        if env_ids is None:
            self._act_h = None
        elif self._act_h is not None:
            self._act_h[torch.as_tensor(env_ids, device=self.device)] = 0.0

    @torch.no_grad()
    def act(self, obs, deterministic: bool = True, done_prev=None):
        """Policy inference: the action mean, or a sample. ``done_prev``
        (N,) marks envs whose episode ended on the previous step: the
        recurrent policy zeroes their hidden state first, as the rollout
        does."""
        obs = torch.as_tensor(obs, dtype=torch.float32, device=self.device)
        if self.cfg.rnn == "gru":
            if self._act_h is None or self._act_h.shape[0] != obs.shape[0]:
                self._act_h = torch.zeros((obs.shape[0], self.cfg.rnn_hidden),
                                          device=self.device)
            elif done_prev is not None:
                keep = 1.0 - torch.as_tensor(done_prev, dtype=torch.float32,
                                             device=self.device)
                self._act_h = self._act_h * keep[:, None]
            mean, log_std, _, self._act_h = self.network(self._normalize(obs), self._act_h)
        else:
            mean, log_std, _ = self.network(self._normalize(obs))
        if deterministic:
            return mean
        return sample_action(mean, log_std, self.generator)[0]

    def save_checkpoint(self, path: str):
        """Pickle the network's parameters, the normalizer state, Adam's
        moments and step counts with the current learning rate, and the
        config (numpy inside); ``sim2real.policy.export_policy_npz`` reads
        it."""
        with open(path, "wb") as f:
            pickle.dump({
                "params": {k: v.detach().cpu().numpy() for k, v in
                           self.network.state_dict().items()},
                "norm": {k: v.detach().cpu().numpy() for k, v in self.norm.items()},
                "optimizer": _map_leaves(self.optimizer.state_dict()["state"], torch.Tensor,
                                         lambda t: t.detach().cpu().numpy()),
                "lr": float(self.lr),
                "iter": self._iter,
                "cfg": dataclasses.asdict(self.cfg),
                "obs_dim": self.obs_dim, "action_dim": self.action_dim,
            }, f)
        logger.info("checkpoint saved to %s", path)

    def load_checkpoint(self, path: str):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        with torch.no_grad():
            for name, p in self.network.named_parameters():
                p.copy_(torch.as_tensor(np.asarray(blob["params"][name]), device=self.device))
        self.norm = {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=self.device)
                     for k, v in blob["norm"].items()}
        # Adam's state from the file, its settings from this trainer
        state = self.optimizer.state_dict()
        state["state"] = _map_leaves(blob["optimizer"], np.ndarray, torch.from_numpy)
        self.optimizer.load_state_dict(state)
        self.lr = torch.tensor(blob["lr"], device=self.device)
        self._iter = blob["iter"]
        self._act_h = None          # a hidden state of the old parameters means nothing
        logger.info("checkpoint loaded from %s", path)


# -- the command line ---------------------------------------------------------

def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m aerial_gym_simulator_tpu_torch.rl.ppo",
        description="Train a PPO policy on a registered task (on CUDA unless --cpu).")
    p.add_argument("--task", default="position_setpoint_task")
    p.add_argument("--num_envs", type=int, default=8192)
    p.add_argument("--total_steps", type=int, default=50_000_000)
    p.add_argument("--horizon", type=int, default=32)
    p.add_argument("--seed", type=int, default=42)
    add_multi_device_flags(p)
    p.add_argument("--logdir", default=None, help="write TensorBoard + metrics.jsonl here")
    p.add_argument("--vae_params", default=None,
                   help="frozen depth-encoder parameters (.pkl from models/train_vae) for "
                        "the navigation task")
    p.add_argument("--torch_vae", default=None,
                   help="the reference framework's torch VAE .pth for the navigation task "
                        "(models/torch_vae_import)")
    p.add_argument("--track", default=None, choices=[None, "wandb"],
                   help="also stream the metrics to wandb")
    p.add_argument("--ckpt_dir", default=None,
                   help="directory of the resumable training state")
    p.add_argument("--save_every", type=int, default=50,
                   help="save the training state every N iterations (with --ckpt_dir)")
    p.add_argument("--resume", action="store_true",
                   help="resume from the newest training state under --ckpt_dir")
    p.add_argument("--entropy_coef", type=float, default=0.0,
                   help="entropy bonus (the reference's sample-factory lidar/radar configs "
                        "use exploration_loss_coeff 0.001)")
    p.add_argument("--rnn", default=None, choices=[None, "gru"],
                   help="recurrent policy core (GRU actor-critic)")
    p.add_argument("--rnn_hidden", type=int, default=256)
    p.add_argument("--save", default=None,
                   help="write the final learner checkpoint here (the pickle that "
                        "load_checkpoint and sim2real.policy.export_policy_npz read)")
    p.add_argument("--task_kv", action="append", default=[], metavar="K=V",
                   help="override a task-config attribute (the value parsed as a Python "
                        "literal, else kept as a string), e.g. --task_kv "
                        "radar_invalid_anneal_env_steps=150000000; repeatable")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p


def add_multi_device_flags(p: argparse.ArgumentParser):
    p.add_argument("--multichip", action="store_true",
                   help="shard the env axis over every process of the world torchrun set up "
                        "(torchrun --nproc_per_node=N -m ... --multichip); a world of one "
                        "without torchrun")
    p.add_argument("--multihost", action="store_true",
                   help="join the process group first and require it (MASTER_ADDR / "
                        "MASTER_PORT / RANK / WORLD_SIZE, as torchrun sets them); raises "
                        "without a coordinator")


def init_multi_device(args) -> bool:
    """``--multihost``: join the process group or raise; ``--multichip``:
    join it when torchrun configured one, else stay a world of one (logged).
    gloo with ``--cpu``, else the backend rule of ``initialize_multihost``.
    -> whether sharding applies."""
    if not (args.multichip or args.multihost):
        return False
    from ..parallel.distributed import initialize_multihost
    initialize_multihost(require=args.multihost, backend="gloo" if args.cpu else None)
    return True


def parse_args(argv=None) -> argparse.Namespace:
    """The command line -> arguments; ``args.task_overrides`` holds the
    parsed ``--task_kv`` pairs. An unknown task-config attribute is a
    parser error."""
    p = _parser()
    args = p.parse_args(argv)
    from ..registry.registries import task_registry
    if args.task not in task_registry.get_task_names():
        p.error(f"unknown task {args.task!r}; registered: {task_registry.get_task_names()}")
    template = task_registry.get_task_config(args.task)
    args.task_overrides = {}
    for kv in args.task_kv:
        k, _, v = kv.partition("=")
        if not hasattr(template, k):
            p.error(f"--task_kv: task config has no attribute {k!r}")
        try:
            args.task_overrides[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            args.task_overrides[k] = v          # a plain string (e.g. a robot name)
    return args


def build_trainer(args: argparse.Namespace):
    """The task and the trainer the command line describes -> (task,
    trainer); nothing has trained yet. ``--multichip`` / ``--multihost``:
    the process group is joined first and the trainer sharded over it."""
    multi = init_multi_device(args)
    from ..registry.registries import task_registry
    task_config = task_registry.get_task_config(args.task)
    if args.vae_params or args.torch_vae:
        task_config = dataclasses.replace(task_config, vae_params_path=args.vae_params,
                                          torch_vae_path=args.torch_vae)
    for k, v in args.task_overrides.items():
        setattr(task_config, k, v)
    task = task_registry.make_task(args.task, num_envs=args.num_envs, seed=args.seed,
                                   task_config=task_config,
                                   device="cpu" if args.cpu else None)
    cfg = PPOConfig(num_envs=args.num_envs, horizon=args.horizon,
                    minibatch_size=min(8192, args.num_envs * args.horizon),
                    total_env_steps=args.total_steps, seed=args.seed,
                    entropy_coef=args.entropy_coef, rnn=args.rnn, rnn_hidden=args.rnn_hidden)
    trainer = PPOTrainer(task, cfg)
    if multi:
        from ..parallel.distributed import shard_trainer
        shard_trainer(trainer)
    return task, trainer


def log_to_stdout():
    """INFO logging to stdout for the command lines, unless the process has
    configured logging itself."""
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                            format="[%(asctime)s] %(name)s %(levelname)s: %(message)s",
                            datefmt="%H:%M:%S")


def main(argv=None):
    """``python -m aerial_gym_simulator_tpu_torch.rl.ppo [flags]``: train,
    optionally save, print the final reward -> the history."""
    args = parse_args(argv)
    log_to_stdout()
    task, trainer = build_trainer(args)
    history = trainer.train(logdir=args.logdir, track=args.track, ckpt_dir=args.ckpt_dir,
                            save_every=args.save_every, resume=args.resume)
    root = meshlib.is_root()
    if args.save and root:
        trainer.save_checkpoint(args.save)
    task.close()
    if not root:
        return history
    if not history:
        print("nothing to train (resumed checkpoint already complete)")
        return history
    print(f"final reward: {history[-1]['reward_mean']:.3f} ({history[-1]['wall_s']:.1f}s wall)")
    return history


if __name__ == "__main__":
    main()
