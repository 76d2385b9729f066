"""Helpers of tests/test_torch_nav_ppo_recipe.py and its 2-process worker:
a stub task with the navigation task's widths, the recipe's configuration
cut to a test's size, the learner's state before an update, and the plain
reference's whole update on the union of every rank's rollout
(``perfbench/reference/recurrent_ppo.py``)."""

from __future__ import annotations

import os
import types

import torch

from aerial_gym_simulator_tpu_torch.rl_training.rl_games.runner import (
    CONFIG_DIR, load_yaml_config, ppo_config_from_yaml)
from aerial_gym_simulator_tpu_torch.utils.env_rng import env_rand, env_randn

RECIPE = os.path.join(CONFIG_DIR, "ppo_aerial_quad_navigation.yaml")
OBS_DIM, ACTION_DIM = 81, 4          # the navigation task's observation and action widths

# global envs, horizon, one rank's minibatch (samples), seed
CASES = {
    # two minibatches of 4 sequences, every rank owning part of each
    "two_minibatches": dict(envs=8, horizon=32, minibatch=64, seed=3),
    # four minibatches of one sequence: each rank owns none of two of them
    "empty_share": dict(envs=4, horizon=8, minibatch=4, seed=5),
    # one process: two minibatches of 8 sequences
    "single": dict(envs=16, horizon=32, minibatch=256, seed=7),
}


def recipe_config(case: dict, world: int = 1):
    """``ppo_config_from_yaml`` of the shipped navigation YAML, its
    horizon and minibatch cut to the case."""
    doc = load_yaml_config(RECIPE)
    doc["params"]["config"].update(horizon_length=case["horizon"],
                                   minibatch_size=case["minibatch"])
    return ppo_config_from_yaml(doc, num_envs=case["envs"], seed=case["seed"], world=world)


class StubTask:
    """The PPO step protocol with the navigation task's widths: seeded
    observations and rewards, 5% terminations and 5% truncations a step,
    every draw made by the env-rng rule (so a rank's block equals the same
    rows of the whole batch)."""

    def __init__(self, num_envs: int, shard=None, seed: int = 11):
        self.shard = shard
        self.num_envs = num_envs if shard is None else shard.n_local
        self.device = torch.device("cpu")
        self.task_config = types.SimpleNamespace(observation_space_dim=OBS_DIM,
                                                 action_space_dim=ACTION_DIM)
        self.gen = torch.Generator().manual_seed(seed)

    def make_step_fn(self):
        n = self.num_envs

        def step_fn(carry, action):
            g = carry["rng"]
            obs = 2.0 * env_randn(g, (n, OBS_DIM)) + 0.5
            reward = env_randn(g, (n,)) + action.sum(-1)
            u = env_rand(g, (n, 2))
            return carry, obs, reward, (u[:, 0] < 0.05).float(), (u[:, 1] < 0.05).float()

        return step_fn, {"rng": self.gen}, torch.zeros((n, OBS_DIM))


def snapshot(trainer) -> dict:
    """The learner as the update finds it, and the carry after the rollout."""
    names = [k for k, _ in trainer.network.named_parameters()]
    adam = {names[i]: {k: v.clone() for k, v in st.items()}
            for i, st in trainer._adam_state().items()}
    _, h, done = trainer.env_carry
    return dict(params={k: v.detach().clone() for k, v in trainer.network.named_parameters()},
                adam=adam, lr=float(trainer.lr),
                norm={k: v.clone() for k, v in trainer.norm.items()},
                gen=trainer.generator.get_state(), obs_last=trainer.obs.clone(),
                h_last=h.clone(), done_last=done.clone())


def reference_config(cfg) -> dict:
    return dict(e_clip=cfg.clip_eps, critic_coef=cfg.value_coef, entropy_coef=cfg.entropy_coef,
                bounds_loss_coef=cfg.bounds_loss_coef, grad_norm=cfg.max_grad_norm,
                kl_threshold=cfg.kl_threshold, min_lr=cfg.min_lr, max_lr=cfg.max_lr,
                gamma=cfg.gamma, tau=cfg.gae_lambda, obs_dim=OBS_DIM, action_dim=ACTION_DIM)


def reference_update(ref, snaps, cfg):
    """The plain reference's update on the union of the ranks' rollouts
    (``snaps`` in rank order, each ``snapshot`` plus ``rollout``) ->
    (parameters, lr)."""
    s0 = snaps[0]
    ro = {k: torch.cat([s["rollout"][k] for s in snaps], dim=1)
          for k in ("norm_obs", "actions", "logps", "values", "rewards", "dones", "done_prev")}
    last = {k: torch.cat([s[f"{k}_last"] for s in snaps], dim=0) for k in ("obs", "h", "done")}
    rcfg = reference_config(cfg)
    rows, _, _ = ref.update_rows(s0["params"], s0["norm"], ro, last, rcfg)
    g = torch.Generator()
    g.set_state(s0["gen"])
    N = rows.shape[0]
    perms = [torch.randperm(N, generator=g) for _ in range(cfg.epochs)]
    mb_envs = min(cfg.minibatch_size // cfg.horizon, N)
    h0 = torch.cat([s["rollout"]["h0"] for s in snaps], dim=0)
    params, _, lr = ref.update(s0["params"], s0["adam"], s0["lr"], rcfg, rows, h0, perms, mb_envs)
    return params, lr
