"""Gym-style vectorized env wrappers over the task API.

Counterpart of ``aerial_gym_simulator_tpu/rl_training/vec_env.py`` (the
reference's ExtractObsWrapper + AERIALRLGPUEnv,
rl_training/rl_games/runner.py:26-79): flatten the task's obs dict to one
tensor and merge terminations and truncations into ``dones``.
"""

from __future__ import annotations

import numpy as np
import torch


class ExtractObsWrapper:
    """obs dict -> ``observations`` tensor; dones = terminated | truncated
    (tensors on the task's device)."""

    def __init__(self, task):
        self.task = task
        self.num_envs = task.num_envs
        self.num_obs = task.observation_space_dim
        self.num_actions = task.action_space_dim

    def reset(self):
        obs, *_ = self.task.reset()
        return obs["observations"]

    def step(self, actions):
        obs, rew, term, trunc, infos = self.task.step(actions)
        return obs["observations"], rew, torch.maximum(term, trunc), infos

    def close(self):
        self.task.close()


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class AerialGymVecEnv:
    """sample-factory style vec env: ``step`` -> (obs_dict, rew, terminated,
    truncated, infos) as numpy for host-side frameworks (the reference's
    sample_factory/aerialgym_examples/train_aerialgym.py:33-88).

    The protocol surface is pinned by tests/data/sf_protocol_transcript.json:
    per-agent ``observation_space`` / ``action_space`` (gymnasium spaces
    where gymnasium imports, else None), bool terminated / truncated that
    sample-factory bitwise-ors, actions as numpy arrays or torch tensors on
    any device (moved to the task's device), and no ``reset`` between
    episodes (the task's step resets finished envs itself).

    Seeding happens when the task is built: ``reset(seed=...)`` forwards the
    seed to ``task.seed()`` (the host-side numpy RNG) and otherwise ignores
    it, as the reference, where Isaac Gym also seeds only at sim build."""

    def __init__(self, task, obs_key: str = "observations"):
        self.task = task
        self.obs_key = obs_key
        self.num_agents = task.num_envs
        self.render_mode = None
        try:
            import gymnasium as gym

            obs_dim = int(task.observation_space_dim)
            act_dim = int(task.action_space_dim)
            self.observation_space = gym.spaces.Dict({
                "obs": gym.spaces.Box(-np.inf, np.inf, (obs_dim,), np.float32)})
            self.action_space = gym.spaces.Box(-1.0, 1.0, (act_dim,), np.float32)
        except ImportError:
            self.observation_space = None
            self.action_space = None

    def reset(self, *args, seed=None, **kwargs):
        if seed is not None and hasattr(self.task, "seed"):
            self.task.seed(seed)          # the host-side RNG only; see the class docstring
        obs, *_ = self.task.reset()
        return {"obs": _numpy(obs[self.obs_key])}, {}

    def step(self, actions):
        actions = torch.as_tensor(actions, dtype=torch.float32, device=self.task.device)
        obs, rew, term, trunc, infos = self.task.step(actions)
        return ({"obs": _numpy(obs[self.obs_key])},
                _numpy(rew).astype(np.float32, copy=False),
                _numpy(term).astype(bool), _numpy(trunc).astype(bool), infos)

    def render(self):
        pass

    def close(self):
        self.task.close()
