"""Policy and value networks.

Counterpart of ``aerial_gym_simulator_tpu/rl/networks.py`` (feed-forward
part): a 3-layer MLP actor and a separate 3-layer MLP critic, [256, 128,
64] with elu by default, orthogonal initial weights with the JAX package's
gains, a state-independent log standard deviation. f32: at these sizes the
networks are bound by launch latency, not by arithmetic. The recurrent
``ActorCriticGRU`` comes with the LiDAR/radar tasks.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

ACTIVATIONS = {"elu": F.elu, "tanh": torch.tanh, "relu": F.relu}


def _dense(n_in: int, n_out: int, gain: float) -> nn.Linear:
    layer = nn.Linear(n_in, n_out)
    nn.init.orthogonal_(layer.weight, gain=gain)
    nn.init.zeros_(layer.bias)
    return layer


class ActorCritic(nn.Module):
    """obs -> (action mean, log_std (action_dim,), value (N,))."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (256, 128, 64),
                 activation: str = "elu"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; known: {sorted(ACTIVATIONS)}")
        self.activation = activation
        widths = [obs_dim, *hidden]
        stack = lambda: nn.ModuleList(_dense(a, b, math.sqrt(2.0))
                                      for a, b in zip(widths[:-1], widths[1:]))
        self.actor = stack()
        self.mean_head = _dense(widths[-1], action_dim, 0.01)
        self.critic = stack()
        self.value_head = _dense(widths[-1], 1, 1.0)
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs):
        act = ACTIVATIONS[self.activation]
        x = v = obs
        for layer in self.actor:
            x = act(layer(x))
        for layer in self.critic:
            v = act(layer(v))
        return self.mean_head(x), self.log_std, self.value_head(v).squeeze(-1)


def gaussian_logp(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)


def sample_action(mean, log_std, generator: torch.Generator = None, noise=None):
    """-> (action, log-probability); the standard-normal ``noise`` is given
    or drawn from the generator."""
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                            dtype=mean.dtype)
    action = mean + torch.exp(log_std) * noise
    return action, gaussian_logp(mean, log_std, action)
