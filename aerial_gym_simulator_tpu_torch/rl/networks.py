"""Policy and value networks.

Counterpart of ``aerial_gym_simulator_tpu/rl/networks.py``: a 3-layer MLP
actor and a separate 3-layer MLP critic, [256, 128, 64] with elu by
default, orthogonal initial weights with the JAX package's gains, a
state-independent log standard deviation; and the recurrent
``ActorCriticGRU`` (encoder MLP, a GRU core with flax's gates, separate
heads). f32: at these sizes the networks are bound by launch latency, not
by arithmetic.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.env_rng import env_randn

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


def _lecun_dense(n_in: int, n_out: int, bias: bool = True) -> nn.Linear:
    """flax's default kernel init: a normal of variance 1 / fan_in truncated
    at two standard deviations (its std corrected for the truncation)."""
    layer = nn.Linear(n_in, n_out, bias=bias)
    std = math.sqrt(1.0 / n_in) / 0.87962566103423978
    nn.init.trunc_normal_(layer.weight, std=std, a=-2.0 * std, b=2.0 * std)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class GRUCell(nn.Module):
    """flax's ``nn.GRUCell`` in its parameter layout: input kernels ``ir``,
    ``iz``, ``in_`` with biases, hidden kernels ``hr``, ``hz`` without and
    ``hn`` with one:

        r = sigmoid(W_ir x + b_ir + W_hr h)
        z = sigmoid(W_iz x + b_iz + W_hz h)
        n = tanh(W_in x + b_in + r * (W_hn h + b_hn))
        h' = (1 - z) n + z h

    (``torch.nn.GRUCell`` carries two more hidden-side biases, for r and z.)
    Input kernels lecun-normal, hidden kernels orthogonal, biases zero."""

    def __init__(self, n_in: int, hidden: int):
        super().__init__()
        self.ir, self.iz, self.in_ = (_lecun_dense(n_in, hidden) for _ in range(3))
        self.hr, self.hz = (_dense_orthogonal(hidden, hidden, bias=False) for _ in range(2))
        self.hn = _dense_orthogonal(hidden, hidden, bias=True)

    def forward(self, h, x):
        r = torch.sigmoid(self.ir(x) + self.hr(h))
        z = torch.sigmoid(self.iz(x) + self.hz(h))
        n = torch.tanh(self.in_(x) + r * self.hn(h))
        return (1.0 - z) * n + z * h


def _dense_orthogonal(n_in: int, n_out: int, bias: bool) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, bias=bias)
    nn.init.orthogonal_(layer.weight)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


class ActorCriticGRU(nn.Module):
    """Recurrent actor-critic: encoder MLP -> GRU core -> separate mean and
    value heads. The hidden state is explicit: ``forward(obs, h) -> (mean,
    log_std (action_dim,), value (N,), h_new)``."""

    def __init__(self, obs_dim: int, action_dim: int, hidden: Sequence[int] = (256,),
                 rnn_hidden: int = 256, activation: str = "elu"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; known: {sorted(ACTIVATIONS)}")
        self.activation = activation
        self.rnn_hidden = rnn_hidden
        widths = [obs_dim, *hidden]
        self.encoder = nn.ModuleList(_dense(a, b, math.sqrt(2.0))
                                     for a, b in zip(widths[:-1], widths[1:]))
        self.gru = GRUCell(widths[-1], rnn_hidden)
        self.mean_head = _dense(rnn_hidden, action_dim, 0.01)
        self.value_head = _dense(rnn_hidden, 1, 1.0)
        self.log_std = nn.Parameter(torch.zeros(action_dim))

    def forward(self, obs, h):
        act = ACTIVATIONS[self.activation]
        x = obs
        for layer in self.encoder:
            x = act(layer(x))
        h = self.gru(h, x)
        return self.mean_head(h), self.log_std, self.value_head(h).squeeze(-1), h


def gaussian_logp(mean, log_std, action):
    z = (action - mean) / torch.exp(log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2.0 * math.pi), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * math.log(2.0 * math.pi * math.e), dim=-1)


def sample_action(mean, log_std, generator: torch.Generator = None, noise=None):
    """-> (action, log-probability); the standard-normal ``noise`` is given
    or drawn from the generator."""
    if noise is None:
        noise = env_randn(generator, mean.shape, device=mean.device, dtype=mean.dtype)
    action = mean + torch.exp(log_std) * noise
    return action, gaussian_logp(mean, log_std, action)
