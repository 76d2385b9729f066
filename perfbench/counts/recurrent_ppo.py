"""Operations of the navigation recipe's recurrent policy and of its PPO
update, counted from the widths: the MLP, the GRU's six products (three on
the input, three on the hidden state), the mean and value heads. A
multiply-add counts two operations; gates, the LayerNorm, activations and
Adam are not counted. A backward pass counts as two forwards."""

from __future__ import annotations


def policy_flops(obs_dim: int, mlp, units: int, action_dim: int) -> float:
    """One env's forward pass."""
    widths = [obs_dim, *mlp]
    dense = sum(2.0 * a * b for a, b in zip(widths[:-1], widths[1:]))
    gru = 3 * 2.0 * (widths[-1] * units + units * units)
    heads = 2.0 * units * (action_dim + 1)
    return dense + gru + heads


def update_flops(per_env: float, samples: int, epochs: int, envs: int) -> float:
    """One rank's update of ``samples`` (envs x horizon): each epoch a
    forward and a backward of every sample, and the last value's forward of
    each of its ``envs``."""
    return 3.0 * per_env * samples * epochs + per_env * envs
