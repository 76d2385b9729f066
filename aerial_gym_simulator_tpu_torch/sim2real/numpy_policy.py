"""Numpy-only policy inference for onboard deployment.

Counterpart of ``NumpyPolicy`` in ``aerial_gym_simulator_tpu/sim2real/
numpy_policy.py``. It runs the actor MLP of an exported ``.npz`` archive
(``sim2real.policy.export_policy_npz`` writes one from a trainer or its
checkpoint) with numpy alone: it has no device and imports no torch, for a
robot's computer without a GPU or a framework. ``sim2real.policy``'s
``MLPPolicy`` is the same actor on a torch device.
"""

from __future__ import annotations

import numpy as np


def _elu(x):
    # expm1 only on the negative side (no overflow warning from the
    # branch np.where does not select)
    return np.where(x > 0, x, np.expm1(np.minimum(x, 0.0)))


ACTIVATIONS = {"elu": _elu, "tanh": np.tanh, "relu": lambda x: np.maximum(x, 0.0)}


class NumpyPolicy:
    """Deterministic actor inference from an exported .npz; numpy only."""

    def __init__(self, npz_path: str):
        data = np.load(npz_path, allow_pickle=True)
        self.act = ACTIVATIONS[str(data["activation"])]
        self.normalize_obs = bool(data["normalize_obs"])
        self.norm_mean = data["norm_mean"].astype(np.float32)
        self.norm_var = data["norm_var"].astype(np.float32)
        # the normalizer's epsilon depends on the format: 1e-8 for the
        # trainer's running statistics, 1e-5 for rl-games' (imported
        # archives carry their own)
        self.norm_eps = float(data["norm_eps"]) if "norm_eps" in data else 1e-8
        self.layers = []
        i = 0
        while f"W{i}" in data:
            self.layers.append((data[f"W{i}"].astype(np.float32),
                                data[f"b{i}"].astype(np.float32)))
            i += 1
        self.log_std = data["log_std"].astype(np.float32)

    @property
    def action_dim(self) -> int:
        return self.layers[-1][0].shape[1]

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        x = np.asarray(obs, np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if self.normalize_obs:
            x = np.clip((x - self.norm_mean)
                        / np.sqrt(self.norm_var + self.norm_eps), -5.0, 5.0)
        *hidden_layers, (W_out, b_out) = self.layers
        for W, b in hidden_layers:
            x = self.act(x @ W + b)
        x = x @ W_out + b_out
        return x[0] if squeeze else x
