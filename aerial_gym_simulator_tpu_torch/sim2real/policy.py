"""Deterministic actor inference from an exported ``.npz`` policy archive.

Counterpart of ``NumpyPolicy`` / ``load_policy_npz`` in the JAX package's
``sim2real/numpy_policy.py``, as an ``nn.Module`` that runs on the task's
device, so a closed loop has no host round trip. Archive layout:
``activation``, ``normalize_obs``, ``norm_mean``, ``norm_var``,
``norm_eps`` (optional, 1e-8), ``W0..Wn`` (in, out), ``b0..bn``,
``log_std``. ``export_policy_npz`` writes that layout from a ``PPOTrainer``
or its checkpoint, so a policy trained here flies through this loader and
the JAX package's alike.
"""

from __future__ import annotations

import pickle

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device

_ACT = {"elu": F.elu, "tanh": torch.tanh, "relu": F.relu}


class MLPPolicy(nn.Module):
    """obs -> action mean: normalise and clip the observation to +-5,
    hidden layers with the archive's activation, linear head."""

    def __init__(self, archive):
        super().__init__()
        self.activation = str(archive["activation"])
        if self.activation not in _ACT:
            raise ValueError(f"unknown activation {self.activation!r}; known: {sorted(_ACT)}")
        self.normalize_obs = bool(archive["normalize_obs"])
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
        eps = float(archive["norm_eps"]) if "norm_eps" in archive else 1e-8
        self.register_buffer("norm_mean", f32(archive["norm_mean"]))
        self.register_buffer("norm_std", torch.sqrt(f32(archive["norm_var"]) + eps))
        self.register_buffer("log_std", f32(archive["log_std"]))
        self.layers = nn.ModuleList()
        i = 0
        while f"W{i}" in archive:
            W = f32(archive[f"W{i}"])                      # (in, out)
            layer = nn.Linear(W.shape[0], W.shape[1])
            with torch.no_grad():
                layer.weight.copy_(W.T)
                layer.bias.copy_(f32(archive[f"b{i}"]))
            self.layers.append(layer)
            i += 1

    @property
    def action_dim(self) -> int:
        return self.layers[-1].out_features

    @torch.no_grad()
    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs.to(torch.float32)
        if self.normalize_obs:
            x = torch.clamp((x - self.norm_mean) / self.norm_std, -5.0, 5.0)
        act = _ACT[self.activation]
        for layer in self.layers[:-1]:
            x = act(layer(x))
        return self.layers[-1](x)


def load_policy_npz(npz_path: str, device=None) -> MLPPolicy:
    """Open a feed-forward policy archive on ``device`` (CUDA unless the
    caller passes 'cpu'). Recurrent (GRU) archives are refused."""
    with np.load(npz_path, allow_pickle=True) as z:
        if ("recurrent" in z.files and bool(z["recurrent"])) or "n_enc" in z.files:
            raise NotImplementedError(
                f"{npz_path} is a recurrent (GRU) policy archive; only feed-forward MLP "
                "policies are ported so far (GRU policies come with the LiDAR/radar tasks)")
        archive = {k: z[k] for k in z.files}
    return MLPPolicy(archive).to(resolve_device(device)).eval()


def export_policy_npz(source, npz_path: str) -> str:
    """Write the actor of a ``rl.ppo.PPOTrainer``, or of a checkpoint file it
    saved, as a flat numpy archive (the critic is dropped)."""
    if isinstance(source, (str, bytes)) or hasattr(source, "__fspath__"):
        with open(source, "rb") as f:
            blob = pickle.load(f)
    else:
        blob = {"params": {k: v.detach().cpu().numpy()
                           for k, v in source.network.state_dict().items()},
                "norm": {k: v.detach().cpu().numpy() for k, v in source.norm.items()},
                "cfg": {"activation": source.cfg.activation,
                        "normalize_obs": source.cfg.normalize_obs, "rnn": source.cfg.rnn},
                "obs_dim": source.obs_dim}
    cfg, params, norm = blob["cfg"], blob["params"], blob["norm"]
    if cfg.get("rnn") is not None:
        raise NotImplementedError("recurrent checkpoints are not ported yet")
    flat = {"activation": np.array(cfg.get("activation", "elu")),
            "obs_dim": np.array(int(blob["obs_dim"])),
            "norm_mean": np.asarray(norm["mean"]), "norm_var": np.asarray(norm["var"]),
            "norm_eps": np.array(1e-8, np.float32),       # RunningMeanStd's epsilon
            "normalize_obs": np.array(bool(cfg.get("normalize_obs", True)))}
    n_hidden = sum(1 for k in params if k.startswith("actor.") and k.endswith(".weight"))
    layers = [f"actor.{i}" for i in range(n_hidden)] + ["mean_head"]
    for i, name in enumerate(layers):
        flat[f"W{i}"] = np.asarray(params[f"{name}.weight"]).T      # (in, out)
        flat[f"b{i}"] = np.asarray(params[f"{name}.bias"])
    flat["log_std"] = np.asarray(params["log_std"])
    np.savez(npz_path, **flat)
    return npz_path
