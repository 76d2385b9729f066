"""Deterministic actor inference from an exported ``.npz`` policy archive.

Counterpart of ``NumpyPolicy`` / ``load_policy_npz`` in the JAX package's
``sim2real/numpy_policy.py`` and of its ``NumpyRecurrentPolicy``
(``sim2real/torch_import.py``), as ``nn.Module``s that run on the task's
device, so a closed loop has no host round trip.

Feed-forward layout: ``activation``, ``normalize_obs``, ``norm_mean``,
``norm_var``, ``norm_eps`` (optional, 1e-8), ``W0..Wn`` (in, out),
``b0..bn``, ``log_std``. Recurrent layout (``recurrent`` or ``n_enc``
present): the normalizer (``norm_eps`` 1e-5 when absent), an encoder MLP
``enc_W0..`` / ``enc_b0..`` (``n_enc`` layers, ``activation`` elu when
absent), a GRU in torch's packed layout (``gru_Wih`` (3H, in), ``gru_Whh``
(3H, H), ``gru_bih``, ``gru_bhh``, gates r, z, n) when ``recurrent``, and a
head ``head_W`` (H, out) / ``head_b`` whose first ``action_dim`` outputs
are the action. ``export_policy_npz`` writes these layouts from a
``PPOTrainer`` or its checkpoint, so a policy trained here flies through
this loader and the JAX package's alike.
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


class RecurrentPolicy(nn.Module):
    """obs -> action mean through encoder MLP, GRU and head, carrying one
    hidden state per env; ``reset(env_ids)`` zeroes them (all when None)."""

    def __init__(self, archive, num_envs: int = 1, action_dim=None):
        super().__init__()
        self.activation = str(archive.get("activation", "elu"))
        if self.activation not in _ACT:
            raise ValueError(f"unknown activation {self.activation!r}; known: {sorted(_ACT)}")
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
        self.normalize_obs = bool(archive["normalize_obs"])
        eps = float(archive["norm_eps"]) if "norm_eps" in archive else 1e-5
        self.register_buffer("norm_mean", f32(archive["norm_mean"]))
        self.register_buffer("norm_std", torch.sqrt(f32(archive["norm_var"]) + eps))
        self.encoder = nn.ModuleList()
        for i in range(int(archive["n_enc"])):
            W = f32(archive[f"enc_W{i}"])                  # (in, out)
            layer = nn.Linear(W.shape[0], W.shape[1])
            with torch.no_grad():
                layer.weight.copy_(W.T)
                layer.bias.copy_(f32(archive[f"enc_b{i}"]))
            self.encoder.append(layer)
        self.recurrent = bool(archive.get("recurrent", False))
        self.hidden_dim = 0
        if self.recurrent:
            wih, whh = f32(archive["gru_Wih"]), f32(archive["gru_Whh"])
            H = whh.shape[1]
            if wih.shape[0] != 3 * H or whh.shape[0] != 3 * H:
                raise ValueError(f"recurrent core with gru_Wih {tuple(wih.shape)} and gru_Whh "
                                 f"{tuple(whh.shape)} is not a GRU of {H} units")
            self.hidden_dim = H
            for name, key in (("w_ih", "gru_Wih"), ("w_hh", "gru_Whh"), ("b_ih", "gru_bih"),
                              ("b_hh", "gru_bhh")):
                self.register_buffer(name, f32(archive[key]))
        self.register_buffer("head_w", f32(archive["head_W"]))
        self.register_buffer("head_b", f32(archive["head_b"]))
        # the action width: the archive's own key, else the caller's, else
        # an even head width read as [mu, log_std]
        out = self.head_b.shape[0]
        if "action_dim" in archive:
            self.action_dim = int(archive["action_dim"])
        elif action_dim is not None:
            self.action_dim = int(action_dim)
        else:
            self.action_dim = out // 2 if out % 2 == 0 else out
        self.num_envs = num_envs
        self.register_buffer("hidden", torch.zeros((num_envs, self.hidden_dim)))

    def reset(self, env_ids=None):
        """Zero the hidden state of ``env_ids`` (indices, or a (num_envs,)
        bool mask, which needs no read-back to the host), of all when None."""
        if env_ids is None:
            self.hidden.zero_()
        elif isinstance(env_ids, torch.Tensor) and env_ids.dtype == torch.bool:
            self.hidden = self.hidden * (~env_ids).to(self.hidden.dtype)[:, None]
        else:
            self.hidden[torch.as_tensor(env_ids, device=self.hidden.device)] = 0.0

    def gru_step(self, x: torch.Tensor) -> torch.Tensor:
        """One step of torch.nn.GRU's cell (gates r, z, n) on the carried
        hidden state, which it updates."""
        H, h = self.hidden_dim, self.hidden
        gi = x @ self.w_ih.T + self.b_ih
        gh = h @ self.w_hh.T + self.b_hh
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        self.hidden = (1.0 - z) * n + z * h
        return self.hidden

    @torch.no_grad()
    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        """(num_envs, obs_dim) -> (num_envs, action_dim); a single 1-D
        observation is a batch of one and gives a 1-D action."""
        x = obs.to(torch.float32)
        squeeze = x.dim() == 1
        if squeeze:
            x = x[None]
        if self.recurrent and x.shape[0] != self.num_envs:
            raise ValueError(f"obs batch {x.shape[0]} != num_envs {self.num_envs}: a "
                             "recurrent policy carries one hidden state per env")
        if self.normalize_obs:
            x = torch.clamp((x - self.norm_mean) / self.norm_std, -5.0, 5.0)
        act = _ACT[self.activation]
        for layer in self.encoder:
            x = act(layer(x))
        if self.recurrent:
            x = self.gru_step(x)
        mu = (x @ self.head_w + self.head_b)[:, :self.action_dim]
        return mu[0] if squeeze else mu


def load_policy_npz(npz_path: str, device=None, num_envs: int = 1, action_dim=None):
    """Open a policy archive on ``device`` (CUDA unless the caller passes
    'cpu'): a ``RecurrentPolicy`` for ``num_envs`` envs if the archive is
    recurrent, an ``MLPPolicy`` otherwise. ``action_dim`` resolves a head
    without the archive's own key."""
    with np.load(npz_path, allow_pickle=True) as z:
        archive = {k: z[k] for k in z.files}
    if ("recurrent" in archive and bool(archive["recurrent"])) or "n_enc" in archive:
        policy = RecurrentPolicy(archive, num_envs=num_envs, action_dim=action_dim)
    else:
        policy = MLPPolicy(archive)
    return policy.to(resolve_device(device)).eval()


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
                "obs_dim": source.obs_dim, "action_dim": source.action_dim}
    cfg, params, norm = blob["cfg"], blob["params"], blob["norm"]
    rnn = cfg.get("rnn")
    if rnn not in (None, "gru"):
        raise ValueError(f"cannot export rnn={rnn!r} checkpoints (None or 'gru')")
    flat = {"activation": np.array(cfg.get("activation", "elu")),
            "obs_dim": np.array(int(blob["obs_dim"])),
            "norm_mean": np.asarray(norm["mean"]), "norm_var": np.asarray(norm["var"]),
            "norm_eps": np.array(1e-8, np.float32),       # RunningMeanStd's epsilon
            "normalize_obs": np.array(bool(cfg.get("normalize_obs", True)))}
    if rnn == "gru":
        if "rnn_norm.weight" in params:
            raise ValueError("cannot export a GRU policy with a LayerNorm on its core's output "
                             "(rnn_layer_norm): the recurrent archive has no place for it")
        _recurrent_layout(flat, params, int(blob["action_dim"]))
    else:
        n_hidden = sum(1 for k in params if k.startswith("actor.") and k.endswith(".weight"))
        layers = [f"actor.{i}" for i in range(n_hidden)] + ["mean_head"]
        for i, name in enumerate(layers):
            flat[f"W{i}"] = np.asarray(params[f"{name}.weight"]).T      # (in, out)
            flat[f"b{i}"] = np.asarray(params[f"{name}.bias"])
        flat["log_std"] = np.asarray(params["log_std"])
    np.savez(npz_path, **flat)
    return npz_path


def _recurrent_layout(flat: dict, params: dict, action_dim: int):
    """An ``ActorCriticGRU``'s actor in the recurrent archive layout: flax's
    gates map onto torch's packed GRU with zero hidden-side r and z biases,
    and the head emits [mu, log_std] (zero rows: log_std does not depend on
    the state)."""
    P = lambda name: np.asarray(params[name])
    n_enc = 0
    while f"encoder.{n_enc}.weight" in params:
        flat[f"enc_W{n_enc}"] = P(f"encoder.{n_enc}.weight").T     # (in, out)
        flat[f"enc_b{n_enc}"] = P(f"encoder.{n_enc}.bias")
        n_enc += 1
    flat["n_enc"] = np.array(n_enc)
    gate = lambda *names: np.concatenate([P(f"gru.{n}") for n in names])
    flat["gru_Wih"] = gate("ir.weight", "iz.weight", "in_.weight")   # (3H, in)
    flat["gru_Whh"] = gate("hr.weight", "hz.weight", "hn.weight")    # (3H, H)
    flat["gru_bih"] = gate("ir.bias", "iz.bias", "in_.bias")
    zeros = np.zeros_like(P("gru.hn.bias"))
    flat["gru_bhh"] = np.concatenate([zeros, zeros, P("gru.hn.bias")])
    flat["recurrent"] = np.array(True)
    mu_w = P("mean_head.weight").T                                  # (H, A)
    flat["head_W"] = np.concatenate([mu_w, np.zeros_like(mu_w)], axis=1)
    flat["head_b"] = np.concatenate([P("mean_head.bias"), P("log_std")])
    flat["action_dim"] = np.array(action_dim)
