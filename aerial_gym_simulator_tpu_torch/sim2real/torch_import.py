"""Import trained reference-framework checkpoints (torch) for deployment.

Counterpart of ``aerial_gym_simulator_tpu/sim2real/torch_import.py``. The
reference ships rl-games policy checkpoints (an actor MLP, a mu head and
sigma) and sample-factory navigation checkpoints (an observation
normalizer, an MLP encoder, a GRU core and an action head). These functions
convert either format once into the flat ``.npz`` archives every deployment
surface of the port opens:

- :func:`import_rl_games_policy` writes the feed-forward layout
  (``sim2real.policy.MLPPolicy`` on a device, ``NumpyPolicy`` without one);
- :func:`import_sample_factory_policy` writes the recurrent layout
  (``sim2real.policy.RecurrentPolicy`` on a device,
  :class:`NumpyRecurrentPolicy` without one, with torch.nn.GRU's gates).

A ``.pth`` is read with ``weights_only=True``: tensors only, no code (a
pickled whole ``nn.Module`` is refused; save its ``state_dict()``).
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np

from .numpy_policy import ACTIVATIONS

logger = logging.getLogger("torch_import")


def _t2n(t) -> np.ndarray:
    return np.asarray(t.detach().cpu().numpy(), np.float32)


def _load_state_dict(pth_path: str) -> dict:
    import torch

    blob = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model" in blob:
        return blob["model"]
    return blob


def import_rl_games_policy(pth_path: str, npz_path: str, activation: str = "elu") -> str:
    """rl-games A2C checkpoint -> feed-forward ``.npz``.

    Expects the reference's layout: ``a2c_network.actor_mlp.{0,2,4}.weight``
    (torch Linear, out x in), ``a2c_network.mu.{weight,bias}`` actor head,
    ``a2c_network.sigma`` log-std, optional
    ``running_mean_std.running_mean/var`` input normalizer.
    """
    sd = _load_state_dict(pth_path)
    layers = sorted(
        {int(k.split(".")[2]) for k in sd
         if k.startswith("a2c_network.actor_mlp.") and k.endswith(".weight")})
    if not layers:
        raise ValueError(f"{pth_path}: no a2c_network.actor_mlp layers found")

    flat = {"activation": np.array(activation)}
    for i, idx in enumerate(layers):
        flat[f"W{i}"] = _t2n(sd[f"a2c_network.actor_mlp.{idx}.weight"]).T
        flat[f"b{i}"] = _t2n(sd[f"a2c_network.actor_mlp.{idx}.bias"])
    n = len(layers)
    flat[f"W{n}"] = _t2n(sd["a2c_network.mu.weight"]).T
    flat[f"b{n}"] = _t2n(sd["a2c_network.mu.bias"])
    flat["log_std"] = (_t2n(sd["a2c_network.sigma"]) if "a2c_network.sigma" in sd
                       else np.zeros(flat[f"b{n}"].shape, np.float32))

    obs_dim = flat["W0"].shape[0]
    flat["obs_dim"] = np.array(obs_dim)
    if "running_mean_std.running_mean" in sd:
        flat["norm_mean"] = _t2n(sd["running_mean_std.running_mean"])
        flat["norm_var"] = _t2n(sd["running_mean_std.running_var"])
        flat["normalize_obs"] = np.array(True)
        flat["norm_eps"] = np.array(1e-5, np.float32)  # rl-games' epsilon
    else:
        flat["norm_mean"] = np.zeros(obs_dim, np.float32)
        flat["norm_var"] = np.ones(obs_dim, np.float32)
        flat["normalize_obs"] = np.array(False)

    np.savez(npz_path, **flat)
    logger.info("imported rl-games policy %s -> %s (%d layers, obs %d, act %d)", pth_path,
                npz_path, n + 1, obs_dim, flat[f"b{n}"].shape[0])
    return npz_path


_SF_PREFIXES = (
    "obs_normalizer.running_mean_std.running_mean_std.obs.",
    "obs_normalizer.running_mean_std.obs.",
)


def import_sample_factory_policy(pth_path: str, npz_path: str) -> str:
    """sample-factory actor-critic checkpoint -> recurrent ``.npz``.

    Expects the reference's shipped layout: ``encoder.encoders.obs.
    mlp_head.{0,2,4}`` (ELU MLP), ``core.core.*_l0`` (single-layer GRU) and
    ``action_parameterization.distribution_linear`` emitting ``[mu,
    log_std]`` (continuous actions with adaptive stddev). A feed-forward
    checkpoint (no ``core.core``) imports with an identity core.
    """
    sd = _load_state_dict(pth_path)
    flat = {"normalize_obs": np.array(False)}
    # the normalizer at either nesting depth seen in shipped checkpoints
    for p in _SF_PREFIXES:
        if p + "running_mean" in sd:
            flat["norm_mean"] = _t2n(sd[p + "running_mean"])
            flat["norm_var"] = _t2n(sd[p + "running_var"])
            flat["normalize_obs"] = np.array(True)
            break

    enc_layers = sorted(
        {int(k.split("mlp_head.")[1].split(".")[0]) for k in sd
         if "encoder.encoders.obs.mlp_head." in k and k.endswith(".weight")})
    if not enc_layers:
        raise ValueError(f"{pth_path}: no encoder.encoders.obs.mlp_head layers found")
    for i, idx in enumerate(enc_layers):
        key = f"encoder.encoders.obs.mlp_head.{idx}"
        flat[f"enc_W{i}"] = _t2n(sd[key + ".weight"]).T
        flat[f"enc_b{i}"] = _t2n(sd[key + ".bias"])
    flat["n_enc"] = np.array(len(enc_layers))

    if "core.core.weight_ih_l0" in sd:
        flat["gru_Wih"] = _t2n(sd["core.core.weight_ih_l0"])   # (3H, in)
        flat["gru_Whh"] = _t2n(sd["core.core.weight_hh_l0"])   # (3H, H)
        flat["gru_bih"] = _t2n(sd["core.core.bias_ih_l0"])
        flat["gru_bhh"] = _t2n(sd["core.core.bias_hh_l0"])
        flat["recurrent"] = np.array(True)
    else:
        flat["recurrent"] = np.array(False)

    flat["head_W"] = _t2n(sd["action_parameterization.distribution_linear.weight"]).T
    flat["head_b"] = _t2n(sd["action_parameterization.distribution_linear.bias"])

    if "norm_mean" not in flat:
        obs_dim = flat["enc_W0"].shape[0]
        flat["norm_mean"] = np.zeros(obs_dim, np.float32)
        flat["norm_var"] = np.ones(obs_dim, np.float32)
    flat["obs_dim"] = np.array(flat["enc_W0"].shape[0])

    np.savez(npz_path, **flat)
    logger.info("imported sample-factory policy %s -> %s (obs %d, recurrent %s, head %d)",
                pth_path, npz_path, int(flat["obs_dim"]), bool(flat["recurrent"]),
                flat["head_b"].shape[0])
    return npz_path


def _sigmoid(x):
    # exp only sees non-positive arguments: no overflow warning at large |x|
    e = np.exp(-np.abs(x))
    return np.where(x >= 0, 1.0 / (1.0 + e), e / (1.0 + e))


class NumpyRecurrentPolicy:
    """Numpy inference for recurrent archives (imported sample-factory
    policies and the trainer's GRU exports); numpy only, no device.

    Carries one GRU hidden state per env; ``reset(env_ids)`` zeroes them as
    the reference's inference class zeroes its RNN states. The action is
    the mu part of the head's output."""

    def __init__(self, npz_path: str, num_envs: int = 1, action_dim: Optional[int] = None):
        with np.load(npz_path, allow_pickle=True) as z:
            self.z = {k: z[k] for k in z.files}
        self.num_envs = num_envs
        # imported sample-factory archives carry neither key: their
        # normalizer epsilon is 1e-5 and their encoder ELU
        self.act = ACTIVATIONS[str(self.z.get("activation", "elu"))]
        self.norm_eps = float(self.z.get("norm_eps", 1e-5))
        self.recurrent = bool(self.z["recurrent"])
        self.hidden_dim = self.z["gru_Whh"].shape[1] if self.recurrent else 0
        self.hidden = np.zeros((num_envs, self.hidden_dim), np.float32)
        # the mu width: the archive's own key (it wins over the caller's),
        # else the caller's, else an even head width read as [mu, log_std]
        head_out = self.z["head_b"].shape[0]
        if "action_dim" in self.z:
            self.action_dim = int(self.z["action_dim"])
            if action_dim is not None and action_dim != self.action_dim:
                logger.warning("requested action_dim %d != the archive's %d; using the "
                               "archive's", action_dim, self.action_dim)
        elif action_dim is not None:
            self.action_dim = action_dim
        else:
            self.action_dim = head_out // 2 if head_out % 2 == 0 else head_out

    def reset(self, env_ids=None):
        if not self.recurrent:
            return
        if env_ids is None:
            self.hidden[:] = 0.0
        else:
            self.hidden[np.asarray(env_ids)] = 0.0

    def _gru_step(self, x: np.ndarray) -> np.ndarray:
        """torch.nn.GRU's cell (gates r, z, n) on the carried hidden state."""
        z, h, H = self.z, self.hidden, self.hidden_dim
        gi = x @ z["gru_Wih"].T + z["gru_bih"]
        gh = h @ z["gru_Whh"].T + z["gru_bhh"]
        r = _sigmoid(gi[:, :H] + gh[:, :H])
        u = _sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = np.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        self.hidden = (1.0 - u) * n + u * h
        return self.hidden

    def __call__(self, obs: np.ndarray) -> np.ndarray:
        z = self.z
        x = np.asarray(obs, np.float32)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None]
        if self.recurrent and x.shape[0] != self.num_envs:
            # broadcasting would smear one observation's update over every
            # env's hidden row
            raise ValueError(f"obs batch {x.shape[0]} != num_envs {self.num_envs}: a "
                             "recurrent policy carries one hidden state per env")
        if bool(z["normalize_obs"]):
            x = np.clip((x - z["norm_mean"]) / np.sqrt(z["norm_var"] + self.norm_eps),
                        -5.0, 5.0)
        for i in range(int(z["n_enc"])):
            x = self.act(x @ z[f"enc_W{i}"] + z[f"enc_b{i}"])
        if self.recurrent:
            x = self._gru_step(x)
        mu = (x @ z["head_W"] + z["head_b"])[:, :self.action_dim]
        return mu[0] if squeeze else mu
