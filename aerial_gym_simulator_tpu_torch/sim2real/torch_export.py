"""TorchScript deployment export for onboard inference.

Counterpart of ``aerial_gym_simulator_tpu/sim2real/torch_export.py``, after
the reference's deployment converter (``rl_training/sample_factory/
end_to_end_training/deployment/convert_model.py:10-62``: ``ModelDeploy``
with ``rescale_actions(min_u, max_u)``, ``torch.jit.script`` +
``torch.jit.save``). It reads the flat ``.npz`` archive that both the
port's own exports (``sim2real.policy.export_policy_npz``) and the
importers (``sim2real.torch_import``) write, and emits a TorchScript file
that needs only (Lib)Torch at run time.

Feed-forward archives become :class:`PolicyDeploy`; recurrent (GRU)
archives become :class:`RecurrentPolicyDeploy`, whose hidden state is an
argument of ``forward`` (a stateless module, as scripting wants).
``build_deploy_module`` puts the module on a device (CUDA unless
``device="cpu"``); ``convert_model_to_script_model`` saves the file from
the CPU, so it loads anywhere (``torch.jit.load(p, map_location=...)``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device

_ACTIVATIONS = {"elu": nn.ELU, "tanh": nn.Tanh, "relu": nn.ReLU}


def _activation_module(name: str) -> nn.Module:
    if name not in _ACTIVATIONS:
        raise ValueError(f"unsupported activation {name!r}")
    return _ACTIVATIONS[name]()


def _linear(W, b) -> nn.Linear:
    """nn.Linear from an archive's (in, out) matrix and bias."""
    lin = nn.Linear(W.shape[0], W.shape[1])
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(W.T))
        lin.bias.copy_(torch.as_tensor(b))
    return lin


def _register_normalizer(module: nn.Module, norm_mean, norm_var, norm_eps: float, min_u,
                         max_u):
    """The observation normalizer's mean and std, and the actuator limits,
    as buffers. The std is taken once, on the CPU, as ``sim2real.policy``'s
    runners take it: the card's square root can differ in the last bit,
    which the policy's encoder magnifies."""
    module.register_buffer("norm_mean", torch.as_tensor(norm_mean))
    module.register_buffer("norm_std", torch.sqrt(torch.as_tensor(norm_var) + float(norm_eps)))
    module.register_buffer("min_u", torch.as_tensor(min_u))
    module.register_buffer("max_u", torch.as_tensor(max_u))


class PolicyDeploy(nn.Module):
    """A deployable actor (the reference's ModelDeploy, convert_model.py:
    10-40): observation normalization and the MLP, plus ``rescale_actions``,
    which maps a [-1, 1] policy output onto the actuator limits
    (convert_model.py:29-33)."""

    def __init__(self, layers: Sequence, activation: str, norm_mean, norm_var,
                 norm_eps: float, normalize_obs: bool, min_u, max_u):
        super().__init__()
        stack = []
        for i, (W, b) in enumerate(layers):
            stack.append(_linear(W, b))
            if i < len(layers) - 1:
                stack.append(_activation_module(activation))
        self.control_stack = nn.ModuleList(stack)
        self.normalize_obs = normalize_obs
        _register_normalizer(self, norm_mean, norm_var, norm_eps, min_u, max_u)

    @torch.jit.export
    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        if self.normalize_obs:
            x = torch.clamp((x - self.norm_mean) / self.norm_std, -5.0, 5.0)
        return x

    @torch.jit.export
    def rescale_actions(self, scaled_command_actions: torch.Tensor) -> torch.Tensor:
        # convert_model.py:29-33: action 0 -> the middle of the range
        return (scaled_command_actions * (self.max_u - self.min_u) / 2.0
                + (self.max_u + self.min_u) / 2.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.normalize(x)
        for l_or_a in self.control_stack:
            x = l_or_a(x)
        return x


class RecurrentPolicyDeploy(nn.Module):
    """A deployable GRU actor: encoder MLP -> GRU cell -> mu head. The hidden
    state is an explicit argument (zero it at episode starts), as
    ``RecurrentPolicy`` / ``NumpyRecurrentPolicy`` reset theirs.

    The cell and the head are written out as ``sim2real.policy.
    RecurrentPolicy`` writes them (torch.nn.GRU's gates r, z, n), so the
    module runs the operations of the policy flown in simulation."""

    def __init__(self, enc_layers: Sequence, activation: str, gru_Wih, gru_Whh, gru_bih,
                 gru_bhh, head_W, head_b, action_dim: int, norm_mean, norm_var,
                 norm_eps: float, normalize_obs: bool, min_u, max_u):
        super().__init__()
        stack = []
        for W, b in enc_layers:
            stack += [_linear(W, b), _activation_module(activation)]
        self.encoder = nn.ModuleList(stack)
        self.hidden_size = int(gru_Whh.shape[1])
        for name, value in (("w_ih", gru_Wih), ("w_hh", gru_Whh), ("b_ih", gru_bih),
                            ("b_hh", gru_bhh), ("head_w", head_W), ("head_b", head_b)):
            self.register_buffer(name, torch.as_tensor(value))
        self.action_dim = int(action_dim)
        self.normalize_obs = normalize_obs
        _register_normalizer(self, norm_mean, norm_var, norm_eps, min_u, max_u)

    @torch.jit.export
    def initial_state(self, batch: int) -> torch.Tensor:
        """Zero hidden states for ``batch`` envs, on the module's device."""
        return torch.zeros(batch, self.hidden_size, device=self.norm_mean.device)

    @torch.jit.export
    def rescale_actions(self, scaled_command_actions: torch.Tensor) -> torch.Tensor:
        return (scaled_command_actions * (self.max_u - self.min_u) / 2.0
                + (self.max_u + self.min_u) / 2.0)

    def forward(self, x: torch.Tensor, h: torch.Tensor):
        if self.normalize_obs:
            x = torch.clamp((x - self.norm_mean) / self.norm_std, -5.0, 5.0)
        for l_or_a in self.encoder:
            x = l_or_a(x)
        H = self.hidden_size
        gi = x @ self.w_ih.T + self.b_ih
        gh = h @ self.w_hh.T + self.b_hh
        r = torch.sigmoid(gi[:, :H] + gh[:, :H])
        z = torch.sigmoid(gi[:, H:2 * H] + gh[:, H:2 * H])
        n = torch.tanh(gi[:, 2 * H:] + r * gh[:, 2 * H:])
        h = (1.0 - z) * n + z * h
        return (h @ self.head_w + self.head_b)[:, :self.action_dim], h


def build_deploy_module(npz_path: str, action_limit_min: Optional[Sequence[float]] = None,
                        action_limit_max: Optional[Sequence[float]] = None,
                        action_dim: Optional[int] = None, device=None) -> nn.Module:
    """The (unscripted) deployment module of a ``.npz`` archive, in eval
    mode on ``device`` (CUDA unless the caller passes 'cpu').

    Takes every layout the runners open: the trainer's MLP and GRU exports,
    imported rl-games archives and imported sample-factory archives, the
    feed-forward ones (an ``enc_W*`` / ``head`` layout without a GRU) and
    mu-only heads (pass ``action_dim`` when the archive lacks the key)."""
    dev = resolve_device(device)
    data = np.load(npz_path, allow_pickle=True)
    # imported sample-factory archives carry no activation (ELU) and no
    # norm_eps (sample-factory's 1e-5)
    activation = str(data["activation"]) if "activation" in data.files else "elu"
    normalize_obs = bool(data["normalize_obs"])
    norm_mean = data["norm_mean"].astype(np.float32)
    norm_var = data["norm_var"].astype(np.float32)
    norm_eps = float(data["norm_eps"]) if "norm_eps" in data.files else 1e-5
    gru_style = "n_enc" in data.files
    recurrent = gru_style and "gru_Wih" in data.files and (
        "recurrent" not in data.files or bool(data["recurrent"]))

    if gru_style:
        enc = [(data[f"enc_W{i}"].astype(np.float32), data[f"enc_b{i}"].astype(np.float32))
               for i in range(int(data["n_enc"]))]
        head_W = data["head_W"].astype(np.float32)
        head_b = data["head_b"].astype(np.float32)
        if "action_dim" in data.files:
            act_dim = int(data["action_dim"])
        elif action_dim is not None:
            act_dim = int(action_dim)
        else:  # [mu, log_std]: mu is the first half
            act_dim = head_W.shape[1] // 2
    else:
        layers = []
        i = 0
        while f"W{i}" in data:
            layers.append((data[f"W{i}"].astype(np.float32), data[f"b{i}"].astype(np.float32)))
            i += 1
        act_dim = layers[-1][0].shape[1]

    if (action_limit_min is None) != (action_limit_max is None):
        raise ValueError("pass both action_limit_min and action_limit_max (or neither for "
                         "the default [-1, 1] pass-through)")
    if action_limit_min is None:
        min_u, max_u = -np.ones(act_dim, np.float32), np.ones(act_dim, np.float32)
    else:
        min_u = np.asarray(action_limit_min, np.float32)
        max_u = np.asarray(action_limit_max, np.float32)

    if recurrent:
        module = RecurrentPolicyDeploy(
            enc, activation, data["gru_Wih"].astype(np.float32),
            data["gru_Whh"].astype(np.float32), data["gru_bih"].astype(np.float32),
            data["gru_bhh"].astype(np.float32), head_W, head_b, act_dim,
            norm_mean, norm_var, norm_eps, normalize_obs, min_u, max_u)
    else:
        if gru_style:
            # a feed-forward sample-factory archive: the encoder MLP straight
            # into the mu head (the identity core of the recurrent runners)
            layers = enc + [(head_W[:, :act_dim], head_b[:act_dim])]
        module = PolicyDeploy(layers, activation, norm_mean, norm_var, norm_eps,
                              normalize_obs, min_u, max_u)
    return module.to(dev).eval()


def convert_model_to_script_model(npz_path: str, out_path: str,
                                  action_limit_min: Optional[Sequence[float]] = None,
                                  action_limit_max: Optional[Sequence[float]] = None,
                                  action_dim: Optional[int] = None) -> str:
    """``.npz`` archive -> scripted ``.pt`` file (the reference's
    convert_model.py:42-62, ``torch.jit.script`` + ``torch.jit.save``),
    saved from the CPU.

    The file runs with nothing but (Lib)Torch: ``m = torch.jit.load(p,
    map_location=dev); a = m(obs)`` (feed-forward) or ``a, h = m(obs, h)``
    (recurrent), with ``m.rescale_actions(a)`` mapping [-1, 1] outputs onto
    the given actuator limits."""
    module = build_deploy_module(npz_path, action_limit_min, action_limit_max, action_dim,
                                 device="cpu")
    torch.jit.save(torch.jit.script(module), out_path)
    return out_path
