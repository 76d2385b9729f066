"""Plain references of the navigation policy's networks: the ViT depth
encoder (patch embedding, pre-norm transformer blocks with tanh-GELU MLPs,
token mean, (mean, logvar) head) and the feed-forward actor.

Written from the layer conventions that the port's ``models/vit.py``
(``ViTEncoder``, ``TransformerBlock``: lines 90-140; LayerNorm epsilon
1e-6) and ``sim2real/policy.py`` (``MLPPolicy``: lines 35-75) follow, in
float32 with the softmax written out, reading the shipped files themselves:
the flax parameter pickle and the policy archive. The encoder resizes an
image to its patch grid as ``models/vae.FrozenImageEncoder.encode_moments``
does (nearest-exact). Imports nothing of the port.

``quant`` selects the control's arithmetic: None is float32 (TF32 off);
"bf16" rounds every product's operands to bfloat16; "fp8" rounds them to
float8 e4m3 with one scale per tensor (the largest magnitude to 448).
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import torch
import torch.nn.functional as F

LAYER_NORM_EPS = 1e-6
FP8_MAX = 448.0


def round_operand(x, quant):
    if quant is None:
        return x
    if quant == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if quant == "fp8":
        scale = torch.clamp(x.abs().amax(), min=1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    raise ValueError(f"unknown quant {quant!r}")


def linear(x, w, b, quant):
    """x (..., in) @ w (in, out) + b."""
    return round_operand(x, quant) @ round_operand(w, quant) + b


class ViTReference:
    """The encoder of a flax ViT pickle ({"arch": "vit", "params": ...})."""

    def __init__(self, path: str, device):
        with open(path, "rb") as f:
            blob = pickle.load(f)
        if not (isinstance(blob, dict) and blob.get("arch") == "vit"):
            raise ValueError(f"{path} is not a ViT encoder pickle")
        p = blob["params"]
        for key in ("params", "encoder"):
            p = p.get(key, p)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        ph, pw, _, dim = np.shape(p["patch_embed"]["kernel"])
        self.patch, self.dim = (ph, pw), dim
        self.heads = np.shape(p["block_0"]["attn"]["query"]["kernel"])[1]
        self.patch_w = t(p["patch_embed"]["kernel"]).reshape(ph * pw, dim)   # (kh*kw*1, dim)
        self.patch_b = t(p["patch_embed"]["bias"])
        self.pos = t(p["pos_embed"])[0]                                        # (S, dim)
        self.blocks = []
        for i in range(sum(1 for k in p if k.startswith("block_"))):
            b = p[f"block_{i}"]
            dense = lambda leaf, n_in: (t(leaf["kernel"]).reshape(n_in, -1),
                                        t(leaf["bias"]).reshape(-1))
            self.blocks.append(dict(
                ln1=(t(b["LayerNorm_0"]["scale"]), t(b["LayerNorm_0"]["bias"])),
                ln2=(t(b["LayerNorm_1"]["scale"]), t(b["LayerNorm_1"]["bias"])),
                q=dense(b["attn"]["query"], dim), k=dense(b["attn"]["key"], dim),
                v=dense(b["attn"]["value"], dim), o=dense(b["attn"]["out"], dim),
                mlp_in=dense(b["mlp_in"], dim), mlp_out=dense(b["mlp_out"], 4 * dim)))
        self.ln = (t(p["LayerNorm_0"]["scale"]), t(p["LayerNorm_0"]["bias"]))
        self.head = (t(p["latent_head"]["kernel"]), t(p["latent_head"]["bias"]))
        self.tokens = self.pos.shape[0]

    def input_hw(self, image_hw):
        ph, pw = self.patch
        return (max(round(image_hw[0] / ph), 1) * ph, max(round(image_hw[1] / pw), 1) * pw)

    def moments(self, images, quant=None, image_hw=None):
        """images (B, H, W) -> (mean, logvar) (B, latent) float32.
        ``image_hw`` is the camera's size the encoder was built for (the
        image's own by default)."""
        x = images.to(torch.float32)[:, None]
        hw = self.input_hw(image_hw or tuple(x.shape[2:]))
        if tuple(x.shape[2:]) != hw:
            x = F.interpolate(x, size=hw, mode="nearest-exact")
        ph, pw = self.patch
        B = x.shape[0]
        patches = (x.reshape(B, hw[0] // ph, ph, hw[1] // pw, pw)
                   .permute(0, 1, 3, 2, 4).reshape(B, -1, ph * pw))             # row-major tokens
        h = linear(patches, self.patch_w, self.patch_b, quant) + self.pos
        hd = self.dim // self.heads
        for blk in self.blocks:
            y = F.layer_norm(h, (self.dim,), *blk["ln1"], eps=LAYER_NORM_EPS)
            q, k, v = (linear(y, *blk[n], quant).reshape(B, -1, self.heads, hd).transpose(1, 2)
                       for n in ("q", "k", "v"))
            s = round_operand(q, quant) @ round_operand(k, quant).transpose(-2, -1)
            a = torch.softmax(s / math.sqrt(hd), dim=-1)
            o = (round_operand(a, quant) @ round_operand(v, quant)).transpose(1, 2).reshape(
                B, -1, self.dim)
            h = h + linear(o, *blk["o"], quant)
            y = F.layer_norm(h, (self.dim,), *blk["ln2"], eps=LAYER_NORM_EPS)
            y = F.gelu(linear(y, *blk["mlp_in"], quant), approximate="tanh")
            h = h + linear(y, *blk["mlp_out"], quant)
        h = F.layer_norm(h, (self.dim,), *self.ln, eps=LAYER_NORM_EPS).mean(dim=1)
        mean, logvar = linear(h, *self.head, quant).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -10.0, 10.0)


_ACT = {"elu": F.elu, "tanh": torch.tanh, "relu": F.relu}


class PolicyReference:
    """The feed-forward actor of an exported policy archive: observation
    normalised and clipped to +-5, hidden layers, linear head -> the action
    mean."""

    def __init__(self, path: str, device):
        arc = np.load(path)
        t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
        self.act = _ACT[str(arc["activation"])]
        self.normalize = bool(arc["normalize_obs"])
        eps = float(arc["norm_eps"]) if "norm_eps" in arc.files else 1e-8
        self.mean = t(arc["norm_mean"])
        self.std = torch.sqrt(t(arc["norm_var"]) + eps)
        self.layers = []
        i = 0
        while f"W{i}" in arc.files:
            self.layers.append((t(arc[f"W{i}"]), t(arc[f"b{i}"])))
            i += 1

    def __call__(self, obs, quant=None):
        x = obs.to(torch.float32)
        if self.normalize:
            x = torch.clamp((x - self.mean) / self.std, -5.0, 5.0)
        for w, b in self.layers[:-1]:
            x = self.act(linear(x, w, b, quant))
        return linear(x, *self.layers[-1], quant)
