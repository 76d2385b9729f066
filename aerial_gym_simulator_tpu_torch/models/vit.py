"""ViT depth encoder (patch embedding, transformer blocks, token mean,
(mean, logvar) latent head) and the autoencoder trained from it.

Counterpart of ``aerial_gym_simulator_tpu/models/vit.py``. Layer
conventions are the JAX package's, so its checkpoints carry across
(``sim/convert.py``): LayerNorm epsilon 1e-6, tanh GELU, images in (B, H, W,
1), tokens in row-major order over the patch grid. ``DepthViT`` pairs the encoder with the conv decoder of
``models/vae.py`` and trains through ``vae_loss``.

``attn_impl`` takes the JAX package's four names, so its checkpoints load
whatever they were trained with. ``"fused"`` is the hand-written kernel
pair (``ops/attention_cuda.fused_attention``; CUDA tensors launch the
forward and, under autograd, the backward kernel or raise, CPU tensors run
the plain versions). ``"flash"`` is the same kernels run in f32, as the JAX
package runs its flash-attention library kernel: q, k and v are cast to f32
and the result back to the input type. ``"xla"`` and ``"reference"`` are
the plain version with the softmax written out
(``ops/attention.attention_reference``, differentiated by autograd). The
projections, the MLP and the patch
embedding are ordinary ``linear`` / ``conv2d`` calls. ``remat``
recomputes each transformer block in the backward
(``torch.utils.checkpoint``) instead of keeping its activations.

Tensor parallelism (JAX ``vit_tp_shardings``, Megatron's layout over the
ranks of a process group): ``vit_tp_shardings`` slices a full encoder's
parameters for one rank, and ``TensorParallelViTEncoder`` runs the encoder
on them. Each rank keeps its heads' slices of q, k and v and runs the
attention (K5 on the card) on those heads only; the output projection is
row-parallel and followed by one ``all_reduce``; ``mlp_in`` is
column-parallel, ``mlp_out`` row-parallel and followed by one
``all_reduce``; everything else is replicated. Inference only.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention_reference
from ..ops.attention_cuda import fused_attention
from ..utils.device import resolve_device
from .vae import Autoencoder, Decoder, FrozenImageEncoder, seeded

ATTN_IMPLS = ("fused", "xla", "flash", "reference")
LAYER_NORM_EPS = 1e-6


class FusedAttention(nn.Module):
    """Self-attention with separate query/key/value/out projections; the
    attention itself runs on the packed (B, S, D) layout."""

    def __init__(self, dim: int, num_heads: int, impl: str = "fused"):
        super().__init__()
        if impl not in ATTN_IMPLS:
            raise ValueError(f"unknown attention impl {impl!r}; known: {ATTN_IMPLS}")
        if dim % num_heads:
            raise ValueError(f"model dim {dim} not divisible by heads {num_heads}")
        self.dim, self.num_heads, self.impl = dim, num_heads, impl
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        q, k, v = self.query(x), self.key(x), self.value(x)
        scale = 1.0 / math.sqrt(self.dim // self.num_heads)
        return self.out(attend(self.impl, q, k, v, self.num_heads, scale))


def attend(impl: str, q, k, v, num_heads: int, scale: float):
    """Multi-head attention on packed (B, S, D) q, k, v by ``impl``."""
    if impl == "fused":
        return fused_attention(q, k, v, num_heads, scale)
    if impl == "flash":
        return fused_attention(q.float(), k.float(), v.float(), num_heads, scale).to(q.dtype)
    return attention_reference(q, k, v, num_heads, scale)


class TransformerBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4,
                 attn_impl: str = "xla"):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = FusedAttention(dim, num_heads, impl=attn_impl)
        self.norm2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp_in = nn.Linear(dim, mlp_ratio * dim)
        self.mlp_out = nn.Linear(mlp_ratio * dim, dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        y = self.mlp_out(F.gelu(self.mlp_in(self.norm2(x)), approximate="tanh"))
        return x + y


class ViTEncoder(nn.Module):
    """Patchify -> transformer -> mean-pool -> (mean, logvar), logvar
    clipped to +-10. ``num_tokens`` is the size of the patch grid the
    position embedding is made for. ``remat`` recomputes each block in the
    backward: the same gradients for one more forward of each block."""

    def __init__(self, latent_dim: int = 64, patch: Tuple[int, int] = (9, 16),
                 dim: int = 128, depth: int = 4, num_heads: int = 4,
                 attn_impl: str = "xla", num_tokens: int = 225, remat: bool = False):
        super().__init__()
        self.latent_dim = latent_dim
        self.patch = tuple(patch)
        self.remat = remat
        self.patch_embed = nn.Conv2d(1, dim, self.patch, stride=self.patch)
        self.pos_embed = nn.Parameter(0.02 * torch.randn(1, num_tokens, dim))
        self.blocks = nn.ModuleList(
            TransformerBlock(dim, num_heads, attn_impl=attn_impl) for _ in range(depth))
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.latent_head = nn.Linear(dim, 2 * latent_dim)

    def forward(self, x):
        # x: (B, H, W, 1) in [0, 1]; H, W multiples of the patch
        x = self.patch_embed(x.permute(0, 3, 1, 2))              # (B, dim, h, w)
        x = x.flatten(2).transpose(1, 2) + self.pos_embed        # (B, h*w, dim)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        x = self.norm(x).mean(dim=1)
        mean, logvar = self.latent_head(x).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -10.0, 10.0)


def vit_input_hw(image_res: Tuple[int, int], patch: Tuple[int, int]) -> Tuple[int, int]:
    """Nearest patch-multiple resolution the encoder consumes."""
    return (max(round(image_res[0] / patch[0]), 1) * patch[0],
            max(round(image_res[1] / patch[1]), 1) * patch[1])


class DepthViT(Autoencoder):
    """ViT encoder + the conv decoder: the same training and inference
    contract as ``DepthVAE``. Inputs are ``out_hw`` images whose sides are
    multiples of the patch. ``encoder`` and ``decoder`` take modules that
    carry weights already (the size arguments are then not read)."""

    def __init__(self, latent_dim: int = 64, out_hw: Tuple[int, int] = (270, 480),
                 patch: Tuple[int, int] = (9, 16), dim: int = 128, depth: int = 4,
                 num_heads: int = 4, attn_impl: str = "xla", remat: bool = False,
                 encoder: Optional[ViTEncoder] = None, decoder: Optional[Decoder] = None):
        if encoder is None:
            tokens = (out_hw[0] // patch[0]) * (out_hw[1] // patch[1])
            encoder = ViTEncoder(latent_dim, patch, dim, depth, num_heads, attn_impl, tokens,
                                 remat)
        super().__init__(encoder, Decoder(latent_dim, out_hw) if decoder is None else decoder)


class ViTImageEncoder(FrozenImageEncoder):
    """The ViT autoencoder, frozen. ``encoder`` (and ``decoder``) are
    modules carrying trained weights (``sim/convert.py``); ``encoder=None``
    builds the whole model with random weights from ``seed``. Images are
    resized to the nearest patch multiple of ``image_res``; bf16 compute by
    default for the encoder, f32 for the decoder."""

    def __init__(self, latent_dim: int = 64, image_res: Tuple[int, int] = (270, 480),
                 encoder: Optional[ViTEncoder] = None, return_sampled_latent: bool = True,
                 seed: int = 0, compute_dtype=torch.bfloat16,
                 patch: Tuple[int, int] = (9, 16), dim: int = 128, depth: int = 4,
                 num_heads: int = 4, attn_impl: str = "xla", device=None,
                 decoder: Optional[Decoder] = None):
        self.image_res = tuple(image_res)
        input_hw = vit_input_hw(image_res, patch)
        if encoder is None:
            # the decoder reconstructs at image_res, as the JAX package's does
            def build():
                enc = ViTEncoder(latent_dim, patch, dim, depth, num_heads, attn_impl,
                                 (input_hw[0] // patch[0]) * (input_hw[1] // patch[1]))
                return enc, Decoder(latent_dim, self.image_res)
            encoder, decoder = seeded(seed, build)
        super().__init__(encoder, latent_dim, input_hw, return_sampled_latent,
                         compute_dtype, resolve_device(device), decoder=decoder)


# -- tensor parallelism --------------------------------------------------------


def vit_tp_shardings(params: dict, rank: int, world: int, num_heads: int) -> dict:
    """A full ``ViTEncoder`` state dict -> rank ``rank``'s of ``world``:
    the q, k, v weights' rows and biases of its ``num_heads // world``
    heads, the output projection's columns of those heads (row-parallel,
    its bias whole), ``mlp_in``'s rows and bias slice (column-parallel),
    ``mlp_out``'s columns (row-parallel, its bias whole); every other
    tensor whole."""
    if num_heads % world:
        raise ValueError(f"{num_heads} heads do not divide over {world} ranks")
    out = {}
    for name, t in params.items():
        parts = name.split(".")
        kind = parts[-2] if len(parts) >= 2 else ""
        if kind in ("query", "key", "value", "mlp_in"):
            n = t.shape[0] // world                         # output rows
            t = t[rank * n:(rank + 1) * n]
        elif kind in ("out", "mlp_out") and parts[-1] == "weight":
            n = t.shape[1] // world                         # contracted columns
            t = t[:, rank * n:(rank + 1) * n]
        out[name] = t.detach().clone()
    return out


class _TPBlock(nn.Module):
    def __init__(self, block: TransformerBlock, params: dict, prefix: str, world: int,
                 group):
        super().__init__()
        self.norm1, self.norm2 = block.norm1, block.norm2
        self.impl, self.group = block.attn.impl, group
        self.num_heads = block.attn.num_heads // world
        self.scale = 1.0 / math.sqrt(block.attn.dim // block.attn.num_heads)
        p = lambda name: nn.Parameter(params[prefix + name], requires_grad=False)
        self.q_w, self.q_b = p("attn.query.weight"), p("attn.query.bias")
        self.k_w, self.k_b = p("attn.key.weight"), p("attn.key.bias")
        self.v_w, self.v_b = p("attn.value.weight"), p("attn.value.bias")
        self.o_w, self.o_b = p("attn.out.weight"), p("attn.out.bias")
        self.in_w, self.in_b = p("mlp_in.weight"), p("mlp_in.bias")
        self.mo_w, self.mo_b = p("mlp_out.weight"), p("mlp_out.bias")

    def _reduced(self, partial):
        import torch.distributed as dist
        dist.all_reduce(partial, group=self.group)
        return partial

    def forward(self, x):
        h = self.norm1(x)
        q, k, v = F.linear(h, self.q_w, self.q_b), F.linear(h, self.k_w, self.k_b), \
            F.linear(h, self.v_w, self.v_b)
        o = attend(self.impl, q, k, v, self.num_heads, self.scale)     # this rank's heads
        x = x + (self._reduced(F.linear(o, self.o_w)) + self.o_b)
        h = F.gelu(F.linear(self.norm2(x), self.in_w, self.in_b), approximate="tanh")
        return x + (self._reduced(F.linear(h, self.mo_w)) + self.mo_b)


class TensorParallelViTEncoder(nn.Module):
    """A ``ViTEncoder`` run tensor-parallel over the ``world`` ranks of
    ``group`` (None: the default group), this process being ``rank``: the
    blocks hold ``vit_tp_shardings``' slices, the patch embedding, position
    embedding, final norm and latent head are the encoder's own
    (replicated). -> the same (mean, logvar) on every rank."""

    def __init__(self, encoder: ViTEncoder, rank: int, world: int, group=None):
        super().__init__()
        num_heads = encoder.blocks[0].attn.num_heads
        params = vit_tp_shardings(encoder.state_dict(), rank, world, num_heads)
        self.patch_embed, self.pos_embed = encoder.patch_embed, encoder.pos_embed
        self.norm, self.latent_head = encoder.norm, encoder.latent_head
        self.blocks = nn.ModuleList(_TPBlock(b, params, f"blocks.{i}.", world, group)
                                    for i, b in enumerate(encoder.blocks))

    @torch.no_grad()
    def forward(self, x):
        x = self.patch_embed(x.permute(0, 3, 1, 2))
        x = x.flatten(2).transpose(1, 2) + self.pos_embed
        for block in self.blocks:
            x = block(x)
        x = self.norm(x).mean(dim=1)
        mean, logvar = self.latent_head(x).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -10.0, 10.0)
