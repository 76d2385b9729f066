"""Depth-image VAE: the navigation task's default perception backbone,
its decoder and its training loss.

Counterpart of ``aerial_gym_simulator_tpu/models/vae.py``. The JAX package
has no hand-written kernel here, so the convolutions are
``torch.nn.functional.conv2d`` / ``conv_transpose2d``. Its conventions are
kept so that its checkpoints carry across (``sim/convert.py``): images in
(B, H, W, 1), "SAME" padding as flax computes it (asymmetric for strides
above 1: the low side gets the smaller half), the flatten before the first
dense layer in (h, w, channel) order, transposed convolutions that multiply
the size by the stride and do not flip the kernel, and a final bilinear
resize that antialiases when it shrinks (``jax.image.resize``).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.profiling import spanned


class SameConv2d(nn.Conv2d):
    """Conv2d with flax's "SAME" padding: output size ceil(n / stride)."""

    def forward(self, x):
        pads = []
        for n, k, s in zip(x.shape[:1:-1], self.kernel_size[::-1], self.stride[::-1]):
            total = max((-(-n // s) - 1) * s + k - n, 0)
            pads += [total // 2, total - total // 2]
        return super().forward(F.pad(x, pads))


class Encoder(nn.Module):
    """ResNet8-style conv encoder -> (mean, logvar), logvar clipped to
    +-10. ``input_hw`` fixes the width of the first dense layer."""

    # (out channels, kernel, stride), in the order the JAX module creates them
    CONVS = ((32, 5, 2), (32, 3, 2), (32, 5, 2), (64, 3, 1), (64, 4, 2),
             (64, 5, 2), (128, 3, 2), (128, 5, 4), (128, 5, 2))
    CONV_INPUTS = (1, 32, 32, 32, 32, 64, 64, 64, 128)

    def __init__(self, latent_dim: int = 64, input_hw: Tuple[int, int] = (270, 480)):
        super().__init__()
        self.latent_dim = latent_dim
        self.convs = nn.ModuleList(
            SameConv2d(cin, cout, k, stride=s)
            for cin, (cout, k, s) in zip(self.CONV_INPUTS, self.CONVS))
        h, w = input_hw
        for s in (2, 2, 2, 2, 2, 2):         # x0, x1, block 1, block 2 (x2), x4
            h, w = -(-h // s), -(-w // s)
        self.dense0 = nn.Linear(128 * h * w, 512)
        self.dense1 = nn.Linear(512, 2 * latent_dim)

    def forward(self, x):
        # x: (B, H, W, 1) in [0, 1]
        c, act = self.convs, F.elu
        x = x.permute(0, 3, 1, 2)
        x0 = act(c[0](x))
        x1 = act(c[1](x0))
        x2 = act(c[3](act(c[2](x1))) + c[4](x1))                 # residual block 1
        x3 = act(c[6](act(c[5](x2))) + c[7](x2))                 # residual block 2
        x4 = act(c[8](x3))
        flat = x4.permute(0, 2, 3, 1).flatten(1)                 # (h, w, channel) order
        mean, logvar = self.dense1(act(self.dense0(flat))).chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -10.0, 10.0)


class SameConvTranspose2d(nn.ConvTranspose2d):
    """ConvTranspose2d with flax's "SAME" padding: output = input x stride.

    flax pads the stride-dilated input by (a, k + s - 2 - a) with
    a = k - 1 when s > k - 1, else ceil((k + s - 2) / 2), and correlates
    with the kernel as stored. ``conv_transpose2d`` pads by k - 1 - padding
    on both sides and flips the kernel (the flip is undone where the weights
    are carried across), so the symmetric part goes into ``padding`` and the
    rest is cropped."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int):
        k, s = kernel_size, stride
        pad_a = k - 1 if s > k - 1 else math.ceil((k + s - 2) / 2)
        pad_b = k + s - 2 - pad_a
        crop_lo, crop_hi = k - 1 - pad_a, k - 1 - pad_b
        sym = min(crop_lo, crop_hi)
        super().__init__(in_channels, out_channels, k, stride=s, padding=sym)
        self.crop = (crop_lo - sym, crop_hi - sym)

    def forward(self, x):
        y = super().forward(x)
        lo, hi = self.crop
        return y[..., lo:y.shape[-2] - hi, lo:y.shape[-1] - hi]


@functools.lru_cache(maxsize=None)
def _resize_weights(n_in: int, n_out: int) -> torch.Tensor:
    """(n_out, n_in) weights of ``jax.image.resize(..., "bilinear")`` along
    one axis: a triangle filter at half-pixel centres, widened by the
    shrink factor when n_out < n_in (antialiasing), each row normalised."""
    f32 = torch.float32            # in f32 and in jax's order of operations
    inv_scale = 1.0 / torch.tensor(n_out / n_in, dtype=f32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample = (torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=f32)[None, :]).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=1, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(f32).eps, w / total,
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return w * inside[:, None]


def resize_bilinear(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, C, *out_hw), separable, as ``jax.image.resize``
    does it (two small matrix products)."""
    h, w = x.shape[-2:]
    if (h, w) == tuple(out_hw):
        return x
    wh = _resize_weights(h, out_hw[0]).to(device=x.device, dtype=x.dtype)
    ww = _resize_weights(w, out_hw[1]).to(device=x.device, dtype=x.dtype)
    return torch.matmul(torch.matmul(wh, x), ww.T)


class Decoder(nn.Module):
    """Latent -> depth image in (0, 1), (B, *out_hw, 1): two dense layers,
    five transposed convolutions from a 9 x 15 grid up to 288 x 480, bilinear
    resize to ``out_hw``, sigmoid."""

    GRID = (9, 15)
    # (out channels, kernel, stride), in the order the JAX module creates them
    DECONVS = ((128, 3, 1), (64, 5, 2), (32, 6, 4), (16, 6, 2), (1, 4, 2))
    DECONV_INPUTS = (128, 128, 64, 32, 16)

    def __init__(self, latent_dim: int = 64, out_hw: Tuple[int, int] = (270, 480)):
        super().__init__()
        self.latent_dim = latent_dim
        self.out_hw = tuple(out_hw)
        self.dense0 = nn.Linear(latent_dim, 512)
        self.dense1 = nn.Linear(512, self.GRID[0] * self.GRID[1] * 128)
        self.deconvs = nn.ModuleList(
            SameConvTranspose2d(cin, cout, k, s)
            for cin, (cout, k, s) in zip(self.DECONV_INPUTS, self.DECONVS))

    def forward(self, z):
        x = self.dense1(F.relu(self.dense0(z)))
        x = x.view(-1, *self.GRID, 128).permute(0, 3, 1, 2)      # (h, w, channel) order
        for deconv in self.deconvs[:-1]:
            x = F.relu(deconv(x))
        x = resize_bilinear(self.deconvs[-1](x), self.out_hw)
        return torch.sigmoid(x).permute(0, 2, 3, 1)


def sample_latent(mean, logvar, generator=None, noise=None):
    """mean + exp(0.5 logvar) * eps, eps given or drawn from the generator;
    the mean itself when neither is passed."""
    if noise is None and generator is not None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    if noise is None:
        return mean
    return mean + torch.exp(0.5 * logvar) * noise


class Autoencoder(nn.Module):
    """An encoder and the conv decoder trained together: ``forward(x,
    noise | generator)`` -> (reconstruction, mean, logvar), ``encode``,
    ``decode``. The latent is mean + exp(0.5 logvar) * noise, the noise
    given (standard normal, (B, latent_dim)) or drawn from the generator."""

    def __init__(self, encoder: nn.Module, decoder: Decoder):
        super().__init__()
        self.encoder, self.decoder = encoder, decoder
        self.latent_dim, self.out_hw = decoder.latent_dim, decoder.out_hw

    def forward(self, x, noise=None, generator=None):
        mean, logvar = self.encoder(x)
        if noise is None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
        return self.decoder(mean + torch.exp(0.5 * logvar) * noise), mean, logvar

    def encode(self, x):
        return self.encoder(x)

    def decode(self, z):
        return self.decoder(z)


class DepthVAE(Autoencoder):
    """The conv VAE; images of ``out_hw`` in and out. ``encoder`` and
    ``decoder`` take modules that carry weights already."""

    def __init__(self, latent_dim: int = 64, out_hw: Tuple[int, int] = (270, 480),
                 encoder: Optional[Encoder] = None, decoder: Optional[Decoder] = None):
        super().__init__(Encoder(latent_dim, out_hw) if encoder is None else encoder,
                         Decoder(latent_dim, out_hw) if decoder is None else decoder)


def vae_loss(model: Autoencoder, batch, noise=None, generator=None, kld_beta: float = 3.0,
             targets=None):
    """Reconstruction (binary cross-entropy, 1e-6 inside both logs) plus
    ``kld_beta`` x KL divergence / (H x W) -> (loss, (bce, kld)).
    ``targets`` defaults to the inputs."""
    if targets is None:
        targets = batch
    recon, mean, logvar = model(batch, noise=noise, generator=generator)
    eps = 1e-6
    bce = -torch.mean(targets * torch.log(recon + eps)
                      + (1.0 - targets) * torch.log(1.0 - recon + eps))
    kld = -0.5 * torch.mean(1.0 + logvar - mean ** 2 - torch.exp(logvar))
    return bce + kld_beta * kld / (batch.shape[1] * batch.shape[2]), (bce.detach(), kld.detach())


class FrozenImageEncoder:
    """Inference wrapper around an encoder module with frozen weights:
    resize to the encoder's input, compute in ``compute_dtype``, f32
    latents out. Shared by the conv and the ViT encoder. ``decode`` runs
    the decoder with its f32 master weights; an encoder carried across
    without its decoder cannot decode. ``encode`` is the span ``encode``
    (``utils/profiling.span``)."""

    def __init__(self, encoder: nn.Module, latent_dim: int, input_hw: Tuple[int, int],
                 return_sampled_latent: bool, compute_dtype, device,
                 decoder: Optional[Decoder] = None):
        self.latent_dim = latent_dim
        self.input_hw = tuple(input_hw)
        self.return_sampled_latent = return_sampled_latent
        self.compute_dtype = compute_dtype
        self.device = device
        self.encoder = encoder.to(device=device, dtype=compute_dtype).eval()
        self.decoder = None if decoder is None else decoder.to(device=device).float().eval()

    @torch.no_grad()
    def decode(self, latents):
        """latents (B, latent_dim) -> images (B, H, W, 1) f32."""
        if self.decoder is None:
            raise ValueError("this image encoder was built without a decoder")
        return self.decoder(latents.to(torch.float32))

    @torch.no_grad()
    def encode_moments(self, images):
        """images (B, H, W) or (B, H, W, 1) -> f32 (mean, logvar)."""
        if images.dim() == 3:
            images = images[..., None]
        if tuple(images.shape[1:3]) != self.input_hw:
            images = F.interpolate(images.permute(0, 3, 1, 2), size=self.input_hw,
                                   mode="nearest-exact").permute(0, 2, 3, 1)
        mean, logvar = self.encoder(images.to(self.compute_dtype))
        return mean.float(), logvar.float()

    @spanned("encode")
    def encode(self, images, generator=None, noise=None):
        """-> latents (B, latent_dim) f32: the mean, or a sample when the
        encoder returns sampled latents and a generator (or the standard
        normal ``noise`` itself) is given."""
        mean, logvar = self.encode_moments(images)
        if not self.return_sampled_latent:
            return mean
        return sample_latent(mean, logvar, generator, noise)

    def get_latent_dims_size(self):
        return self.latent_dim


def seeded(seed: int, build):
    """Build a module with its random initial weights drawn from ``seed``,
    leaving the global generator as it was."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


class VAEImageEncoder(FrozenImageEncoder):
    """The conv VAE, frozen. ``encoder`` (and ``decoder``) are modules
    carrying trained weights (``sim/convert.py``); ``encoder=None`` builds
    the whole model with random weights from ``seed``. bf16 compute by
    default for the encoder, f32 for the decoder."""

    def __init__(self, latent_dim: int = 64, image_res: Tuple[int, int] = (270, 480),
                 encoder: Optional[Encoder] = None, return_sampled_latent: bool = True,
                 seed: int = 0, compute_dtype=torch.bfloat16, device=None,
                 decoder: Optional[Decoder] = None):
        self.image_res = tuple(image_res)
        if encoder is None:
            model = seeded(seed, lambda: DepthVAE(latent_dim, self.image_res))
            encoder, decoder = model.encoder, model.decoder
        super().__init__(encoder, latent_dim, self.image_res, return_sampled_latent,
                         compute_dtype, resolve_device(device), decoder=decoder)
