"""Depth-image VAE encoder: the navigation task's default perception
backbone.

Counterpart of ``aerial_gym_simulator_tpu/models/vae.py``, encode side
only (the decoder and the loss come with the training slice). The JAX
package has no hand-written kernel here, so the convolutions are
``torch.nn.functional.conv2d``. Its conventions are kept so that its
checkpoints carry across (``sim/convert.vae_encoder_from_flax``): images
in (B, H, W, 1), "SAME" padding as flax computes it (asymmetric for
strides above 1: the low side gets the smaller half), and the flatten
before the first dense layer in (h, w, channel) order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..utils.device import resolve_device


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


def sample_latent(mean, logvar, generator=None, noise=None):
    """mean + exp(0.5 logvar) * eps, eps given or drawn from the generator;
    the mean itself when neither is passed."""
    if noise is None and generator is not None:
        noise = torch.randn(mean.shape, generator=generator, device=mean.device)
    if noise is None:
        return mean
    return mean + torch.exp(0.5 * logvar) * noise


class FrozenImageEncoder:
    """Inference wrapper around an encoder module with frozen weights:
    resize to the encoder's input, compute in ``compute_dtype``, f32
    latents out. Shared by the conv and the ViT encoder."""

    def __init__(self, encoder: nn.Module, latent_dim: int, input_hw: Tuple[int, int],
                 return_sampled_latent: bool, compute_dtype, device):
        self.latent_dim = latent_dim
        self.input_hw = tuple(input_hw)
        self.return_sampled_latent = return_sampled_latent
        self.compute_dtype = compute_dtype
        self.device = device
        self.encoder = encoder.to(device=device, dtype=compute_dtype).eval()

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
    """The conv VAE's encoder, frozen. ``encoder`` is an Encoder carrying
    trained weights (``sim/convert.load_encoder_pickle``); None builds one
    with random weights from ``seed``. bf16 compute by default."""

    def __init__(self, latent_dim: int = 64, image_res: Tuple[int, int] = (270, 480),
                 encoder: Optional[Encoder] = None, return_sampled_latent: bool = True,
                 seed: int = 0, compute_dtype=torch.bfloat16, device=None):
        self.image_res = tuple(image_res)
        if encoder is None:
            encoder = seeded(seed, lambda: Encoder(latent_dim, self.image_res))
        super().__init__(encoder, latent_dim, self.image_res, return_sampled_latent,
                         compute_dtype, resolve_device(device))
