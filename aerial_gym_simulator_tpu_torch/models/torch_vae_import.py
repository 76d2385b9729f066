"""Run the reference framework's torch depth VAE in the navigation stack.

Counterpart of ``aerial_gym_simulator_tpu/models/torch_vae_import.py``.
The reference trains its depth-image VAE in torch (reference
utils/vae/VAE.py: ``ImgEncoder`` / ``ImgDecoder``, a skip-connected conv
encoder to a 64-d latent and a deconv decoder) and ships the classes with
user-trained ``.pth`` weights. ``ImgEncoder`` and ``ImgDecoder`` here have
that exact geometry and its layer names (kernel sizes, strides, asymmetric
paddings, the channel-major flatten), so a reference state dict loads into
them as it is, after ``convert_torch_vae_state_dict`` has taken the
encoder's and the decoder's entries out of it.

The port's own conv VAE (models/vae.py) stays the default; this importer
carries trained reference weights over:

    from aerial_gym_simulator_tpu_torch.models.torch_vae_import import (
        TorchVAEImageEncoder)
    vae = TorchVAEImageEncoder("my_vae_weights.pth")   # a drop-in for
    # VAEImageEncoder: .encode(images, noise=...), .decode(z), latent_dim

or ``NavigationTaskConfig.torch_vae_path`` (``rl.ppo --torch_vae``).
"""

from __future__ import annotations

import logging
from typing import Tuple

import torch
from torch import nn

from ..utils.device import resolve_device
from .vae import FrozenImageEncoder

logger = logging.getLogger(__name__)


class ImgEncoder(nn.Module):
    """The reference's utils/vae/VAE.py ImgEncoder: (B, 1, 270, 480) depth
    -> (B, 2 latent_dim) = [mean, logvar]."""

    def __init__(self, latent_dim: int = 64):
        super().__init__()
        self.conv0 = nn.Conv2d(1, 32, 5, 2, 2)
        self.conv0_1 = nn.Conv2d(32, 32, 3, 2, 2)
        self.conv1_0 = nn.Conv2d(32, 32, 5, 2, 1)
        self.conv1_1 = nn.Conv2d(32, 64, 3, 1, 1)
        self.conv0_jump_2 = nn.Conv2d(32, 64, 4, 2, 1)
        self.conv2_0 = nn.Conv2d(64, 64, 5, 2, 2)
        self.conv2_1 = nn.Conv2d(64, 128, 3, 2, 1)
        self.conv1_jump_3 = nn.Conv2d(64, 128, 5, 4, (2, 1))
        self.conv3_0 = nn.Conv2d(128, 128, 5, 2)
        self.dense0 = nn.Linear(3 * 6 * 128, 512)
        self.dense1 = nn.Linear(512, 2 * latent_dim)
        self.elu = nn.ELU()

    def forward(self, img):
        x0_1 = self.elu(self.conv0_1(self.conv0(img)))
        x1_1 = self.elu(self.conv1_1(self.conv1_0(x0_1)) + self.conv0_jump_2(x0_1))
        x2_1 = self.elu(self.conv2_1(self.conv2_0(x1_1)) + self.conv1_jump_3(x1_1))
        x = self.conv3_0(x2_1).reshape(img.shape[0], -1)      # channel-major flatten
        return self.dense1(self.elu(self.dense0(x)))


class ImgDecoder(nn.Module):
    """The reference's utils/vae/VAE.py ImgDecoder: (B, latent_dim) ->
    (B, 1, 270, 480), through a sigmoid unless ``with_logits``."""

    def __init__(self, latent_dim: int = 64, out_channels: int = 1,
                 with_logits: bool = False):
        super().__init__()
        self.with_logits = with_logits
        self.dense = nn.Linear(latent_dim, 512)
        self.dense1 = nn.Linear(512, 9 * 15 * 128)
        self.deconv1 = nn.ConvTranspose2d(128, 128, 3, 1, 1)
        self.deconv2 = nn.ConvTranspose2d(128, 64, 5, 2, (2, 2), output_padding=(0, 1))
        self.deconv4 = nn.ConvTranspose2d(64, 32, 6, 4, (2, 2), output_padding=(0, 0))
        self.deconv6 = nn.ConvTranspose2d(32, 16, 6, 2, (0, 0), output_padding=(0, 1))
        self.deconv7 = nn.ConvTranspose2d(16, out_channels, 4, 2, 2)

    def forward(self, z):
        x = torch.relu(self.dense(z))
        x = self.dense1(x).view(z.shape[0], 128, 9, 15)
        x = torch.relu(self.deconv1(x))
        x = torch.relu(self.deconv2(x))
        x = torch.relu(self.deconv4(x))
        x = torch.relu(self.deconv6(x))
        x = self.deconv7(x)
        return x if self.with_logits else torch.sigmoid(x)


_ENC_LAYERS = ("conv0", "conv0_1", "conv1_0", "conv1_1", "conv0_jump_2", "conv2_0",
               "conv2_1", "conv1_jump_3", "conv3_0", "dense0", "dense1")
_DEC_LAYERS = ("dense", "dense1", "deconv1", "deconv2", "deconv4", "deconv6", "deconv7")


def convert_torch_vae_state_dict(sd: dict):
    """A reference VAE state dict -> (encoder, decoder) state dicts for
    ``ImgEncoder`` / ``ImgDecoder``.

    Takes the full VAE's dict (keys ``encoder.*`` or ``img_encoder.*`` and
    ``img_decoder.*`` or ``decoder.*``, optionally under ``module.`` or
    ``vae.``, the encoder possibly as ``dronet.*``, as the reference's
    clean_state_dict knows it, vae_image_encoder.py:7-13) or a bare encoder
    or decoder dict."""
    flat = {}
    for k, v in sd.items():
        k = k.replace("module.", "").replace("vae.", "").replace("dronet.", "encoder.")
        flat[k] = v

    def pick(prefixes, layers):
        out = {}
        for name in layers:
            for prefix in prefixes:
                cand = f"{prefix}.{name}" if prefix else name
                if cand + ".weight" in flat:
                    for part in ("weight", "bias"):
                        out[f"{name}.{part}"] = torch.as_tensor(
                            flat[f"{cand}.{part}"]).detach().to(torch.float32).cpu()
                    break
            else:
                raise KeyError(f"{name} not found in state dict (tried prefixes {prefixes})")
        return out

    return (pick(("encoder", "img_encoder", ""), _ENC_LAYERS),
            pick(("img_decoder", "decoder", ""), _DEC_LAYERS))


def load_torch_vae(pth_path: str):
    """A reference VAE ``.pth`` (a state dict, or a checkpoint dict holding
    one under ``state_dict`` or ``model``) -> (encoder, decoder) state
    dicts. Read with ``weights_only=True``: tensors only, no code."""
    blob = torch.load(pth_path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and isinstance(blob.get("state_dict"), dict):
        blob = blob["state_dict"]
    if isinstance(blob, dict) and isinstance(blob.get("model"), dict):
        blob = blob["model"]
    return convert_torch_vae_state_dict(blob)


class _NHWCMoments(nn.Module):
    """ImgEncoder on (B, H, W, 1) images -> (mean, logvar), the encoder
    interface of ``FrozenImageEncoder``."""

    def __init__(self, encoder: ImgEncoder, latent_dim: int):
        super().__init__()
        self.encoder = encoder
        self.latent_dim = latent_dim

    def forward(self, images):
        out = self.encoder(images.permute(0, 3, 1, 2))
        return out[:, :self.latent_dim], out[:, self.latent_dim:]


class _NHWCDecoder(nn.Module):
    def __init__(self, decoder: ImgDecoder):
        super().__init__()
        self.decoder = decoder

    def forward(self, z):
        return self.decoder(z).permute(0, 2, 3, 1)


class TorchVAEImageEncoder(FrozenImageEncoder):
    """A drop-in for ``models.vae.VAEImageEncoder`` backed by imported
    reference weights (the reference's utils/vae/vae_image_encoder.py:
    images resized to the training resolution, the mean or a sampled
    latent). f32 compute by default, on CUDA unless ``device="cpu"``."""

    def __init__(self, pth_path: str, latent_dim: int = 64,
                 image_res: Tuple[int, int] = (270, 480), return_sampled_latent: bool = True,
                 compute_dtype=torch.float32, device=None):
        enc_sd, dec_sd = load_torch_vae(pth_path)
        encoder, decoder = ImgEncoder(latent_dim), ImgDecoder(latent_dim)
        encoder.load_state_dict(enc_sd)
        decoder.load_state_dict(dec_sd)
        self.image_res = tuple(image_res)
        super().__init__(_NHWCMoments(encoder, latent_dim), latent_dim, self.image_res,
                         return_sampled_latent, compute_dtype, resolve_device(device),
                         decoder=_NHWCDecoder(decoder))
        logger.info("imported torch VAE weights from %s", pth_path)
