"""Operations of the navigation step's networks, counted from their shapes:
the ViT depth encoder (patch embedding, per block the q/k/v/out
projections, the two attention products and the MLP, and the latent head)
and the feed-forward policy. A multiply-add counts two operations;
normalisations, softmax and activations are not counted."""

from __future__ import annotations


def vit_flops_per_image(tokens: int, patch_pixels: int, dim: int, depth: int,
                        latent_dim: int, mlp_ratio: int = 4) -> float:
    embed = 2.0 * tokens * patch_pixels * dim
    proj = 4 * 2.0 * tokens * dim * dim
    attn = 2 * 2.0 * tokens * tokens * dim
    mlp = 2 * 2.0 * tokens * dim * mlp_ratio * dim
    head = 2.0 * dim * 2 * latent_dim
    return embed + depth * (proj + attn + mlp) + head


def mlp_flops(widths) -> float:
    """A feed-forward network of layer widths [in, h1, ..., out], per row."""
    return sum(2.0 * a * b for a, b in zip(widths[:-1], widths[1:]))
