"""Style-transfer losses on NHWC tensors, ported from ``tbist_tpu.ops.losses``.

Semantics match the JAX package (and through it the reference losses,
multi_style_transfer/style_transfer_losses.py:9-225). Feature dicts are
``{layer_name: (B, H, W, C) tensor}``. The Gram matrix always goes through
kernel K1 (``kernels.gram``), whose CPU path is the plain f32 einsum.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

from tbist_tpu_torch.kernels.gram import gram_matrix
from tbist_tpu_torch.ops.mixing import mix_features

Features = Mapping[str, torch.Tensor]

__all__ = [
    "abs_jax", "content_loss", "depth_loss", "edge_loss", "gradient_images", "gram_matrix",
    "normalize", "style_loss", "style_loss_from_targets", "style_targets",
    "to_grayscale", "total_variation_loss",
]


def normalize(img: torch.Tensor, mean, std) -> torch.Tensor:
    """Channel-wise z-normalization of an NHWC image."""
    mean = torch.as_tensor(mean, dtype=img.dtype, device=img.device).reshape(1, 1, 1, -1)
    std = torch.as_tensor(std, dtype=img.dtype, device=img.device).reshape(1, 1, 1, -1)
    return (img - mean) / std


def content_loss(
    input_features: Features,
    content_features: Features,
    content_layers: Sequence[str],
) -> torch.Tensor:
    """Mean-squared error between feature maps, averaged over layers."""
    loss = 0.0
    for layer in content_layers:
        x = input_features[layer].float()
        y = content_features[layer].float()
        loss = loss + torch.mean(torch.square(x - y))
    return loss / len(content_layers)


def style_targets(
    style_features: Sequence[Features],
    style_layers: Sequence[str],
    style_img_weight: float = 0.5,
    exact_reference_mixer: bool = False,
) -> Dict[str, torch.Tensor]:
    """Target Gram per layer: of the one style, or of the two styles' fused
    features (reference StyleMixer.py:25-38). The optimisation loop computes
    these once; the JAX package leaves that hoisting to XLA."""
    targets = {}
    for layer in style_layers:
        if len(style_features) == 1:
            feat = style_features[0][layer]
        else:
            feat = mix_features(
                style_features[0][layer],
                style_features[1][layer],
                style_img_weight,
                exact_reference=exact_reference_mixer,
            )
        targets[layer] = gram_matrix(feat)
    return targets


def style_loss_from_targets(
    input_features: Features,
    targets: Mapping[str, torch.Tensor],
    style_layers: Sequence[str],
) -> torch.Tensor:
    """Gram-MSE against precomputed target Grams, averaged over layers."""
    loss = 0.0
    for layer in style_layers:
        g_in = gram_matrix(input_features[layer])
        loss = loss + torch.mean(torch.square(g_in - targets[layer]))
    return loss / len(style_layers)


def style_loss(
    input_features: Features,
    style_features: Sequence[Features],
    style_layers: Sequence[str],
    style_img_weight: float = 0.5,
    exact_reference_mixer: bool = False,
) -> torch.Tensor:
    """Gram-MSE style loss, averaged over layers, with 2-style mixing."""
    targets = style_targets(
        style_features, style_layers, style_img_weight, exact_reference_mixer
    )
    return style_loss_from_targets(input_features, targets, style_layers)


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with JAX's gradient: +1 at x == 0 (``jnp.abs`` differentiates as
    ``select(x >= 0, g, -g)``), where ``torch.abs`` gives 0. An image with
    flat regions (a MIP layer's masked pixels, pixels clamped to 0 or 1)
    has exact zeros among its TV differences."""
    return torch.where(x >= 0, x, -x)


def total_variation_loss(y: torch.Tensor) -> torch.Tensor:
    """Anisotropic TV normalized by C*H*W."""
    _, h, w, c = y.shape
    dh = torch.sum(abs_jax(y[:, 1:, :, :] - y[:, :-1, :, :]))
    dw = torch.sum(abs_jax(y[:, :, 1:, :] - y[:, :, :-1, :]))
    return (dh + dw) / (c * h * w)


def to_grayscale(img: torch.Tensor) -> torch.Tensor:
    """Channel mean, NHWC -> (B, H, W, 1)."""
    return torch.mean(img, dim=-1, keepdim=True)


def gradient_images(img: torch.Tensor) -> torch.Tensor:
    """Central-difference gradient images of a grayscale NHWC image.

    Output (B, H-2, W-2, 2): channel 0 is d/dx, channel 1 is d/dy.
    """
    dx = img[:, 1:-1, 2:, 0] - img[:, 1:-1, :-2, 0]
    dy = img[:, 2:, 1:-1, 0] - img[:, :-2, 1:-1, 0]
    return torch.stack([dx, dy], dim=-1)


def edge_loss(grad1: torch.Tensor, grad2: torch.Tensor) -> torch.Tensor:
    """Mean of per-axis MSEs between gradient images (B, H, W, 2)."""
    mse_dx = torch.mean(torch.square(grad1[..., 0] - grad2[..., 0]))
    mse_dy = torch.mean(torch.square(grad1[..., 1] - grad2[..., 1]))
    return (mse_dx + mse_dy) / 2.0


def depth_loss(depth_optim: torch.Tensor, depth_target: torch.Tensor) -> torch.Tensor:
    """MSE depth consistency loss."""
    return torch.mean(torch.square(depth_optim - depth_target))
