"""Simple effects: grayscale and Reinhard color-palette transfer, ported from
``tbist_tpu.effects.basic``.

Both are device functions over NHWC float images; the effect wrappers keep
the reference's composition contracts (app.py:157-159, 592-658).
"""

from __future__ import annotations

import torch

from tbist_tpu_torch.ops import colorspace


def grayscale(image: torch.Tensor) -> torch.Tensor:
    """PIL convert('L') parity, kept 3-channel for downstream effects."""
    return colorspace.rgb_to_grayscale(image, keep_rgb=True)


def color_palette_transfer(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Transfer color statistics of ``target`` onto ``source`` (both NHWC)."""
    return colorspace.reinhard_color_transfer(source, target.to(source.device))
