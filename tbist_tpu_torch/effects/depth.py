"""Depth-based style transfer, ported from ``tbist_tpu.effects.depth``.

Only the smoothed-luminance pseudo-depth is ported so far: the MIP and
depth-loss effects and ``default_depth_estimator`` come with ROADMAP
Queue 1 items 25-27.
"""

from __future__ import annotations

import torch

from tbist_tpu_torch.ops import mip as mip_ops
from tbist_tpu_torch.ops.filters import gaussian_blur


def _fallback_depth(image: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-depth (smoothed luminance) when no Depth-Anything
    weights exist. Shape (H, W) float in [0, 1]."""
    img = image if image.dim() == 4 else image[None]
    luma = torch.mean(img, dim=-1, keepdim=True)
    smooth = gaussian_blur(luma, 31)[0, ..., 0]
    return mip_ops.normalize_depth(smooth)
