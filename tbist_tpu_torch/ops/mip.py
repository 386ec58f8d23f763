"""Multi-plane-image depth binning (reference components/style_transfer_depth/
util.py:9-86), ported from ``tbist_tpu.ops.mip``.

The layer stack is one (N, H, W, C) tensor. Accumulation is in float, so
the reference's ``uint8 +=`` overflow on shared bin-boundary pixels
(util.py:83-85) cannot happen.
"""

from __future__ import annotations

import numpy as np
import torch

from tbist_tpu_torch.utils.imageio import upload


def normalize_depth(depth: torch.Tensor) -> torch.Tensor:
    """Min-max normalize a (H, W) depth map to [0, 1]."""
    dmin, dmax = torch.min(depth), torch.max(depth)
    return (depth - dmin) / torch.clamp(dmax - dmin, min=1e-12)


def create_bins(n: int) -> np.ndarray:
    """(n, 2) array of [min, max] equal-width bin edges (util.py:38-50)."""
    edges = np.linspace(0.0, 1.0, n + 1)
    return np.stack([edges[:-1], edges[1:]], axis=1)


def bin_masks(depth: torch.Tensor, n: int) -> torch.Tensor:
    """(n, H, W) float masks; mask i is 1 where depth falls in bin i.

    Bin edges are inclusive on both sides (reference mask_image_depth,
    util.py:31), so boundary pixels belong to two bins — reconstruction
    clips instead of overflowing. The edges compare in the depth's dtype.
    """
    d = normalize_depth(depth)
    bins = upload(create_bins(n), d.device).to(d.dtype)
    lo, hi = bins[:, 0, None, None], bins[:, 1, None, None]
    return ((d[None] >= lo) & (d[None] <= hi)).float()


def generate_layers(image: torch.Tensor, depth: torch.Tensor, n: int) -> torch.Tensor:
    """NHWC image + (H, W) depth -> (n, H, W, C) depth-masked layer images."""
    masks = bin_masks(depth, n)  # (n, H, W)
    img = image[0] if image.dim() == 4 else image
    return img[None] * masks[..., None]


def reconstruct(stylized_layers: torch.Tensor, depth: torch.Tensor, n: int) -> torch.Tensor:
    """Re-mask stylized layers by their bins and sum -> (H, W, C) in [0, 1]."""
    masks = bin_masks(depth, n)
    acc = torch.sum(stylized_layers * masks[..., None], dim=0)
    return torch.clamp(acc, 0.0, 1.0)
