"""Resize and crop primitives with explicit sampling semantics, ported from
``tbist_tpu.ops.resize``.

Gather-based, on (..., H, W, C) tensors: cv2 ``INTER_NEAREST`` and the
half-pixel (cv2 ``INTER_LINEAR``, torch default) or ``align_corners=True``
bilinear conventions. The source indices and weights are computed on the
host in float64, as the JAX package computes them with x64 on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_NEAREST semantics: src index = floor(dst * src/dst), over
    the (-3, -2) axes of an (..., H, W, C) tensor."""
    h_out, w_out = out_hw
    h_in, w_in = x.shape[-3], x.shape[-2]
    rows = np.clip(np.floor(np.arange(h_out) * (h_in / h_out)), 0, h_in - 1)
    cols = np.clip(np.floor(np.arange(w_out) * (w_in / w_out)), 0, w_in - 1)
    out = torch.index_select(x, -3, torch.as_tensor(rows.astype(np.int64), device=x.device))
    return torch.index_select(out, -2, torch.as_tensor(cols.astype(np.int64), device=x.device))


def _linear_weights(n_out: int, n_in: int, align_corners: bool):
    if align_corners and n_out > 1:
        src = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    else:  # half-pixel centres (cv2 INTER_LINEAR / torch default)
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, (src - lo).astype(np.float32)


def resize_bilinear(
    x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize over the (-3, -2) spatial axes of an (..., H, W, C)
    tensor, computed in float32 and returned in x's dtype. No antialiasing:
    cv2 and ``F.interpolate`` semantics, not ``jax.image.resize``'s."""
    h_out, w_out = out_hw
    xf = x.float()

    def lerp(t, axis, n_out):
        lo, hi, frac = _linear_weights(n_out, t.shape[axis], align_corners)
        a = torch.index_select(t, axis, torch.as_tensor(lo, device=t.device))
        b = torch.index_select(t, axis, torch.as_tensor(hi, device=t.device))
        f = torch.as_tensor(frac, device=t.device).reshape((n_out,) + (1,) * (-axis - 1))
        return a * (1.0 - f) + b * f

    return lerp(lerp(xf, -3, h_out), -2, w_out).to(x.dtype)


def _crop(x: torch.Tensor, th: int, tw: int) -> torch.Tensor:
    top = (x.shape[-3] - th) // 2
    left = (x.shape[-2] - tw) // 2
    return x[..., top : top + th, left : left + tw, :]


def center_crop_to_match(content: torch.Tensor, style: torch.Tensor,
                         mask: Optional[torch.Tensor] = None):
    """Center-crop the larger of two NHWC images to the smaller's size; a
    (H, W) or NHWC mask follows the content image's crop
    (segmentation_style_transfer.py:27-45)."""
    h = min(content.shape[-3], style.shape[-3])
    w = min(content.shape[-2], style.shape[-2])
    content_c, style_c = _crop(content, h, w), _crop(style, h, w)
    if mask is None:
        return content_c, style_c
    m = _crop(mask[..., None], h, w)[..., 0] if mask.dim() == 2 else _crop(mask, h, w)
    return content_c, style_c, m
