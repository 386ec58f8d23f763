"""Resize and crop primitives with explicit sampling semantics, ported from
``tbist_tpu.ops.resize``.

Gather-based, on (..., H, W, C) tensors: cv2 ``INTER_NEAREST`` and the
half-pixel (cv2 ``INTER_LINEAR``, torch default) or ``align_corners=True``
bilinear conventions. The source indices and weights are computed in
float64, as the JAX package computes them with x64 on: the nearest indices
on the tensor's device, the bilinear ones on the host (once per size and
device).
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def _nearest_index(n_out: int, n_in: int, device) -> torch.Tensor:
    # float64 on the tensor's device: the same IEEE operations as numpy's,
    # and no host-to-device copy for the host to wait on
    src = torch.arange(n_out, dtype=torch.float64, device=device) * (n_in / n_out)
    return torch.floor(src).clamp(0, n_in - 1).long()


def resize_nearest(x: torch.Tensor, out_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2 INTER_NEAREST semantics: src index = floor(dst * src/dst), over
    the (-3, -2) axes of an (..., H, W, C) tensor."""
    h_out, w_out = out_hw
    out = torch.index_select(x, -3, _nearest_index(h_out, x.shape[-3], x.device))
    return torch.index_select(out, -2, _nearest_index(w_out, x.shape[-2], x.device))


def _linear_weights(n_out: int, n_in: int, align_corners: bool):
    if align_corners and n_out > 1:
        src = np.arange(n_out) * ((n_in - 1) / (n_out - 1))
    else:  # half-pixel centres (cv2 INTER_LINEAR / torch default)
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    src = np.clip(src, 0.0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    return lo, hi, (src - lo).astype(np.float32)


# the list each thread's ``holding`` block appends to
_HOLDERS = threading.local()


@contextlib.contextmanager
def holding(into: list) -> Iterator[list]:
    """Within the block, append to ``into`` the tensors ``_linear_weights_on``
    hands out in this thread, so that they live as long as ``into`` does
    whatever the cache drops: a captured CUDA graph (the Gatys step's)
    reads them by address."""
    outer = getattr(_HOLDERS, "into", None)
    _HOLDERS.into = into
    try:
        yield into
    finally:
        _HOLDERS.into = outer


@functools.lru_cache(maxsize=64)
def _linear_weights_cached(n_out: int, n_in: int, align_corners: bool, device: torch.device):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _linear_weights(n_out, n_in, align_corners))


def _linear_weights_on(n_out: int, n_in: int, align_corners: bool, device: torch.device):
    """``_linear_weights`` as tensors on ``device``, kept: a copy from the
    host would make the host wait for the card on every call."""
    weights = _linear_weights_cached(n_out, n_in, align_corners, device)
    into = getattr(_HOLDERS, "into", None)
    if into is not None:
        into.append(weights)
    return weights


def resize_bilinear(
    x: torch.Tensor, out_hw: Tuple[int, int], align_corners: bool = False
) -> torch.Tensor:
    """Bilinear resize over the (-3, -2) spatial axes of an (..., H, W, C)
    tensor, computed in float32 and returned in x's dtype. No antialiasing:
    cv2 and ``F.interpolate`` semantics, not ``jax.image.resize``'s."""
    h_out, w_out = out_hw
    xf = x.float()

    def lerp(t, axis, n_out):
        lo, hi, frac = _linear_weights_on(n_out, t.shape[axis], align_corners, t.device)
        a = torch.index_select(t, axis, lo)
        b = torch.index_select(t, axis, hi)
        f = frac.reshape((n_out,) + (1,) * (-axis - 1))
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
