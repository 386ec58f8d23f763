"""Separable Gaussian blur with cv2 semantics, ported from
``tbist_tpu.ops.filters``.

``cv2.GaussianBlur(img, (k, k), 0)`` is a separable 1-D Gaussian with
sigma = 0.3·((k−1)·0.5 − 1) + 0.8 and BORDER_REFLECT_101 borders (mask
feathering, segmentation_style_transfer.py:84; the emoji merge,
emoji_segmentation_style_transfer.py:86).

Each pass is a weighted sum of k shifted slices, one multiply and one add
per tap, in tap order. Those are IEEE operations in a fixed order, so the
card and the CPU compute the same bits, and no convolution engine (nor its
TF32 default) is involved.
"""

from __future__ import annotations

import numpy as np
import torch

# cv2.getGaussianKernel's fixed tables for ksize <= 9 with sigma <= 0
_SMALL_KERNELS = {
    1: [1.0],
    3: [0.25, 0.5, 0.25],
    5: [0.0625, 0.25, 0.375, 0.25, 0.0625],
    7: [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
    9: [0.015625, 0.05078125, 0.1171875, 0.19921875, 0.234375,
        0.19921875, 0.1171875, 0.05078125, 0.015625],
}


def gaussian_kernel_1d(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """cv2.getGaussianKernel semantics as float32 (sigma <= 0 derives sigma
    from ksize; small odd sizes use cv2's fixed tables). An even ksize is
    made odd, as the reference forces (…style_transfer.py:76-78)."""
    if ksize % 2 != 1:
        ksize += 1
    if sigma <= 0 and ksize in _SMALL_KERNELS:
        return np.asarray(_SMALL_KERNELS[ksize], np.float32)
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(xs**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, k: np.ndarray, axis: int) -> torch.Tensor:
    n, pad = x.shape[axis], len(k) // 2
    # reflect-101 indices; np.pad keeps reflecting when pad exceeds the size
    idx = torch.as_tensor(np.pad(np.arange(n), pad, mode="reflect"), device=x.device)
    xp = torch.index_select(x, axis, idx)
    out = xp.narrow(axis, 0, n) * float(k[0])
    for i in range(1, len(k)):
        out = out + xp.narrow(axis, i, n) * float(k[i])
    return out


def gaussian_blur(x: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur of an NHWC tensor with reflect-101 borders."""
    if ksize % 2 != 1:
        ksize += 1
    if ksize <= 1:
        return x
    k = gaussian_kernel_1d(ksize, sigma)
    return _blur_axis(_blur_axis(x, k, 1), k, 2)


def blur_masks(masks: torch.Tensor, ksize: int) -> torch.Tensor:
    """Batched ``blur_mask``: (B, H, W) -> (B, H, W), per frame identical."""
    out = gaussian_blur(masks.float()[..., None], ksize)[..., 0]
    return torch.round(torch.clamp(out, 0.0, 1.0) * 255.0) / 255.0


def blur_mask(mask: torch.Tensor, ksize: int) -> torch.Tensor:
    """Gaussian-feather a 2-D {0,1} mask -> float [0,1] (H, W), rounded to
    8-bit steps as the reference's uint8 round trip does
    (segmentation_style_transfer.py:81-88; emoji merge :85-88)."""
    return blur_masks(mask[None], ksize)[0]
