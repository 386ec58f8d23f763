"""Color-space transforms: Reinhard lαβ transfer and grayscale, ported from
``tbist_tpu.ops.colorspace``.

Reference: color_palette/ColorPaletteTransfer.py (Reinhard et al. 2001) and
the PIL ``convert("L")`` grayscale at app.py:159. Tensors are NHWC in
[0, 1]. The 3×3 color matrices and the luma vector multiply in full f32
(``full_f32``: TF32 off on the card), as the JAX package multiplies them at
``Precision.HIGHEST``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tbist_tpu_torch.utils.imageio import upload
from tbist_tpu_torch.utils.precision import full_f32

# RGB -> LMS (ColorPaletteTransfer.py:15-18)
RGB_TO_LMS = np.array(
    [
        [0.3811, 0.5783, 0.0402],
        [0.1967, 0.7244, 0.0782],
        [0.0241, 0.1288, 0.8444],
    ],
    dtype=np.float32,
)
# log-LMS -> Ruderman lαβ (ColorPaletteTransfer.py:19-22)
LMS_TO_RUDERMAN = np.array(
    [
        [1 / np.sqrt(3), 1 / np.sqrt(3), 1 / np.sqrt(3)],
        [1 / np.sqrt(6), 1 / np.sqrt(6), -2 / np.sqrt(6)],
        [1 / np.sqrt(2), -1 / np.sqrt(2), 0.0],
    ],
    dtype=np.float32,
)
RUDERMAN_TO_LMS = np.linalg.inv(LMS_TO_RUDERMAN).astype(np.float32)
LMS_TO_RGB = np.linalg.inv(RGB_TO_LMS).astype(np.float32)

_LOG_EPS = 1e-5  # ColorPaletteTransfer.py:104

# ITU-R 601-2 luma — PIL Image.convert("L") semantics (app.py:159)
_LUMA = np.array([299.0, 587.0, 114.0], dtype=np.float32) / 1000.0


_MATRICES = {
    "rgb_to_lms": RGB_TO_LMS.T, "lms_to_ruderman": LMS_TO_RUDERMAN.T,
    "ruderman_to_lms": RUDERMAN_TO_LMS.T, "lms_to_rgb": LMS_TO_RGB.T, "luma": _LUMA,
}


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The named constant on ``device``, uploaded once per device and dtype."""
    return upload(np.ascontiguousarray(_MATRICES[name]), device).to(dtype)


def _mm(x: torch.Tensor, name: str) -> torch.Tensor:
    with full_f32():
        return torch.matmul(x, _const(name, x.device, x.dtype))


def rgb_to_ruderman(img: torch.Tensor) -> torch.Tensor:
    """(..., 3) RGB in [~0, 1] -> Ruderman lαβ."""
    return _mm(torch.log(_mm(img, "rgb_to_lms") + _LOG_EPS), "lms_to_ruderman")


def ruderman_to_rgb(lab: torch.Tensor) -> torch.Tensor:
    """Ruderman lαβ -> (..., 3) RGB (un-clamped)."""
    return _mm(torch.exp(_mm(lab, "ruderman_to_lms")), "lms_to_rgb")


def _unbiased_std_mean(x: torch.Tensor, axes, keepdim: bool):
    """torch's ``.std()`` (ddof=1) as the JAX package computes it: the
    population std scaled by sqrt(n / max(n - 1, 1)), so one pixel has std 0."""
    n = int(np.prod([x.shape[a] for a in axes]))
    std, mean = torch.std_mean(x, dim=axes, correction=0, keepdim=keepdim)
    return std * float(np.sqrt(n / max(n - 1, 1))), mean


def reinhard_color_transfer(
    source: torch.Tensor,
    target: torch.Tensor,
    clip_min: float = 1e-6,
    std_floor: float = 1e-5,
) -> torch.Tensor:
    """Transfer the color statistics of ``target`` onto ``source``.

    Both are NHWC RGB in [0, 1] on one device; the result is clamped to
    [0, 1]. Per-channel mean and unbiased std are matched in lαβ space,
    with the source std floored at ``std_floor`` (ColorPaletteTransfer.py:
    60-89). A batched source takes its statistics per image; the target's
    are pooled over all of its pixels, at its own size (no resize).
    """
    src_lab = rgb_to_ruderman(torch.clamp(source, clip_min, 1.0))
    tgt_lab = rgb_to_ruderman(torch.clamp(target, clip_min, 1.0))

    src_axes = tuple(range(1 if src_lab.dim() >= 4 else 0, src_lab.dim() - 1))
    tgt_axes = tuple(range(tgt_lab.dim() - 1))
    src_std, src_mean = _unbiased_std_mean(src_lab, src_axes, keepdim=True)
    tgt_std, tgt_mean = _unbiased_std_mean(tgt_lab, tgt_axes, keepdim=True)
    src_std = torch.where(src_std < std_floor, torch.ones_like(src_std), src_std)

    # the target's std keeps its rank and its mean takes the source's, as
    # in the JAX package (a 4-D target broadcasts a 3-D source to 4-D)
    out_lab = ((src_lab - src_mean) * (tgt_std / src_std)
               + tgt_mean.reshape((1,) * (src_lab.dim() - 1) + (3,)))
    return torch.clamp(ruderman_to_rgb(out_lab), 0.0, 1.0)


def rgb_to_grayscale(img: torch.Tensor, keep_rgb: bool = True) -> torch.Tensor:
    """PIL-parity grayscale. ``keep_rgb`` replicates luma to 3 channels."""
    luma = _mm(img, "luma")[..., None]
    return luma.expand(*luma.shape[:-1], 3).contiguous() if keep_rgb else luma
