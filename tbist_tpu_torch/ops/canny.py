"""Canny edge detection (cv2-compatible semantics), ported from
``tbist_tpu.ops.canny``.

Reference: components/pixel_art/util.py:34-47 calls ``cv2.Canny`` with
L1-gradient / aperture-3 defaults on the grayscale of the pixelated image.

Sobel-3 gradients with reflect-101 borders, 4-sector non-maximum
suppression, double thresholding, and hysteresis as 3×3 dilation of strong
edges through weak pixels. The Sobel sums are shifted products added in a
fixed order, XLA's, so the card, the CPU and the JAX package compute the
same bits (no convolution engine, no TF32): the suppression compares
neighbours that tie exactly where a palette made flat regions, and a
one-ulp difference would decide such a tie. The JAX package loops the
hysteresis to its fixpoint or 64 rounds; a round past the fixpoint changes
nothing, so here it runs 64 rounds with no read-back. Every function takes
a batch of (B, H, W) frames and treats each on its own.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_TG22 = 0.4142135623730951
_TG67 = 2.414213562373095


def _reflect101(x: torch.Tensor) -> torch.Tensor:
    """Pad the last two axes by one with cv2 BORDER_REFLECT_101 (numpy
    ``reflect``), by index so that a side of length 1 works as in numpy
    (it repeats). The indices are made on the tensor's device."""
    for axis in (-2, -1):
        n = x.shape[axis]
        i = torch.arange(-1, n + 1, device=x.device).abs()
        x = torch.index_select(x, axis, torch.minimum(i, 2 * (n - 1) - i).clamp_min(0))
    return x


# the JAX package's Sobel weights (cross-correlation, row-major)
SOBEL_X = ((-1.0, 0.0, 1.0), (-2.0, 0.0, 2.0), (-1.0, 0.0, 1.0))
SOBEL_Y = ((-1.0, -2.0, -1.0), (0.0, 0.0, 0.0), (1.0, 2.0, 1.0))


def _correlate3(p: torch.Tensor, kernel) -> torch.Tensor:
    """3x3 correlation of a padded (B, H+2, W+2) map. The nine products t_k
    (k = 3·dy + dx) are added in the order XLA's CPU convolution adds them:
    ((t0 + t1) + (t4 + t5)) + ((t2 + t3) + (t6 + t7)), then t8. Products by
    the Sobel weights (0, ±1, ±2) are exact, so this gives the JAX
    package's bits on the CPU, and the same bits on the card."""
    h, w = p.shape[-2] - 2, p.shape[-1] - 2
    t = [p[..., dy : dy + h, dx : dx + w] * kernel[dy][dx] for dy in range(3) for dx in range(3)]
    return (((t[0] + t[1]) + (t[4] + t[5])) + ((t[2] + t[3]) + (t[6] + t[7]))) + t[8]


def sobel(gray: torch.Tensor):
    """(B, H, W) -> (gx, gy), reflect-101 borders (cv2 BORDER_REFLECT_101)."""
    p = _reflect101(gray.float())
    return _correlate3(p, SOBEL_X), _correlate3(p, SOBEL_Y)


def dilate3(mask: torch.Tensor) -> torch.Tensor:
    """3x3 max over (B, H, W). ``F.max_pool2d`` pads with -inf where the JAX
    package's ``reduce_window`` pads with 0; the two agree because every
    value it is given is >= 0."""
    return F.max_pool2d(mask[:, None], 3, stride=1, padding=1)[:, 0]


def canny(
    gray: torch.Tensor,
    low_threshold: float,
    high_threshold: float,
    hysteresis_rounds: int = 64,
) -> torch.Tensor:
    """(B, H, W) grayscale in [0, 255] -> float {0, 1} edge maps.

    L1 gradient magnitude (cv2 default ``L2gradient=False``).
    """
    gx, gy = sobel(gray)
    ax, ay = torch.abs(gx), torch.abs(gy)
    mag = ax + ay

    # --- non-maximum suppression over 4 quantized directions ---
    horiz = ay < _TG22 * ax  # gradient mostly horizontal -> compare L/R
    vert = ay > _TG67 * ax  # mostly vertical -> compare U/D
    diag_main = ~horiz & ~vert & (torch.sign(gx) == torch.sign(gy))
    mp = F.pad(mag, (1, 1, 1, 1))  # zeros
    c = mp[..., 1:-1, 1:-1]
    left, right = mp[..., 1:-1, :-2], mp[..., 1:-1, 2:]
    up, down = mp[..., :-2, 1:-1], mp[..., 2:, 1:-1]
    ul, lr = mp[..., :-2, :-2], mp[..., 2:, 2:]
    ur, ll = mp[..., :-2, 2:], mp[..., 2:, :-2]

    keep_h = (c > left) & (c >= right)
    keep_v = (c > up) & (c >= down)
    keep_d1 = (c > ul) & (c >= lr)  # 135° sector (same-signed gx, gy)
    keep_d2 = (c > ur) & (c >= ll)  # 45° sector
    keep = torch.where(horiz, keep_h,
                       torch.where(vert, keep_v, torch.where(diag_main, keep_d1, keep_d2)))
    nms = torch.where(keep, mag, torch.zeros_like(mag))

    strong = (nms > high_threshold).float()
    weak = (nms > low_threshold).float()

    # --- hysteresis: propagate strong through weak ---
    edges = strong
    for _ in range(hysteresis_rounds):
        edges = torch.maximum(torch.minimum(dilate3(edges), weak), strong)
    return edges


def remap_threshold(value: float) -> float:
    """Edge slider 0-100 -> Canny low threshold 300-1.

    Intended behavior of components/pixel_art/util.py:63-83 ``re_map`` —
    a decreasing linear map clamped to [1, 300].
    """
    re = (value - 0.0) * (1.0 - 300.0) / (100.0 - 0.0) + 300.0
    return float(min(max(re, 1.0), 300.0))
