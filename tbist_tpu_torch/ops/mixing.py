"""Two-style feature fusion, ported from ``tbist_tpu.ops.mixing``
(reference multi_style_transfer/StyleMixer.py)."""

from __future__ import annotations

import torch

from tbist_tpu_torch.utils.imageio import image_resize_bilinear


def _midpoint_shape(s1, s2, exact_reference: bool):
    if exact_reference:
        # Reproduces the reference precedence bug `a + b // 2`
        # (StyleMixer.py:31-32) behind a flag, for output-parity checks.
        return tuple(int(a) + int(b) // 2 for a, b in zip(s1, s2))
    return tuple((int(a) + int(b)) // 2 for a, b in zip(s1, s2))


def mix_features(
    feat1: torch.Tensor,
    feat2: torch.Tensor,
    weight2: float,
    exact_reference: bool = False,
) -> torch.Tensor:
    """Bilinear-resize two NHWC feature maps to a midpoint (H, W) and blend.

    ``weight2`` is the weight of ``feat2``; ``feat1`` gets ``1 - weight2``.
    The intended midpoint ``(a + b) // 2`` is the default;
    ``exact_reference=True`` reproduces the reference's ~1.5x shape.
    """
    h, w = _midpoint_shape(feat1.shape[1:3], feat2.shape[1:3], exact_reference)
    f1 = image_resize_bilinear(feat1, (h, w))
    f2 = image_resize_bilinear(feat2, (h, w))
    return (1.0 - weight2) * f1 + weight2 * f2
