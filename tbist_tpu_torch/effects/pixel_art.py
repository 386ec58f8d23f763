"""Pixel art effect (reference components/pixel_art/pixel_art.py), ported
from ``tbist_tpu.effects.pixel_art``.

Optional palette quantization (over a rendered 256-wide palette strip) →
NEAREST down/up pixelation → optional Canny edges from the small image,
NEAREST-upscaled and overlaid black. Every step after the palette runs on
the image's device with no read-back; palettes come from the bundled JSON
(a copy of the JAX package's), from an image via k-means (one read-back),
or from the caller.
"""

from __future__ import annotations

import functools
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from tbist_tpu_torch.ops import canny as canny_ops
from tbist_tpu_torch.ops import palette as palette_ops
from tbist_tpu_torch.ops import resize
from tbist_tpu_torch.utils.config import PixelArtConfig
from tbist_tpu_torch.utils.imageio import upload

_PALETTE_JSON = os.path.join(os.path.dirname(__file__), "data", "palettes.json")
# the luma of the JAX package's edge input, as float32 values
_LUMA = tuple(float(v) for v in np.asarray([0.299, 0.587, 0.114], np.float32))


@functools.lru_cache(maxsize=1)
def load_palette_list():
    """70 hex palettes (5-13 colors each), parity with the reference's 100.json."""
    with open(_PALETTE_JSON) as f:
        return json.load(f)


def hex_to_rgb(hex_color: str) -> Tuple[int, int, int]:
    h = hex_color.lstrip("#")
    return tuple(int(h[i : i + 2], 16) for i in (0, 2, 4))


def get_palette(number: int) -> np.ndarray:
    return np.array([hex_to_rgb(c) for c in load_palette_list()[number]], np.uint8)


def palette_strip(palette: np.ndarray, interpolate: bool = False) -> np.ndarray:
    """(P, 3) palette -> (256, 3) quantizer colors, as the reference builds
    from ``display_palette((1, 256))`` (pixel_art.py:41-44)."""
    return palette_ops.render_palette_strip(palette, (1, 256), interpolate).reshape(-1, 3)


def first_occurrences(colors: np.ndarray) -> np.ndarray:
    """The distinct rows of ``colors`` in the order they first appear. The
    nearest of these is the strip's nearest color with ties to its lowest
    index, over a few colors instead of 256 columns."""
    _, first = np.unique(colors, axis=0, return_index=True)
    return colors[np.sort(first)]


def _luma(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (...) luma, rounded as XLA computes its 3-term dot on the
    CPU: fma(b, B, fma(g, G, r·R)) in float32. Each fused multiply-add is a
    float64 product (exact) and sum, then rounded to float32, so the card
    and the CPU give the same bits."""
    x64 = x.double()
    acc = (x[..., 0] * _LUMA[0]).double()
    acc = (x64[..., 1] * _LUMA[1] + acc).float().double()
    return (x64[..., 2] * _LUMA[2] + acc).float()


def _pixel_art(
    image: torch.Tensor,
    colors: Optional[torch.Tensor],
    pixel_size: float,
    edge_detect: bool,
    edge_threshold: int,
) -> torch.Tensor:
    """image: (B, H, W, 3) float [0,1]; colors: (P, 3) uint8-valued floats,
    or None for no quantization. Per image over the batch (quantization and
    pixelation are per pixel; Canny runs per frame)."""
    h, w = image.shape[1], image.shape[2]
    img = image * 255.0

    if colors is not None:
        img = palette_ops.quantize_to_palette(img, colors)

    ps = max(pixel_size, 0.0001)
    small_h, small_w = max(int(h * ps), 1), max(int(w * ps), 1)
    small = resize.resize_nearest(img, (small_h, small_w))
    big = resize.resize_nearest(small, (h, w))

    if edge_detect:
        low = canny_ops.remap_threshold(edge_threshold)
        gray = _luma(small)
        edges = canny_ops.canny(gray, low, low * 2.0)
        edges_big = resize.resize_nearest(edges[..., None], (h, w))[..., 0]
        big = torch.where(edges_big[..., None] > 0, 0.0, big)

    return torch.clamp(big / 255.0, 0.0, 1.0)


def pixel_art(
    image: torch.Tensor,
    cfg: PixelArtConfig,
    palette: Optional[np.ndarray] = None,
    init_idx: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Apply pixel art to an NHWC image in [0, 1].

    ``palette`` overrides cfg palette selection (e.g. one extracted from an
    image). A palette from the image itself seeds k-means with ``init_idx``,
    or draws it with seed 0 (``ops.palette.draw_init_idx``). The edge-detect
    toggle follows the reference: a 0 slider disables edges even when
    requested (app.py:295-300).
    """
    use_palette = cfg.use_palette or palette is not None
    if use_palette and palette is None:
        if cfg.palette_from_image:
            palette = palette_ops.palette_from_image(
                image[0], cfg.palette_num_colors, init_idx=init_idx
            )
        else:
            palette = get_palette(cfg.palette_number)
    colors = None
    if use_palette:
        strip = palette_strip(np.asarray(palette), cfg.interpolate)
        colors = upload(first_occurrences(strip).astype(np.float32), image.device)

    edge_detect = cfg.edge_detect and cfg.edge_threshold != 0
    return _pixel_art(image, colors, float(cfg.pixel_size), bool(edge_detect),
                      int(cfg.edge_threshold))
