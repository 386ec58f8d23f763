"""Public API of the port: ``apply_image`` over ``EffectRequest``
(counterpart of ``tbist_tpu.api``). Host I/O (PIL, file paths) happens
here; everything past this boundary is tensors on ``device``."""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
from PIL import Image

from tbist_tpu_torch.compose.pipeline import EffectInputs, ModelRegistry, apply_image as _apply
from tbist_tpu_torch.utils.config import (  # re-export for users
    ColorPaletteConfig,
    DepthConfig,
    EffectRequest,
    GatysConfig,
    MaskCompositeConfig,
    PixelArtConfig,
    TextEffectConfig,
    VideoConfig,
)
from tbist_tpu_torch.utils.imageio import from_device, load_image, resolve_device, to_device
from tbist_tpu_torch.utils.logging import RunMetrics

ImageLike = Union[str, Image.Image, np.ndarray, torch.Tensor]

__all__ = [
    "EffectRequest", "EffectInputs", "ModelRegistry", "RunMetrics",
    "GatysConfig", "TextEffectConfig", "PixelArtConfig", "ColorPaletteConfig",
    "DepthConfig", "MaskCompositeConfig", "VideoConfig",
    "apply_image", "apply_video",
]


def _as_device(img: Optional[ImageLike], device: torch.device) -> Optional[torch.Tensor]:
    if img is None:
        return None
    if isinstance(img, torch.Tensor):
        img = img.to(device)
        return img if img.dim() == 4 else img[None]
    if isinstance(img, str):
        img = load_image(img)
    return to_device(img, device=device)


def apply_image(
    image: Optional[ImageLike],
    request: EffectRequest,
    style_image: Optional[ImageLike] = None,
    style_image1: Optional[ImageLike] = None,
    style_image2: Optional[ImageLike] = None,
    color_palette_image: Optional[ImageLike] = None,
    pixel_palette_image: Optional[ImageLike] = None,
    registry: Optional[ModelRegistry] = None,
    metrics: Optional[RunMetrics] = None,
    device="cuda",
) -> Optional[Image.Image]:
    """Run the effect chain; returns a PIL image or None on invalid input."""
    device = resolve_device(device)
    x = _as_device(image, device)
    if x is None:
        return None
    inputs = EffectInputs(
        style_image=_as_device(style_image, device),
        style_image1=_as_device(style_image1, device),
        style_image2=_as_device(style_image2, device),
        color_palette_image=_as_device(color_palette_image, device),
        pixel_palette_image=_as_device(pixel_palette_image, device),
    )
    out = _apply(x, request, inputs, registry or ModelRegistry(device=device), metrics)
    if out is None:
        return None
    return from_device(out)


def apply_video(*args, **kwargs):
    """Not ported yet: the video pipeline is ROADMAP Queue 1 slice 7."""
    raise NotImplementedError(
        "apply_video is not ported yet (ROADMAP Queue 1, slice 7: items 28-30)"
    )
