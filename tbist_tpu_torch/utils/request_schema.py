"""JSON <-> EffectRequest conversion (serving / config files), a copy of
``tbist_tpu.utils.request_schema`` over the port's own configs."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from tbist_tpu_torch.utils.config import (
    DepthConfig,
    EffectRequest,
    GatysConfig,
    MaskCompositeConfig,
    PixelArtConfig,
    TextEffectConfig,
    VideoConfig,
)

_SUB_CONFIGS = {
    "text": TextEffectConfig,
    "pixel_art": PixelArtConfig,
    "depth": DepthConfig,
    "gatys": GatysConfig,
    "composite": MaskCompositeConfig,
    "video": VideoConfig,
}


def _build(cls, data: Optional[Dict[str, Any]]):
    if data is None:
        return None
    fields = {f.name for f in dataclasses.fields(cls)}
    unknown = set(data) - fields
    if unknown:
        raise ValueError(f"{cls.__name__}: unknown fields {sorted(unknown)}")
    # tuples for tuple-typed defaults (e.g. content_layers)
    proto = cls()
    coerced = {
        k: tuple(v) if isinstance(getattr(proto, k), tuple) and isinstance(v, list) else v
        for k, v in data.items()
    }
    return cls(**coerced)


def request_from_dict(data: Dict[str, Any]) -> EffectRequest:
    """Build an EffectRequest from a plain dict (raises ValueError on
    unknown keys — typos fail loudly instead of silently no-oping)."""
    kwargs: Dict[str, Any] = {}
    for key in ("grayscale", "style_transfer", "style_mixing", "color_palette"):
        if key in data:
            kwargs[key] = bool(data[key])
    for key, cls in _SUB_CONFIGS.items():
        if key in data:
            built = _build(cls, data[key])
            if built is not None:
                kwargs[key] = built
    unknown = set(data) - set(_SUB_CONFIGS) - {
        "grayscale", "style_transfer", "style_mixing", "color_palette",
    }
    if unknown:
        raise ValueError(f"EffectRequest: unknown fields {sorted(unknown)}")
    return EffectRequest(**kwargs)


def request_to_dict(req: EffectRequest) -> Dict[str, Any]:
    return dataclasses.asdict(req)
