"""Effect-composition pipeline, ported from ``tbist_tpu.compose.pipeline``.

The JAX package chains seven stages in the reference order (app.py:157-735):
grayscale → text → pixel art → style transfer → style mixing → color
palette → depth. The port runs stage 4 (style transfer) and stage 5 (style
mixing); a request that needs any other stage raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from tbist_tpu_torch.effects import style as style_fx
from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.config import EffectRequest
from tbist_tpu_torch.utils.logging import RunMetrics


@dataclasses.dataclass
class ModelRegistry:
    """Injected models; ``vgg_params`` resolves lazily on ``device``."""

    vgg_params: Any = None
    device: Any = "cuda"
    # fields the lazy loaders resolved (vs caller-injected) — degraded
    # flags only apply to these, so a caller supplying real weights is
    # never reported as degraded by an earlier fallback in this process
    resolved_by_loader: set = dataclasses.field(default_factory=set)

    def ensure(self, *names: str) -> "ModelRegistry":
        """Lazily resolve only the models a request actually needs."""
        for name in names:
            if name != "vgg_params":
                raise NotImplementedError(f"model {name!r} is not ported yet")
            if self.vgg_params is None:
                from tbist_tpu_torch.weights import vgg as vgg_weights

                self.resolved_by_loader.add(name)
                self.vgg_params = vgg_weights.get_params(device=self.device)
        return self


@dataclasses.dataclass
class EffectInputs:
    """Device images the effects consume (style references)."""

    style_image: Optional[torch.Tensor] = None  # style transfer
    style_image1: Optional[torch.Tensor] = None  # mixing
    style_image2: Optional[torch.Tensor] = None


# stage -> the ROADMAP Queue 1 item that ports it
_UNPORTED_STAGES = (
    ("grayscale", lambda r: r.grayscale, "item 11 (effects/basic.py)"),
    ("text", lambda r: r.text is not None, "items 17-24 (text effects)"),
    ("pixel_art", lambda r: r.pixel_art is not None, "item 13 (effects/pixel_art.py)"),
    ("color_palette", lambda r: r.color_palette, "item 11 (effects/basic.py)"),
    ("depth", lambda r: r.depth is not None, "items 25-27 (depth)"),
)


def check_ported(req: EffectRequest) -> None:
    """Raise ``NotImplementedError`` for a stage the port does not run yet."""
    for stage, used, item in _UNPORTED_STAGES:
        if used(req):
            raise NotImplementedError(
                f"the {stage} stage is not ported yet (ROADMAP Queue 1, {item})"
            )


def needed_components(req: EffectRequest) -> list:
    """ModelRegistry fields a request will exercise."""
    return ["vgg_params"] if req.style_transfer or req.style_mixing else []


def apply_image(
    image: torch.Tensor,
    req: EffectRequest,
    inputs: Optional[EffectInputs] = None,
    registry: Optional[ModelRegistry] = None,
    metrics: Optional[RunMetrics] = None,
) -> Optional[torch.Tensor]:
    """Run the effect chain on an NHWC [0,1] image. None on invalid input,
    matching the reference's contract (SURVEY §5 failure handling)."""
    check_ported(req)
    inputs = inputs or EffectInputs()
    registry = registry or ModelRegistry(device=image.device)
    needed = needed_components(req)
    registry.ensure(*needed)
    metrics = metrics if metrics is not None else RunMetrics()
    try:
        return _apply_stages(image, req, inputs, registry, metrics)
    finally:
        flags = degraded.flags_for(n for n in needed if n in registry.resolved_by_loader)
        if flags:
            metrics.degraded = sorted(set(metrics.degraded) | set(flags))


def _apply_stages(
    image: torch.Tensor,
    req: EffectRequest,
    inputs: EffectInputs,
    registry: ModelRegistry,
    metrics: RunMetrics,
) -> Optional[torch.Tensor]:
    """Stages 4 and 5 of the reference order (app.py:372-590)."""
    output = image

    # ---- 4. style transfer (app.py:372-470) ----
    if req.style_transfer:
        if inputs.style_image is None:
            return None
        output = style_fx.style_transfer(
            output, [inputs.style_image], req.gatys, registry.vgg_params,
            metrics=metrics, device=image.device,
        )

    # ---- 5. style mixing (app.py:472-590) ----
    if req.style_mixing:
        styles = [s for s in (inputs.style_image1, inputs.style_image2) if s is not None]
        if not styles:
            return None
        output = style_fx.style_transfer(
            output, styles, req.gatys, registry.vgg_params, metrics=metrics,
            device=image.device,
        )

    return output
