"""Effect-composition pipeline, ported from ``tbist_tpu.compose.pipeline``.

The JAX package chains seven stages in the reference order (app.py:157-735):
grayscale → text → pixel art → style transfer → style mixing → color
palette → depth, where each heavyweight effect repeats a 3-way text-mask
dispatch (``_masked_apply``). The port runs the text stage's location mode
(a GroundingDINO+SAM mask, or its fallback), stage 4 (style transfer) and
stage 5 (style mixing), each of the last two under the location mask when
there is one. A request that needs any other stage raises
``NotImplementedError`` naming the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from tbist_tpu_torch.effects import style as style_fx
from tbist_tpu_torch.ops import masks as mask_ops
from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.config import EffectRequest, TextEffectConfig
from tbist_tpu_torch.utils.logging import RunMetrics


@dataclasses.dataclass
class ModelRegistry:
    """Injected models; each resolves lazily on ``device`` when not given."""

    vgg_params: Any = None
    device: Any = "cuda"
    # (image, prompt) -> (H, W) bool mask. The image is NHWC float [0, 1] on
    # the device, or (H, W, 3) uint8 on the host when the mask preprocess ran
    # (effects.masking.extract_location_mask); extractors take both
    mask_extractor: Optional[Callable] = None
    # (frames (B, H, W, 3) uint8, prompt) -> (B, H, W) bool masks: one DINO
    # and one SAM encoder call per chunk (the masked video lane's extractor)
    batch_mask_extractor: Optional[Callable] = None
    # fields the lazy loaders resolved (vs caller-injected) — degraded
    # flags only apply to these, so a caller supplying real weights is
    # never reported as degraded by an earlier fallback in this process
    resolved_by_loader: set = dataclasses.field(default_factory=set)

    def ensure(self, *names: str) -> "ModelRegistry":
        """Lazily resolve only the models a request actually needs."""
        for name in names:
            if name not in ("vgg_params", "mask_extractor", "batch_mask_extractor"):
                raise NotImplementedError(f"model {name!r} is not ported yet")
            if getattr(self, name) is not None:
                continue
            self.resolved_by_loader.add(name)
            if name == "vgg_params":
                from tbist_tpu_torch.weights import vgg as vgg_weights

                self.vgg_params = vgg_weights.get_params(device=self.device)
            elif name == "mask_extractor":
                from tbist_tpu_torch.effects import masking

                self.mask_extractor = masking.default_mask_extractor(self.device)
            else:
                from tbist_tpu_torch.effects import masking

                self.batch_mask_extractor = masking.default_batch_mask_extractor(self.device)
        return self


@dataclasses.dataclass
class EffectInputs:
    """Device images the effects consume (style references)."""

    style_image: Optional[torch.Tensor] = None  # style transfer
    style_image1: Optional[torch.Tensor] = None  # mixing
    style_image2: Optional[torch.Tensor] = None


@dataclasses.dataclass
class _TextState:
    """Masks computed once by the text stage and reused downstream."""

    loc_mask: Optional[torch.Tensor] = None  # (H, W) bool
    mode: str = "none"  # none|transfer|location|texture|location+texture


def _text_mode(cfg: Optional[TextEffectConfig]) -> str:
    if cfg is None:
        return "none"
    if cfg.style_prompt:
        return "transfer"
    if cfg.location_prompt and cfg.texture_prompt:
        return "location+texture"
    if cfg.location_prompt:
        return "location"
    if cfg.texture_prompt:
        return "texture"
    return "none"


def _masked_apply(effect_fn: Callable[[torch.Tensor], torch.Tensor], original: torch.Tensor,
                  current: torch.Tensor, state: _TextState, req: EffectRequest) -> torch.Tensor:
    """The text-mask dispatch around a downstream effect: under a location
    mask the effect runs on the ORIGINAL image and is composited by the
    mask; otherwise it runs on the running output. The texture modes'
    ``emoji_composite`` branches come with item 24 (``check_ported`` refuses
    a texture prompt until then)."""
    if state.mode == "location":
        styled = effect_fn(original)
        return mask_ops.composite_by_mask(original, styled, state.loc_mask,
                                          int(req.composite.edge_smoothing))
    return effect_fn(current)


# stage -> the ROADMAP Queue 1 item that ports it
_UNPORTED_STAGES = (
    ("grayscale", lambda r: r.grayscale, "item 11 (effects/basic.py)"),
    ("text style", lambda r: r.text is not None and bool(r.text.style_prompt),
     "items 17-19 (feed-forward text style)"),
    ("text texture", lambda r: r.text is not None and bool(r.text.texture_prompt),
     "item 24 (T5 emoji texture)"),
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
    needed = ["vgg_params"] if req.style_transfer or req.style_mixing else []
    if req.text is not None and req.text.location_prompt:
        needed.append("mask_extractor")
    return needed


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
    """The text stage's location mode, then stages 4 and 5 of the reference
    order (app.py:161-282, 372-590)."""
    original = image
    output = image
    state = _TextState(mode=_text_mode(req.text))

    # ---- 2. text effects (app.py:161-282): the location mode ----
    if state.mode == "location":
        from tbist_tpu_torch.effects import masking

        state.loc_mask = masking.extract_location_mask(registry.mask_extractor, original,
                                                       req.text)
        m = state.loc_mask.float()  # the mask visualisation
        output = m[None, ..., None].expand(1, *m.shape, 3)

    # ---- 4. style transfer (app.py:372-470) ----
    if req.style_transfer:
        if inputs.style_image is None:
            return None
        output = _masked_apply(
            lambda img: style_fx.style_transfer(img, [inputs.style_image], req.gatys,
                                                registry.vgg_params, metrics=metrics,
                                                device=image.device),
            original, output, state, req)

    # ---- 5. style mixing (app.py:472-590) ----
    if req.style_mixing:
        styles = [s for s in (inputs.style_image1, inputs.style_image2) if s is not None]
        if not styles:
            return None
        output = _masked_apply(
            lambda img: style_fx.style_transfer(img, styles, req.gatys, registry.vgg_params,
                                                metrics=metrics, device=image.device),
            original, output, state, req)

    return output
