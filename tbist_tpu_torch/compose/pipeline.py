"""Effect-composition pipeline, ported from ``tbist_tpu.compose.pipeline``.

The JAX package chains seven stages in the reference order (app.py:157-735):
grayscale → text → pixel art → style transfer → style mixing → color
palette → depth, where each heavyweight effect repeats a 3-way text-mask
dispatch (``_masked_apply``). The port runs all seven: grayscale; the text
stage in all its modes (the feed-forward text style, a GroundingDINO+SAM
location mask or its fallback, an emoji texture stencil, and their
composites); pixel art; style transfer and mixing; color palette; depth
(MIP or the depth loss); stages 3-7 under the text masks when there are
some.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from tbist_tpu_torch.effects import basic
from tbist_tpu_torch.effects import pixel_art as pixel_art_fx
from tbist_tpu_torch.effects import style as style_fx
from tbist_tpu_torch.ops import masks as mask_ops
from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.config import EffectRequest, TextEffectConfig
from tbist_tpu_torch.utils.imageio import upload
from tbist_tpu_torch.utils.logging import RunMetrics


@dataclasses.dataclass
class ModelRegistry:
    """Injected models; each resolves lazily on ``device`` when not given."""

    vgg_params: Any = None
    device: Any = "cuda"
    # (image NHWC on the device, prompt) -> stylized NHWC
    text_transfer: Optional[Callable] = None
    # (image, prompt) -> (H, W) bool mask. The image is NHWC float [0, 1] on
    # the device, or (H, W, 3) uint8 on the host when the mask preprocess ran
    # (effects.masking.extract_location_mask); extractors take both
    mask_extractor: Optional[Callable] = None
    # (frames (B, H, W, 3) uint8, prompt) -> (B, H, W) bool masks: one DINO
    # and one SAM encoder call per chunk (the masked video lane's extractor)
    batch_mask_extractor: Optional[Callable] = None
    # (prompt) -> (He, We) bool stencil, anywhere (the pipeline moves it)
    emoji_extractor: Optional[Callable] = None
    # (image NHWC on the device) -> (H, W) float depth
    depth_estimator: Optional[Callable] = None
    # fields the lazy loaders resolved (vs caller-injected) — degraded
    # flags only apply to these, so a caller supplying real weights is
    # never reported as degraded by an earlier fallback in this process
    resolved_by_loader: set = dataclasses.field(default_factory=set)

    def ensure(self, *names: str) -> "ModelRegistry":
        """Lazily resolve only the models a request actually needs."""
        for name in names:
            if getattr(self, name) is not None:
                continue
            self.resolved_by_loader.add(name)
            if name == "vgg_params":
                from tbist_tpu_torch.weights import vgg as vgg_weights

                self.vgg_params = vgg_weights.get_params(device=self.device)
            elif name == "text_transfer":
                from tbist_tpu_torch.effects import text_transfer as tt

                self.text_transfer = tt.perform_transfer
            elif name == "depth_estimator":
                from tbist_tpu_torch.effects import depth as depth_fx

                self.depth_estimator = depth_fx.default_depth_estimator(self.device)
            else:
                from tbist_tpu_torch.effects import masking

                loader = getattr(masking, f"default_{name}")
                setattr(self, name, loader(self.device))
        return self


@dataclasses.dataclass
class EffectInputs:
    """Device images the effects consume (style references)."""

    style_image: Optional[torch.Tensor] = None  # style transfer and depth
    style_image1: Optional[torch.Tensor] = None  # mixing
    style_image2: Optional[torch.Tensor] = None
    color_palette_image: Optional[torch.Tensor] = None  # Reinhard target
    pixel_palette_image: Optional[torch.Tensor] = None  # k-means palette source


@dataclasses.dataclass
class _TextState:
    """Masks computed once by the text stage and reused downstream."""

    loc_mask: Optional[torch.Tensor] = None  # (H, W) bool
    emoji_mask: Optional[torch.Tensor] = None  # (He, We) bool
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
    or texture mask the effect runs on the ORIGINAL image and is composited
    by the mask (``composite_by_mask`` for a location, ``emoji_composite``
    for a texture, over the whole frame without a location); otherwise it
    runs on the running output."""
    comp = req.composite
    if state.mode == "location":
        styled = effect_fn(original)
        return mask_ops.composite_by_mask(original, styled, state.loc_mask,
                                          int(comp.edge_smoothing))
    if state.mode in ("texture", "location+texture"):
        return _texture_composite(original, effect_fn(original), state, comp.blur_strength,
                                  comp.step_size_multiplier, comp.style_strength)
    return effect_fn(current)


def _texture_composite(original: torch.Tensor, styled: torch.Tensor, state: _TextState,
                       blur: int, step: float, strength: float) -> torch.Tensor:
    """``emoji_composite`` through the stencil, inside the location mask when
    there is one and over the whole frame otherwise."""
    seg = state.loc_mask
    if seg is None:
        seg = torch.ones(styled.shape[1:3], dtype=torch.bool, device=styled.device)
    return mask_ops.emoji_composite(original, styled, seg, state.emoji_mask, blur, step,
                                    strength)


def _visualize(mask: torch.Tensor) -> torch.Tensor:
    """(H, W) mask -> the (1, H, W, 3) f32 image the reference shows."""
    m = mask.float()
    return m[None, ..., None].expand(1, *m.shape, 3)


def needed_components(req: EffectRequest) -> list:
    """ModelRegistry fields a request will exercise."""
    needed = []
    if req.style_transfer or req.style_mixing or req.depth is not None:
        needed.append("vgg_params")
    if req.text is not None:
        if req.text.style_prompt:
            needed.append("text_transfer")
        if req.text.location_prompt:
            needed.append("mask_extractor")
        if req.text.texture_prompt:
            needed.append("emoji_extractor")
    if req.depth is not None:
        needed.append("depth_estimator")
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
    inputs = inputs or EffectInputs()
    registry = registry or ModelRegistry(device=image.device)
    needed = needed_components(req)
    registry.ensure(*needed)
    metrics = metrics if metrics is not None else RunMetrics()
    try:
        return _apply_stages(image, req, inputs, registry, metrics)
    finally:
        record_degraded(metrics, registry, needed)


def record_degraded(metrics: RunMetrics, registry: ModelRegistry, names) -> None:
    """Add to ``metrics.degraded`` the fallback flags of the models in
    ``names`` that the registry's loaders resolved (not the injected ones)."""
    flags = degraded.flags_for(n for n in names if n in registry.resolved_by_loader)
    if flags:
        metrics.degraded = sorted(set(metrics.degraded) | set(flags))


def _apply_stages(
    image: torch.Tensor,
    req: EffectRequest,
    inputs: EffectInputs,
    registry: ModelRegistry,
    metrics: RunMetrics,
) -> Optional[torch.Tensor]:
    """The seven stages of the reference order (app.py:157-735)."""
    original = image
    output = image
    state = _TextState(mode=_text_mode(req.text))

    # ---- 1. grayscale (app.py:157-159) ----
    if req.grayscale:
        output = basic.grayscale(output)

    # ---- 2. text effects (app.py:161-282) ----
    tcfg = req.text
    if state.mode != "none":
        if tcfg.location_prompt:
            from tbist_tpu_torch.effects import masking

            state.loc_mask = masking.extract_location_mask(registry.mask_extractor, original,
                                                           tcfg)
        if tcfg.texture_prompt:
            state.emoji_mask = upload(registry.emoji_extractor(tcfg.texture_prompt),
                                      original.device)
        if state.mode == "transfer":
            styled = registry.text_transfer(original, tcfg.style_prompt)
            if tcfg.texture_prompt:
                output = _texture_composite(original, styled, state, tcfg.emoji_blur_strength,
                                            tcfg.emoji_step_size, tcfg.emoji_style_strength)
            elif tcfg.location_prompt:
                output = mask_ops.composite_by_mask(original, styled, state.loc_mask,
                                                    int(tcfg.edge_smoothing))
            else:
                output = styled
        elif state.mode == "location":
            output = _visualize(state.loc_mask)
        elif state.mode == "texture":
            output = _visualize(state.emoji_mask)
        else:  # location+texture: the merged mask (app.py:265-282)
            output = _visualize(mask_ops.merge_content_style_masks(
                state.loc_mask, state.emoji_mask, tcfg.emoji_blur_strength,
                tcfg.emoji_step_size))

    # ---- 3. pixel art (app.py:284-370) ----
    if req.pixel_art is not None:
        pcfg = req.pixel_art
        palette = None
        if pcfg.use_palette and pcfg.palette_from_image:
            if inputs.pixel_palette_image is None:
                return None
            from tbist_tpu_torch.ops import palette as palette_ops

            palette = palette_ops.palette_from_image(inputs.pixel_palette_image[0],
                                                     pcfg.palette_num_colors)
        output = _masked_apply(lambda img: pixel_art_fx.pixel_art(img, pcfg, palette=palette),
                               original, output, state, req)

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

    # ---- 6. color palette transfer (app.py:592-658) ----
    if req.color_palette:
        if inputs.color_palette_image is None:
            return None
        output = _masked_apply(
            lambda img: basic.color_palette_transfer(img, inputs.color_palette_image),
            original, output, state, req)

    # ---- 7. depth-based style transfer (app.py:660-735) ----
    if req.depth is not None:
        if inputs.style_image is None:
            return None
        from tbist_tpu_torch.effects import depth as depth_fx

        output = _masked_apply(
            lambda img: depth_fx.depth_style_transfer(
                img, inputs.style_image, req.depth, req.gatys, registry.depth_estimator,
                registry.vgg_params, metrics=metrics, device=image.device),
            original, output, state, req)

    return output
