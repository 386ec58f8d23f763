"""Text→mask entry points, ported from the JAX package's
``effects/masking.py``.

Location masks come from GroundingDINO + SAM (``models.dino_sam``,
reference text/TextMaskExtractor.py) when their checkpoints and the BERT
vocab exist, and otherwise from a documented deterministic fallback that
keeps the pipeline runnable: the border-prior segmentation below, flagged
``mask_fallback``. Texture stencils come from T5-emojilm and the emoji
font (``models.t5_emoji``, reference text/EmojiMaskExtractor.py) when they
exist, and otherwise from the prompt's first character drawn with PIL's
default font, flagged ``emoji_fallback``.
"""

from __future__ import annotations

import functools
from typing import Callable

import numpy as np
import torch

from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.imageio import image_resize_bilinear
from tbist_tpu_torch.utils.logging import logger


def _host_frame(image) -> np.ndarray:
    """(H, W, 3) or (1, H, W, 3), a tensor anywhere or host numpy -> host
    (H, W, 3) numpy: one read-back of a device image."""
    if isinstance(image, torch.Tensor):
        image = image.detach().cpu().numpy()
    arr = np.asarray(image)
    return arr[0] if arr.ndim == 4 else arr


def _fallback_location_mask(image, prompt: str, **_kw) -> torch.Tensor:
    """Deterministic mask when no DINO/SAM weights exist: colour distance to
    the border mean (a background prior), thresholded at mean + 0.5·std.
    Prompt-independent, and shaped like the real extractor's output: (H, W)
    bool, on the image's device (the CPU for a host image)."""
    arr = _host_frame(image)
    h, w = arr.shape[:2]
    border = np.concatenate([arr[0], arr[-1], arr[:, 0], arr[:, w - 1]], axis=0)
    bg = border.mean(axis=0)
    dist = np.linalg.norm(arr - bg, axis=-1)
    thresh = dist.mean() + 0.5 * dist.std()
    device = image.device if isinstance(image, torch.Tensor) else "cpu"
    return torch.from_numpy(dist > thresh).to(device)


EMOJI_SIZE = 172  # reference stencil canvas (EmojiMaskExtractor.py:62)


def _fallback_emoji_stencil(prompt: str) -> torch.Tensor:
    """The prompt's first character (upper-cased) as a (172, 172) bool CPU
    stencil: PIL's default bitmap font drawn at (8, 8) on a white 32×32
    canvas, scaled up nearest, thresholded at < 255 as the reference
    thresholds its glyph (EmojiMaskExtractor.py:62-70)."""
    from PIL import Image, ImageDraw, ImageFont

    char = (prompt.strip() or "*")[0].upper()
    img = Image.new("L", (32, 32), 255)
    ImageDraw.Draw(img).text((8, 8), char, 0, font=ImageFont.load_default())
    big = img.resize((EMOJI_SIZE, EMOJI_SIZE), Image.NEAREST)
    return torch.from_numpy(np.asarray(big) < 255)


def _detection_kwargs(tcfg) -> dict:
    """det_size/det_max (and seg_size) kwargs for a non-default detection or
    segmentation size. Empty at the defaults, so that an (image, prompt)
    extractor keeps working; an extractor that honours the knobs accepts
    the det_size/det_max/seg_size keywords (``models.dino_sam``'s do)."""
    det = int(getattr(tcfg, "detection_size", 800) or 800)
    det_max = int(getattr(tcfg, "detection_max_size", 1333) or 1333)
    seg = int(getattr(tcfg, "segmentation_size", 0) or 0)
    if det == 800 and det_max == 1333 and seg in (0, 1024):
        return {}
    kw = {"det_size": det, "det_max": det_max}
    if seg not in (0, 1024):
        kw["seg_size"] = seg
    return kw


def extract_location_mask(extractor: Callable, image: torch.Tensor, tcfg) -> torch.Tensor:
    """Run ``extractor`` with the TextMaskExtractor preprocess options.

    At the default options this is ``extractor(image, prompt)``. With
    crop/square/resize set (TextEffectConfig.mask_crop/mask_square/
    mask_resize, TextMaskExtractor.py:70-131) the detection input is
    preprocessed on the host, handed to the extractor as uint8, and the mask
    placed back into the content frame (False outside the crop window).
    Returns an (H, W) bool mask in the ORIGINAL image's shape, on its
    device."""
    crop = tuple(tcfg.mask_crop)
    resize = tuple(tcfg.mask_resize)
    det_kw = _detection_kwargs(tcfg)
    if crop == (0, 0, 0, 0) and not tcfg.mask_square and not resize:
        return extractor(image, tcfg.location_prompt, **det_kw)

    from tbist_tpu_torch.models import dino_sam

    arr = _host_frame(image)
    h, w = arr.shape[:2]
    if arr.dtype.kind == "f":
        arr = (np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)
    left, right, top, bottom = (int(v) for v in crop)
    rh, rw = (int(resize[0]), int(resize[1])) if resize else (512, 512)
    pre, (oy, ox, ph, pw) = dino_sam.preprocess_image(
        arr, resize=bool(resize), square=tcfg.mask_square, height=rh, width=rw,
        left=left, right=right, top=top, bottom=bottom, return_offsets=True,
    )
    m = _host_frame(extractor(pre, tcfg.location_prompt, **det_kw))
    if m.shape != (ph, pw):  # undo the resize, antialiased as jax.image.resize
        m = image_resize_bilinear(torch.from_numpy(m.astype(np.float32))[None, ..., None],
                                  (ph, pw))[0, ..., 0].numpy() > 0.5
    full = np.zeros((h, w), bool)
    full[oy : oy + ph, ox : ox + pw] = m.astype(bool)
    device = image.device if isinstance(image, torch.Tensor) else "cpu"
    return torch.from_numpy(full).to(device)


def _mark_fallback(what: str) -> None:
    degraded.mark("mask_extractor", "mask_fallback")
    logger.warning("%s: no GroundingDINO/SAM weights or BERT vocab — using border-prior "
                   "fallback segmentation", what)


@functools.lru_cache(maxsize=None)
def default_mask_extractor(device="cuda") -> Callable:
    """The DINO+SAM extractor on ``device`` when its files exist, else the
    border-prior fallback (flagged ``mask_fallback``). A missing card is not
    a missing file: it raises."""
    from tbist_tpu_torch.models import dino_sam

    try:
        return dino_sam.get_mask_extractor(device)
    except OSError:
        _mark_fallback("mask extractor")
        return _fallback_location_mask


@functools.lru_cache(maxsize=None)
def default_batch_mask_extractor(device="cuda") -> Callable:
    """(B, H, W, 3) uint8 frames + ONE prompt -> (B, H, W) bool masks: one
    DINO and one SAM encoder call per chunk (``dino_sam.extract_masks_batch``)
    when the files exist, else the fallback frame by frame."""
    from tbist_tpu_torch.models import dino_sam

    try:
        return dino_sam.get_batch_mask_extractor(device)
    except OSError:
        _mark_fallback("batch mask extractor")

        def batch_fallback(frames, prompt: str, **_kw) -> torch.Tensor:
            is_tensor = isinstance(frames, torch.Tensor)
            arr = frames.detach().cpu().numpy() if is_tensor else np.asarray(frames)  # one read-back
            masks = torch.stack([_fallback_location_mask(f, prompt) for f in arr])
            return masks.to(frames.device) if is_tensor else masks

        return batch_fallback


@functools.lru_cache(maxsize=None)
def default_emoji_extractor(device="cuda") -> Callable:
    """prompt -> (172, 172) bool CPU stencil: T5-emojilm on ``device`` and
    the emoji font when they exist, else the glyph fallback (flagged
    ``emoji_fallback``). A missing card is not a missing file: it raises."""
    from tbist_tpu_torch.models import t5_emoji

    try:
        return t5_emoji.get_emoji_extractor(device)
    except (OSError, ImportError):
        degraded.mark("emoji_extractor", "emoji_fallback")
        logger.warning("emoji extractor: no T5-emojilm weights/font — rasterizing the "
                       "prompt's first character as the stencil")
        return _fallback_emoji_stencil
