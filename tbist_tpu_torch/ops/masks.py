"""Mask compositing, ported from ``tbist_tpu.ops.masks``: the binary-mask
merge and the emoji texture-mask merge.

Reference semantics:

* ``composite_by_mask``: text/segmentation_style_transfer.py:5-94 (hard
  select, or Gaussian-feathered alpha blend);
* ``merge_content_style_masks`` / ``emoji_composite``:
  text/emoji_segmentation_style_transfer.py:6-179, whose 6 scales × 4
  corner anchors of sliding windows become, per anchor, one batch of
  window tiles added onto the accumulator with dense slice adds
  (``_grid_accumulate``).

Every window is a full ``kh×kw`` slice of a zero-padded mask (the
reference's boundary cropping equals zero padding, since the per-window
normaliser ``max(region·emoji)`` ignores zero products), and the four
anchors differ only in which side the padding goes. The reference's RT/RB
anchors use ``kernel_H`` where ``kernel_W`` is meant (:130, :163); emoji
stencils are square, so the square-stencil semantics are implemented.
Masks are (H, W) and images NHWC, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from tbist_tpu_torch.ops.filters import blur_mask, blur_masks
from tbist_tpu_torch.ops.resize import center_crop_to_match, resize_bilinear

EMOJI_SCALES = (0.5, 1.0, 1.5, 2.0, 2.5, 3.0)


def composite_by_mask(content: torch.Tensor, style: torch.Tensor, mask: torch.Tensor,
                      edge_smoothing: int = 5) -> torch.Tensor:
    """Merge NHWC content and style by an (H, W) mask; True selects style.
    ``edge_smoothing`` > 0 Gaussian-feathers the mask edge (odd-forced
    kernel). A shape mismatch is reconciled by center-cropping the larger
    image, as the reference does."""
    content, style, mask = center_crop_to_match(content, style, mask)
    if edge_smoothing:
        m = blur_mask(mask, int(edge_smoothing))[None, ..., None]
        return content * (1.0 - m) + style * m
    return torch.where(mask.bool()[None, ..., None], style, content)


def composite_by_masks_batch(content: torch.Tensor, style: torch.Tensor, masks: torch.Tensor,
                             edge_smoothing: int = 5) -> torch.Tensor:
    """Batched ``composite_by_mask``: (B, H, W, C) images with a per-frame
    (B, H, W) mask, all shapes already equal; per frame it equals
    ``composite_by_mask``."""
    if edge_smoothing:
        m = blur_masks(masks, int(edge_smoothing))[..., None]
        return content * (1.0 - m) + style * m
    return torch.where(masks.bool()[..., None], style, content)


def _anchor_positions(extent: int, step: int, reverse: bool) -> np.ndarray:
    """Window start offsets in the padded array for one axis."""
    step = max(step, 1)
    if reverse:
        # reference: range(extent, 1, -step); in padded coordinates the start
        # equals the original end index (one kernel of leading padding)
        return np.arange(extent, 1, -step)
    return np.arange(0, extent, step)


def merge_content_style_masks(seg_mask: torch.Tensor, emoji_mask: torch.Tensor,
                              blur_strength: int = 95,
                              step_size_multiplier: float = 0.5) -> torch.Tensor:
    """Emoji-augmented soft mask in [0, 1], (H, W), from an (H, W)
    segmentation mask and an (He, We) emoji stencil (reference: 172×172)."""
    h, w = seg_mask.shape
    blurred = blur_mask(seg_mask.float(), int(blur_strength))
    emoji = emoji_mask.float()
    he, we = emoji.shape

    merged = torch.zeros((h, w), dtype=torch.float32, device=blurred.device)
    for scale in EMOJI_SCALES:
        kh, kw = int(he * scale), int(we * scale)
        if kh < 1 or kw < 1:
            continue
        em = resize_bilinear(emoji[..., None], (kh, kw))[:, :, 0]
        em = em / torch.clamp(em.max(), min=1e-20)
        sh = max(math.floor(kh * step_size_multiplier), 1)
        sw = max(math.floor(kw * step_size_multiplier), 1)

        # In padded coordinates (one kernel each side) each axis's window
        # starts are two arithmetic grids: the forward starts shifted by the
        # leading pad, and the reverse windows [i-k, i) starting at padded
        # index i. The 4 corner anchors are their cartesian products.
        row_grids = [_anchor_positions(h, sh, False) + kh, _anchor_positions(h, sh, True)]
        col_grids = [_anchor_positions(w, sw, False) + kw, _anchor_positions(w, sw, True)]
        # slack so that the interleaved Q-cells may overhang the crop region
        slack_r, slack_c = -(-kh // sh) * sh, -(-kw // sw) * sw
        padded = torch.nn.functional.pad(blurred, (kw, kw + slack_c, kh, kh + slack_r))
        acc = torch.zeros_like(padded)
        for rows in row_grids:
            for cols in col_grids:
                if rows.size and cols.size:
                    _grid_accumulate(acc, padded, em, np.sort(rows), np.sort(cols),
                                     kh, kw, sh, sw)
        merged = merged + acc[kh : kh + h, kw : kw + w]
    return merged / torch.clamp(merged.max(), min=1e-20)


def _grid_accumulate(acc, padded, em, rows, cols, kh, kw, sh, sw) -> None:
    """Add, in place into ``acc``, the normalised window products of one
    start grid ``rows × cols`` (arithmetic, strides sh and sw).

    The windows are cut in one batch and split into q_r·q_c interleaved
    groups whose members are disjoint (group stride Q = ceil(k/s)·s ≥ k).
    Each group's tiles, zero-padded to the Q-cell, form one contiguous
    block that one slice add puts in place; the adds come in the JAX
    package's order, so each pixel sums its windows in the same order."""
    n_r, n_c = rows.size, cols.size
    q_r, q_c = -(-kh // sh), -(-kw // sw)
    big_r, big_c = q_r * sh, q_c * sw

    # (n_r, n_c, kh, kw) windows starting at rows[0] + i·sh, cols[0] + j·sw
    wins = padded[int(rows[0]):, int(cols[0]):].unfold(0, kh, sh).unfold(1, kw, sw)
    prod = wins[:n_r, :n_c] * em
    tiles = prod / (prod.amax(dim=(2, 3), keepdim=True) + 1e-7)
    tiles = torch.nn.functional.pad(tiles, (0, big_c - kw, 0, big_r - kh))

    for a in range(min(q_r, n_r)):
        for b in range(min(q_c, n_c)):
            sub = tiles[a::q_r, b::q_c]  # disjoint along both axes
            na, nb = sub.shape[0], sub.shape[1]
            block = sub.permute(0, 2, 1, 3).reshape(na * big_r, nb * big_c)
            rs, cs = int(rows[a]), int(cols[b])
            acc[rs : rs + na * big_r, cs : cs + nb * big_c] += block


def emoji_composite(content: torch.Tensor, style: torch.Tensor, seg_mask: torch.Tensor,
                    emoji_mask: torch.Tensor, blur_strength: int = 95,
                    step_size_multiplier: float = 0.5,
                    style_strength: float = 2.0) -> torch.Tensor:
    """Texture-masked composite (emoji_segmentation_style_transfer.py:6-63)."""
    content, style, seg_mask = center_crop_to_match(content, style, seg_mask)
    merged = merge_content_style_masks(seg_mask, emoji_mask, int(blur_strength),
                                       float(step_size_multiplier))
    merged = torch.clamp(merged * style_strength, 0.0, 1.0)[None, ..., None]
    return content * (1.0 - merged) + style * merged


def emoji_composite_batch(content: torch.Tensor, style: torch.Tensor, seg_masks: torch.Tensor,
                          emoji_mask: torch.Tensor, blur_strength: int = 95,
                          step_size_multiplier: float = 0.5,
                          style_strength: float = 2.0) -> torch.Tensor:
    """Batched ``emoji_composite`` with per-frame (B, H, W) segmentation
    masks and one shared stencil; shapes already equal."""
    merged = torch.stack([
        merge_content_style_masks(s, emoji_mask, int(blur_strength), float(step_size_multiplier))
        for s in seg_masks
    ])
    merged = torch.clamp(merged * style_strength, 0.0, 1.0)[..., None]
    return content * (1.0 - merged) + style * merged
