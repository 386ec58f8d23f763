"""Gatys style transfer / style mixing effect, ported from
``tbist_tpu.effects.style`` (``style_transfer`` :73-147).

Owns the boundary of the optimisation effect: shape bucketing, weight
resolution and metrics. It runs on one GPU; the JAX package's sp-mesh
branch (width sharded over several chips) has no counterpart here.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Sequence

import torch

from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.utils.config import GatysConfig
from tbist_tpu_torch.utils.imageio import bucket_shape, image_resize_bilinear, resolve_device
from tbist_tpu_torch.utils.logging import RunMetrics, logger
from tbist_tpu_torch.weights import vgg as vgg_weights


def _bucket(img: torch.Tensor, cfg: GatysConfig) -> torch.Tensor:
    h, w = img.shape[1], img.shape[2]
    bh, bw = bucket_shape(h, w, cfg.shape_bucket, cfg.max_side)
    if (bh, bw) != (h, w):
        img = image_resize_bilinear(img, (bh, bw))
    return img


def style_transfer(
    content: torch.Tensor,
    styles: Sequence[torch.Tensor],
    cfg: Optional[GatysConfig] = None,
    vgg_params=None,
    strength: float = 1.0,
    metrics: Optional[RunMetrics] = None,
    device="cuda",
) -> torch.Tensor:
    """Optimize ``content`` toward the style(s). NHWC [0,1] in and out.

    ``strength`` maps to w_style via the reference's exponential curve when
    it differs from 1 (Style_a3.py:184-188). Two styles → mixing with
    ``cfg.style_img_weight``.
    """
    device = resolve_device(device)
    cfg = cfg or GatysConfig()
    if strength != 1.0:
        cfg = dataclasses.replace(cfg, w_style=gatys.style_weight_from_strength(strength))
    if vgg_params is None:
        vgg_params = vgg_weights.get_params(device=device)

    content_b = _bucket(content.to(device, torch.float32), cfg)
    styles_b = [_bucket(s.to(device, torch.float32), cfg) for s in styles]

    t0 = time.perf_counter()
    out, hist = gatys.stylize(content_b, styles_b, cfg, vgg_params, device=device)
    hist = hist.cpu()  # the run's one read-back; waits for the device
    dt = time.perf_counter() - t0
    logger.info(
        "gatys: %d iters in %.2fs (%.1f iters/s) @ %dx%d",
        cfg.num_steps,
        dt,
        cfg.num_steps / dt,
        content_b.shape[1],
        content_b.shape[2],
    )
    if metrics is not None:
        metrics.timings_s["gatys"] = dt
        metrics.loss_history = hist.tolist()
        metrics.extra["iters_per_sec"] = cfg.num_steps / dt

    if out.shape != content.shape:  # return at the caller's resolution
        out = image_resize_bilinear(out, (content.shape[1], content.shape[2]))
    return out
