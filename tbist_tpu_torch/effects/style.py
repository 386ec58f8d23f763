"""Gatys style transfer / style mixing effect, ported from
``tbist_tpu.effects.style`` (``style_transfer`` :73-147).

Owns the boundary of the optimisation effect: shape bucketing, weight
resolution and metrics. On two or more cards one wide image (width at least
``sp_min_width()``) has its width sharded over every card (sp): it runs as
the one lane of ``parallel.batched.run`` over the sp production mesh, under
the JAX package's gates (``_sp_mesh``).
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence

import torch

from tbist_tpu_torch.optimize import gatys
from tbist_tpu_torch.parallel import mesh as mesh_lib
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


def sp_min_width() -> int:
    """Width from which one image's Gatys optimization shards its width over
    the sp mesh (``TBIST_GATYS_SP_MIN_WIDTH``, default 512, as in the JAX
    package). A Gatys step is VGG-19's forward and backward, about a
    hundred times the work a pixel of feed-forward Ghiasi does, so the halo
    copies pay off at a smaller width than ``text_transfer.sp_min_width``."""
    return int(os.environ.get("TBIST_GATYS_SP_MIN_WIDTH", "512"))


def _sp_mesh(content_b: torch.Tensor, cfg: GatysConfig, device) -> Optional[mesh_lib.Mesh]:
    """The sp production mesh when the one image's optimization can shard
    its width, else None. The JAX package's gates
    (``tbist_tpu/effects/style.py:48-70``): SE channel attention and a random
    start have no batched lane, the batch must be one image at least
    ``sp_min_width()`` wide, and the width must divide by sp."""
    if cfg.channel_attention or cfg.random_init:
        return None
    if content_b.shape[0] != 1 or content_b.shape[2] < sp_min_width():
        return None
    mesh = mesh_lib.production_mesh(device, sp_only=True)
    if mesh is None or content_b.shape[2] % mesh.shape[mesh_lib.SP_AXIS] != 0:
        return None
    return mesh


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
    mesh = _sp_mesh(content_b, cfg, device)
    if mesh is not None:
        from tbist_tpu_torch.parallel import batched

        out, hist = batched.run(cfg, vgg_params, content_b, styles_b, w_style=[cfg.w_style],
                                return_history=True, device=device, mesh=mesh)
        hist = hist[:, 0]
        shards = len(mesh_lib.width_plan(content_b.shape[2], mesh.shape[mesh_lib.SP_AXIS],
                                         mesh_lib.VGG_ALIGN))
        logger.info("gatys: single image width sharded %d-way (sp)", shards)
    else:
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
