"""Depth-based style transfer, ported from ``tbist_tpu.effects.depth``:
MIP layering and the depth-loss variant.

* ``mip``: the n depth-bin layers are stylized with decreasing strength
  (1 - i/n, reference style_transfer_depth.py:61-72), then re-masked and
  summed in float (no uint8 overflow). Two plans: sequential runs of the
  Gatys loop, or one batched run over the layer axis
  (``parallel.batched``) with the strengths as a per-lane style weight.
  The JAX package picks the batched plan when a device mesh exists; the
  port runs on one GPU, so the sequential plan is its default.
* ``depth_loss``: Gatys plus a depth term with the estimator in the graph
  (``optimize.gatys_depth``); the reference's term has no gradient
  (Style_a3.py:144-146).

Without a Depth-Anything checkpoint the estimator is the smoothed-luminance
pseudo-depth, flagged ``depth_fallback``, as in the JAX package. Only a
missing checkpoint falls back: a failing card, load or conversion raises.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Callable, Optional

import torch

from tbist_tpu_torch.effects import style as style_fx
from tbist_tpu_torch.ops import mip as mip_ops
from tbist_tpu_torch.ops.filters import gaussian_blur
from tbist_tpu_torch.optimize import gatys as gatys_lib
from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.config import DepthConfig, GatysConfig
from tbist_tpu_torch.utils.imageio import image_resize_bilinear, resolve_device
from tbist_tpu_torch.utils.logging import RunMetrics, logger
from tbist_tpu_torch.weights import vgg as vgg_weights


def _fallback_depth(image: torch.Tensor) -> torch.Tensor:
    """Deterministic pseudo-depth (smoothed luminance) when no Depth-Anything
    weights exist. Shape (H, W) float in [0, 1]."""
    img = image if image.dim() == 4 else image[None]
    luma = torch.mean(img, dim=-1, keepdim=True)
    smooth = gaussian_blur(luma, 31)[0, ..., 0]
    return mip_ops.normalize_depth(smooth)


@functools.lru_cache(maxsize=None)
def default_depth_estimator(device="cuda") -> Callable:
    """Depth-Anything-V2-Small on ``device`` from its checkpoint, or the
    smoothed-luminance fallback (flagged ``depth_fallback``) when there is
    no checkpoint file."""
    from tbist_tpu_torch.weights import depth_convert

    try:
        return depth_convert.get_depth_estimator(device)
    except FileNotFoundError:
        degraded.mark("depth_estimator", "depth_fallback")
        logger.warning("depth estimator: no Depth-Anything weights — using smoothed-"
                       "luminance pseudo-depth fallback")
        return _fallback_depth


def depth_style_transfer(
    image: torch.Tensor,
    style: torch.Tensor,
    dcfg: DepthConfig,
    gcfg: GatysConfig,
    depth_estimator: Optional[Callable] = None,
    vgg_params=None,
    metrics: Optional[RunMetrics] = None,
    device="cuda",
) -> torch.Tensor:
    """``dcfg.mode`` "mip" or "depth_loss" on a (1, H, W, 3) image."""
    depth_estimator = depth_estimator or default_depth_estimator(device)
    if dcfg.mode == "mip":
        return style_mip(image, style, dcfg.mip_layers, gcfg, depth_estimator, vgg_params,
                         metrics, device=device)
    return style_depth_loss(image, style, dcfg, gcfg, depth_estimator, vgg_params, metrics,
                            device=device)


def style_mip(
    image: torch.Tensor,
    style: torch.Tensor,
    n: int,
    gcfg: GatysConfig,
    depth_estimator: Callable,
    vgg_params=None,
    metrics: Optional[RunMetrics] = None,
    batched: Optional[bool] = None,
    device="cuda",
) -> torch.Tensor:
    """Multi-plane-image stylization (style_transfer_depth.py:74-90):
    ``batched`` False or None runs the n layers one after another, True as
    one batched run. Returns (1, H, W, 3)."""
    device = resolve_device(device)
    if vgg_params is None:
        vgg_params = vgg_weights.get_params(device=device)
    image = image.to(device, torch.float32)
    depth = depth_estimator(image)
    layers = mip_ops.generate_layers(image, depth, n)  # (n, H, W, C)
    strengths = [1.0 - i / n for i in range(n)]
    if not batched:
        stylized = torch.cat([
            style_fx.style_transfer(layers[i][None], [style], gcfg, vgg_params,
                                    strength=strengths[i], metrics=metrics, device=device)
            for i in range(n)
        ])
        return mip_ops.reconstruct(stylized, depth, n)[None]

    from tbist_tpu_torch.parallel import batched as batched_lib

    # the sequential plan's rule (style.style_transfer): strength 1 keeps
    # cfg.w_style, the others map through the reference's exponential curve
    w_style = [gcfg.w_style if s == 1.0 else gatys_lib.style_weight_from_strength(s)
               for s in strengths]
    t0 = time.perf_counter()
    stylized = batched_lib.run(gcfg, vgg_params, style_fx._bucket(layers, gcfg),
                               [style_fx._bucket(style.to(device, torch.float32), gcfg)],
                               w_style=w_style, device=device)
    stylized[0, 0, 0, 0].item()  # wait for the run on one value, not the stack
    if metrics is not None:
        metrics.timings_s["mip_batched"] = time.perf_counter() - t0
    if stylized.shape[1:] != layers.shape[1:]:
        stylized = image_resize_bilinear(stylized, tuple(layers.shape[1:3]))
    return mip_ops.reconstruct(stylized, depth, n)[None]


def style_depth_loss(
    image: torch.Tensor,
    style: torch.Tensor,
    dcfg: DepthConfig,
    gcfg: GatysConfig,
    depth_estimator: Callable,
    vgg_params=None,
    metrics: Optional[RunMetrics] = None,
    device="cuda",
) -> torch.Tensor:
    """Gatys + ``dcfg.w_depth`` · MSE(depth(x), depth(content)) on the
    shape-bucketed image, returned at the caller's size."""
    from tbist_tpu_torch.optimize import gatys_depth

    device = resolve_device(device)
    if vgg_params is None:
        vgg_params = vgg_weights.get_params(device=device)
    gcfg = dataclasses.replace(gcfg, w_depth=dcfg.w_depth)
    image = image.to(device, torch.float32)
    image_b = style_fx._bucket(image, gcfg)
    style_b = style_fx._bucket(style.to(device, torch.float32), gcfg)
    t0 = time.perf_counter()
    out = gatys_depth.stylize_with_depth(image_b, style_b, gcfg, depth_estimator, vgg_params,
                                         metrics=metrics, device=device)
    if metrics is not None:  # the loss history's read-back ended the run
        dt = time.perf_counter() - t0
        metrics.timings_s["gatys_depth"] = dt
        metrics.extra["iters_per_sec"] = gcfg.num_steps / dt
    if out.shape != image.shape:
        out = image_resize_bilinear(out, tuple(image.shape[1:3]))
    return out
