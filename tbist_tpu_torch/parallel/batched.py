"""Batched (multi-lane) stylization, ported from ``tbist_tpu.parallel.batched``.

B images (video frames, or MIP's depth layers) are optimized in lockstep as
one batch: each step runs the B lanes through VGG-19 together (K1 computes
each lane's own Gram, K3 the pools) in ``gatys.lane_losses``, the loss of
``gatys.stylize`` itself, against each lane's own content targets and the
shared style Grams, and takes one L-BFGS step per lane (``lbfgs_lanes``)
or an Adam step. A lane's loss is the mean over its own pixels, exactly the
single-image objective; the B losses are summed before the backward, so
each lane gets its own gradient.

The JAX package shards the lanes over a device mesh (``parallel/mesh.py``);
the port runs them on one GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from tbist_tpu_torch.models import vgg19
from tbist_tpu_torch.ops import losses
from tbist_tpu_torch.ops.mip import normalize_depth
from tbist_tpu_torch.optimize import gatys, lbfgs
from tbist_tpu_torch.optimize.gatys import DepthFn
from tbist_tpu_torch.utils.config import VGG_MEAN, VGG_STD, GatysConfig
from tbist_tpu_torch.utils.imageio import resolve_device
from tbist_tpu_torch.utils.precision import full_f32


@dataclasses.dataclass
class BatchState:
    images: torch.Tensor  # (B, H, W, 3) pixels being optimized
    opt_state: object  # one lbfgs.LBFGSState a lane, or Adam's (mu, nu)
    step: int


def _compute_dtype(cfg: GatysConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _all_layers(cfg: GatysConfig):
    return tuple(dict.fromkeys(cfg.content_layers + cfg.style_layers))


def depth_targets(depth_fn: DepthFn, frames: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, ...) normalized depth of each frame, without a
    graph: ``gatys_depth``'s target, ``normalize_depth(depth_fn(frame))``."""
    with torch.no_grad():
        return torch.stack([normalize_depth(depth_fn(f[None])) for f in frames])


def init_batch(cfg: GatysConfig, vgg_params, frames: torch.Tensor,
               styles: Sequence[torch.Tensor], device="cuda"):
    """Per-frame content targets and the shared style Grams (of one style,
    or of two styles' mixed features with ``cfg.style_img_weight``).

    frames: (B, H, W, 3) in [0, 1]; styles: (1, Hs, Ws, 3) each. Returns
    (state, content_feats, target_grads, style_grams), all on ``device``."""
    device = resolve_device(device)
    dtype = _compute_dtype(cfg)
    params = gatys.params_on(vgg_params, device, dtype)
    frames = frames.to(device, torch.float32)
    with torch.no_grad(), full_f32():
        normed = losses.normalize(frames, VGG_MEAN, VGG_STD)
        content_feats = vgg19.extract_features(params, normed, _all_layers(cfg), dtype)
        target_grads = losses.gradient_images(losses.to_grayscale(normed))
        style_feats = [
            vgg19.extract_features(params, losses.normalize(s.to(device, torch.float32),
                                                            VGG_MEAN, VGG_STD),
                                   cfg.style_layers, dtype)
            for s in styles
        ]
        style_grams = losses.style_targets(style_feats, cfg.style_layers, cfg.style_img_weight,
                                           cfg.exact_reference_mixer)
    if cfg.optimizer == "lbfgs":
        opt_state = [lbfgs.init_state(tuple(frames.shape[1:]), cfg.lbfgs_memory,
                                      torch.float32, device) for _ in range(frames.shape[0])]
    elif cfg.optimizer == "adam":
        opt_state = (torch.zeros_like(frames), torch.zeros_like(frames))
    else:
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    return BatchState(frames.clone(), opt_state, 0), content_feats, target_grads, style_grams


def lbfgs_lanes(grads: torch.Tensor, states: Sequence[lbfgs.LBFGSState],
                lr: float) -> torch.Tensor:
    """One ``lbfgs.update`` per lane, each on its own state (updated in
    place): (B, ...) update vectors. The JAX package's batch-first
    ``update_batch`` (B <= 2) and ``vmap(update)`` (B > 2) compute the same
    per lane; lane by lane, each product is an (m, n) x (n,) GEMV, where a
    batched product runs as cuBLAS's slower strided-batched GEMV."""
    return torch.stack([lbfgs.update(g, s, lr=lr)[0] for g, s in zip(grads, states)])


def train_step(cfg: GatysConfig, vgg_params, state: BatchState, content_feats, target_grads,
               style_grams, w_style: Optional[torch.Tensor] = None,
               depth_fn: Optional[DepthFn] = None,
               target_depths: Optional[torch.Tensor] = None) -> Tuple[BatchState, torch.Tensor]:
    """One optimizer step for every lane. Returns (state, (B,) losses).

    ``w_style`` gives each lane its own style weight ((B,) tensor); None
    uses ``cfg.w_style`` for all. ``depth_fn`` with ``target_depths`` (from
    ``depth_targets``) adds the depth term when ``cfg.w_depth > 0``."""
    imgs = state.images.clamp(0.0, 1.0).requires_grad_(True)
    params = gatys.params_on(vgg_params, imgs.device, _compute_dtype(cfg))
    if w_style is None:
        w_style = torch.full((imgs.shape[0],), cfg.w_style, device=imgs.device)
    if depth_fn is None or cfg.w_depth <= 0:
        target_depths = None
    with full_f32():
        values = gatys.lane_losses(cfg, params, imgs, content_feats, target_grads, style_grams,
                                   w_style, depth_fn, target_depths)
        (grads,) = torch.autograd.grad(values.sum(), imgs)
        imgs = imgs.detach()
        if cfg.optimizer == "lbfgs":
            step_vecs = lbfgs_lanes(grads, state.opt_state, cfg.learning_rate)
            opt_state = state.opt_state
        else:
            step_vecs, mu, nu = gatys.adam_update(grads, *state.opt_state, state.step,
                                                  cfg.adam_lr)
            opt_state = (mu, nu)
    return BatchState(imgs + step_vecs, opt_state, state.step + 1), values.detach()


def run(cfg: GatysConfig, vgg_params, frames: torch.Tensor, styles: Sequence[torch.Tensor],
        w_style=None, return_history: bool = False, depth_fn: Optional[DepthFn] = None,
        device="cuda"):
    """``init_batch`` + ``cfg.num_steps`` train steps + clamp -> (B, H, W, 3).

    ``w_style`` optionally gives each lane its own style weight (MIP's
    per-layer strengths); ``return_history`` also returns the (num_steps, B)
    losses, kept on the device until the caller reads them; ``depth_fn``
    adds the depth term against each frame's own target when
    ``cfg.w_depth > 0``."""
    device = resolve_device(device)
    params = gatys.params_on(vgg_params, device, _compute_dtype(cfg))
    state, content_feats, target_grads, style_grams = init_batch(cfg, params, frames, styles,
                                                                  device)
    if w_style is not None:
        w_style = torch.as_tensor(w_style, dtype=torch.float32).to(device)
    tdepths = None
    if depth_fn is not None and cfg.w_depth > 0:
        tdepths = depth_targets(depth_fn, state.images)
    hist = torch.zeros((cfg.num_steps, frames.shape[0]), device=device) if return_history else None
    for i in range(cfg.num_steps):
        state, values = train_step(cfg, params, state, content_feats, target_grads,
                                   style_grams, w_style, depth_fn, tdepths)
        if hist is not None:
            hist[i] = values
    out = state.images.clamp(0.0, 1.0)
    return (out, hist) if return_history else out
