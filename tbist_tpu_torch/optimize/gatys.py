"""Gatys pixel-optimization style transfer, ported from
``tbist_tpu.optimize.gatys`` (``stylize`` :217-247, ``_stylize_jit`` :109-214).

Each step: clamp to [0, 1] → loss and its gradient (VGG-19 forward and
backward through kernels K1 and K3, and through the depth estimator when
the loss has the depth term of ``optimize.gatys_depth``) → optimizer
update. Feature targets and the style target Grams are computed once
before the loop. The loss history is a device tensor that the loop writes
and nobody reads until the run ends, so no step waits on the host.

Precision: float32 convolutions and matrix products run in full f32 for
the duration of ``stylize`` (TF32 off for cuDNN and cuBLAS), as the JAX
reference computes. ``cfg.dtype == "bfloat16"`` runs the VGG trunk in bf16
with the Gram matrices accumulated in f32.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from tbist_tpu_torch.kernels.gram import GramFunction
from tbist_tpu_torch.models import channel_attention, vgg19
from tbist_tpu_torch.ops import losses
from tbist_tpu_torch.ops.mip import normalize_depth
from tbist_tpu_torch.optimize import lbfgs
from tbist_tpu_torch.utils.config import VGG_MEAN, VGG_STD, GatysConfig
from tbist_tpu_torch.utils.imageio import resolve_device, upload
from tbist_tpu_torch.utils.precision import full_f32

DepthFn = Callable[[torch.Tensor], torch.Tensor]

# optax.adam defaults
_ADAM_B1, _ADAM_B2, _ADAM_EPS = 0.9, 0.999, 1e-8


def style_weight_from_strength(strength: float) -> float:
    """Strength -> w_style mapping of the depth component (Style_a3.py:184-188)."""
    if strength < 0:
        return 5e5
    return 5e5 * math.e ** (strength - 1.0 / strength)


def random_start(shape, seed: int, device) -> torch.Tensor:
    """The starting pixels of ``cfg.random_init``: standard normal from a
    ``torch.Generator`` seeded with ``seed``, drawn on the CPU."""
    return upload(torch.randn(tuple(shape), generator=torch.Generator().manual_seed(seed)),
                  device)


def params_on(vgg_params, device, dtype: torch.dtype):
    """The VGG parameters on ``device`` in the trunk's compute dtype."""
    return {name: {k: v.to(device, dtype) for k, v in p.items()}
            for name, p in vgg_params.items()}


def adam_update(grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, i: int,
                lr: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Step ``i`` (from 0) of ``optax.adam(lr)``: bias-corrected moments, eps
    outside the sqrt. Returns (update, mu, nu)."""
    mu = (1 - _ADAM_B1) * grad + _ADAM_B1 * mu
    nu = (1 - _ADAM_B2) * torch.square(grad) + _ADAM_B2 * nu
    mu_hat = mu / (1 - _ADAM_B1 ** (i + 1))
    nu_hat = nu / (1 - _ADAM_B2 ** (i + 1))
    return (-lr) * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS)), mu, nu


@functools.lru_cache(maxsize=None)
def _vgg_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """VGG's input mean and std on ``device``, made once: a tensor built from
    a Python tuple on a card is a copy the host waits for, and the loss
    normalizes every step."""
    return (torch.tensor(VGG_MEAN, dtype=torch.float32, device=device),
            torch.tensor(VGG_STD, dtype=torch.float32, device=device))


def _lane_mean(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).mean(dim=1)


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    return x.reshape(x.shape[0], -1).sum(dim=1)


def lane_gram(feat: torch.Tensor) -> torch.Tensor:
    """Each lane's Gram of (B, H, W, C) features through K1 in one launch,
    normalized by c·h·w as ``losses.gram_matrix`` of that lane alone is."""
    b, h, w, c = feat.shape
    return GramFunction.apply(feat.reshape(b, h * w, c), 1.0 / (c * h * w))


def lane_losses(cfg: GatysConfig, params, imgs: torch.Tensor, content_feats, target_grads,
                style_grams: Dict[str, torch.Tensor], w_style,
                depth_fn: Optional[DepthFn] = None,
                target_depths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B,) Gatys objectives of the B images of ``imgs`` (``_stylize_jit``'s
    loss, and ``tbist_tpu/parallel/batched.py`` ``_per_frame_loss``): the
    B lanes run through VGG-19 as one batch, and each lane's loss is the
    one-image loss of that lane alone, means over its own pixels.

    ``params`` are on the device in the compute dtype; ``content_feats``
    and ``target_grads`` hold each lane's targets, ``style_grams`` the
    shared ones; ``w_style`` is a float or a (B,) tensor of per-lane
    weights. ``target_depths`` ((B, H, W), normalized) adds the depth term
    of ``depth_fn``, run on each lane alone."""
    mean, std = _vgg_stats(imgs.device)
    normed = losses.normalize(imgs, mean, std)
    all_layers = tuple(dict.fromkeys(cfg.content_layers + cfg.style_layers))
    feats = vgg19.extract_features(params, normed, all_layers,
                                   torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32)
    loss = torch.zeros(imgs.shape[0], dtype=torch.float32, device=imgs.device)
    if cfg.w_content > 0:
        c = sum(_lane_mean(torch.square(feats[l].float() - content_feats[l].float()))
                for l in cfg.content_layers)
        loss = loss + cfg.w_content * (c / len(cfg.content_layers))
    if cfg.w_style > 0:
        s = sum(_lane_mean(torch.square(lane_gram(feats[l]) - style_grams[l]))
                for l in cfg.style_layers)
        loss = loss + w_style * (s / len(cfg.style_layers))
    if cfg.w_tv > 0:
        _, h, w, c = normed.shape
        tv = (_lane_sum(losses.abs_jax(normed[:, 1:] - normed[:, :-1]))
              + _lane_sum(losses.abs_jax(normed[:, :, 1:] - normed[:, :, :-1])))
        loss = loss + cfg.w_tv * (tv / (c * h * w))
    if cfg.w_edge > 0:
        diff = torch.square(target_grads - losses.gradient_images(losses.to_grayscale(imgs)))
        loss = loss + cfg.w_edge * ((_lane_mean(diff[..., 0]) + _lane_mean(diff[..., 1])) / 2.0)
    if target_depths is not None:
        d = torch.stack([normalize_depth(depth_fn(imgs[i:i + 1])) for i in range(imgs.shape[0])])
        loss = loss + cfg.w_depth * _lane_mean(torch.square(d - target_depths))
    return loss


def _attend(content_feats, cfg: GatysConfig, given, device):
    """SE channel attention over the content features of
    ``cfg.content_layers`` (``tbist_tpu/optimize/gatys.py:142-157``)."""
    feats = dict(content_feats)
    for layer in cfg.content_layers:
        params = (given or {}).get(layer)
        if params is None:
            gen = torch.Generator().manual_seed(channel_attention.layer_seed(cfg.seed, layer))
            params = channel_attention.init_params(gen, feats[layer].shape[-1])
        params = {k: upload(v, device).float() for k, v in params.items()}
        feats[layer] = channel_attention.apply(params, feats[layer])
    return feats


def stylize(
    content: torch.Tensor,
    styles: Sequence[torch.Tensor],
    cfg: GatysConfig,
    vgg_params,
    init: Optional[torch.Tensor] = None,
    device="cuda",
    channel_attention_params: Optional[Dict[str, Dict[str, torch.Tensor]]] = None,
    depth_fn: Optional[DepthFn] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run Gatys optimization. Returns (image (1,H,W,3) in [0,1], loss
    history (num_steps,)), both on ``device``.

    ``styles`` holds one or two NHWC style images; two trigger style mixing
    with ``cfg.style_img_weight``. ``init`` overrides the starting pixels
    (checkpoint resume) while the targets stay those of ``content`` and
    ``styles``. ``cfg.random_init`` draws the start from a
    ``torch.Generator`` seeded with ``cfg.seed`` (``random_start``): the
    same distribution as the JAX package's ``jax.random.normal``, not the
    same numbers. ``cfg.channel_attention`` reweights the content features
    of ``cfg.content_layers`` with SE attention before the loop; each
    layer's weights are drawn from a generator seeded with ``cfg.seed`` and
    the layer's name (``channel_attention.layer_seed``), unless
    ``channel_attention_params`` gives them by layer. ``depth_fn``, an
    (1, H, W, 3) -> (H, W) depth estimator, adds ``cfg.w_depth`` times the
    MSE between the normalized depth of the image and of ``content``
    (computed once) when ``cfg.w_depth > 0``; the estimator stays in the
    graph.
    """
    if cfg.optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    device = resolve_device(device)
    compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    params = params_on(vgg_params, device, compute_dtype)
    content = content.to(device, torch.float32)
    styles = [s.to(device, torch.float32) for s in styles]
    mean, std = _vgg_stats(device)
    all_layers = tuple(dict.fromkeys(cfg.content_layers + cfg.style_layers))

    with full_f32():
        # --- feature targets (reference run_style_transfer.py:78-80) ---
        with torch.no_grad():
            normed_content = losses.normalize(content, mean, std)
            content_feats = vgg19.extract_features(
                params, normed_content, all_layers, compute_dtype
            )
            targets = {}
            if cfg.w_style > 0:
                style_feats = [
                    vgg19.extract_features(
                        params, losses.normalize(s, mean, std), cfg.style_layers,
                        compute_dtype,
                    )
                    for s in styles
                ]
                targets = losses.style_targets(
                    style_feats, cfg.style_layers, cfg.style_img_weight,
                    cfg.exact_reference_mixer,
                )
            target_grad = losses.gradient_images(losses.to_grayscale(normed_content))
            if cfg.channel_attention:
                content_feats = _attend(content_feats, cfg, channel_attention_params, device)
            target_depth = None
            if depth_fn is not None and cfg.w_depth > 0:
                target_depth = normalize_depth(depth_fn(content))[None]

        if init is not None:
            img = init.to(device, torch.float32)
        elif cfg.random_init:
            img = random_start(content.shape, cfg.seed, device)
        else:
            img = content.clone()

        hist = torch.zeros((cfg.num_steps,), dtype=torch.float32, device=device)
        if cfg.optimizer == "lbfgs":
            state = lbfgs.init_state(
                tuple(img.shape), cfg.lbfgs_memory, torch.float32, device
            )
        else:
            mu = torch.zeros_like(img)
            nu = torch.zeros_like(img)

        for i in range(cfg.num_steps):
            img = img.clamp(0.0, 1.0).requires_grad_(True)  # per-closure clamp
            loss = lane_losses(cfg, params, img, content_feats, target_grad, targets,
                               cfg.w_style, depth_fn, target_depth)[0]
            (grad,) = torch.autograd.grad(loss, img)
            img = img.detach()
            hist[i] = loss.detach()
            if cfg.optimizer == "lbfgs":
                step_vec, state = lbfgs.update(grad, state, lr=cfg.learning_rate)
                img = img + step_vec
            else:
                step_vec, mu, nu = adam_update(grad, mu, nu, i, cfg.adam_lr)
                img = img + step_vec

    return img.clamp(0.0, 1.0), hist
