"""Gatys pixel-optimization style transfer, ported from
``tbist_tpu.optimize.gatys`` (``stylize`` :217-247, ``_stylize_jit`` :109-214).

Each step: clamp to [0, 1] → loss and its gradient (VGG-19 forward and
backward through kernels K1 and K3) → optimizer update. Feature targets
and the style target Grams are computed once before the loop. The loss
history is a device tensor that the loop writes and nobody reads until the
run ends, so no step waits on the host.

Precision: float32 convolutions and matrix products run in full f32 for
the duration of ``stylize`` (TF32 off for cuDNN and cuBLAS), as the JAX
reference computes. ``cfg.dtype == "bfloat16"`` runs the VGG trunk in bf16
with the Gram matrices accumulated in f32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch

from tbist_tpu_torch.models import channel_attention, vgg19
from tbist_tpu_torch.ops import losses
from tbist_tpu_torch.optimize import lbfgs
from tbist_tpu_torch.utils.config import VGG_MEAN, VGG_STD, GatysConfig
from tbist_tpu_torch.utils.imageio import resolve_device, upload
from tbist_tpu_torch.utils.precision import full_f32

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
    ``channel_attention_params`` gives them by layer.
    """
    if cfg.optimizer not in ("lbfgs", "adam"):
        raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    device = resolve_device(device)
    compute_dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    params = {
        name: {k: v.to(device, compute_dtype) for k, v in p.items()}
        for name, p in vgg_params.items()
    }
    content = content.to(device, torch.float32)
    styles = [s.to(device, torch.float32) for s in styles]
    mean = torch.tensor(VGG_MEAN, dtype=torch.float32, device=device)
    std = torch.tensor(VGG_STD, dtype=torch.float32, device=device)
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

        def loss_fn(img: torch.Tensor) -> torch.Tensor:
            normed = losses.normalize(img, mean, std)
            feats = vgg19.extract_features(params, normed, all_layers, compute_dtype)
            loss = torch.zeros((), dtype=torch.float32, device=device)
            if cfg.w_content > 0:
                loss = loss + cfg.w_content * losses.content_loss(
                    feats, content_feats, cfg.content_layers
                )
            if cfg.w_style > 0:
                loss = loss + cfg.w_style * losses.style_loss_from_targets(
                    feats, targets, cfg.style_layers
                )
            if cfg.w_tv > 0:
                loss = loss + cfg.w_tv * losses.total_variation_loss(normed)
            if cfg.w_edge > 0:
                grad_img = losses.gradient_images(losses.to_grayscale(img))
                loss = loss + cfg.w_edge * losses.edge_loss(target_grad, grad_img)
            return loss

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
            loss = loss_fn(img)
            (grad,) = torch.autograd.grad(loss, img)
            img = img.detach()
            hist[i] = loss.detach()
            if cfg.optimizer == "lbfgs":
                step_vec, state = lbfgs.update(grad, state, lr=cfg.learning_rate)
                img = img + step_vec
            else:  # optax.adam: eps outside the sqrt, bias-corrected moments
                mu = (1 - _ADAM_B1) * grad + _ADAM_B1 * mu
                nu = (1 - _ADAM_B2) * torch.square(grad) + _ADAM_B2 * nu
                mu_hat = mu / (1 - _ADAM_B1 ** (i + 1))
                nu_hat = nu / (1 - _ADAM_B2 ** (i + 1))
                img = img + (-cfg.adam_lr) * (mu_hat / (torch.sqrt(nu_hat) + _ADAM_EPS))

    return img.clamp(0.0, 1.0), hist
