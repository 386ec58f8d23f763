"""Swin-T backbone, ported from the JAX package's ``models/swin.py``
(GroundingDINO's image encoder, the SwinT-OGC config).

Swin-T: a 4×4 patch embed to 96 channels, depths (2, 2, 6, 2), heads
(3, 6, 12, 24), window 7 with alternating shifted windows, relative-position
bias tables, patch merging between stages and an exact-GELU MLP ×4. It
returns the LayerNormed NHWC feature maps of stages 2, 3 and 4 (strides 8,
16, 32).

Parameters are the JAX package's tree as tensors (``weights.dino_convert``):
linear weights (in, out), used as ``x @ w + b``; the patch embed in torch's
(out, in, kh, kw) layout. Hazards kept from the JAX package: the window pad
comes after ``ln1`` and its zero tokens are not masked in unshifted
windows; the shift mask (−100) is built on the padded grid; ``torch.roll``
shifts with ``jnp.roll``'s sign; patch merging concatenates (0::2, 0::2),
(1::2, 0::2), (0::2, 1::2), (1::2, 1::2).
"""

from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F


class SwinConfig(NamedTuple):
    embed_dim: int = 96
    depths: Tuple[int, ...] = (2, 2, 6, 2)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: int = 4
    out_indices: Tuple[int, ...] = (1, 2, 3)


TINY = SwinConfig()


def _layer_norm(x: torch.Tensor, p) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=1e-5)


def _rel_bias_index(window: int) -> np.ndarray:
    """(W², W²) index into the (2W-1)² relative position bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij")
    ).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]


@functools.lru_cache(maxsize=None)
def _rel_index_on(window: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_rel_bias_index(window).reshape(-1)).to(device)


def _shift_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """Additive attention mask for shifted windows, (nW, W², W²)."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    for hs in slices:
        for ws in slices:
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(hp // window, window, wp // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, :, None] - img[:, None, :]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _shift_mask_on(hp: int, wp: int, window: int, shift: int, device: torch.device):
    # built once per padded grid, so a forward queues without a host copy
    return torch.from_numpy(_shift_mask(hp, wp, window, shift)).to(device)


def _window_attention(x: torch.Tensor, p, heads: int, window: int, mask=None) -> torch.Tensor:
    """x: (nW*B, W², C); mask: (nW, W², W²) additive or None."""
    bn, t, c = x.shape
    qkv = (x @ p["qkv_w"] + p["qkv_b"]).reshape(bn, t, 3, heads, c // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    logits = (q * (c // heads) ** -0.5) @ k.transpose(-1, -2)
    bias = p["rel_bias_table"][_rel_index_on(window, x.device)]
    logits = logits + bias.reshape(t, t, heads).permute(2, 0, 1)[None]
    if mask is not None:
        nw = mask.shape[0]
        logits = logits.reshape(bn // nw, nw, heads, t, t) + mask[None, :, None]
        logits = logits.reshape(bn, heads, t, t)
    out = torch.softmax(logits, -1) @ v
    return out.transpose(1, 2).reshape(bn, t, c) @ p["proj_w"] + p["proj_b"]


def _block(x: torch.Tensor, p, hw, heads: int, window: int, shift: int) -> torch.Tensor:
    h, w = hw
    b, t, c = x.shape
    shortcut = x
    x = _layer_norm(x, p["ln1"]).reshape(b, h, w, c)

    ph = (window - h % window) % window
    pw = (window - w % window) % window
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw

    if shift > 0:
        x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        mask = _shift_mask_on(hp, wp, window, shift, x.device)
    else:
        mask = None

    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, c)
    x = _window_attention(x, p["attn"], heads, window, mask)
    x = x.reshape(b, hp // window, wp // window, window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, c)

    if shift > 0:
        x = torch.roll(x, shifts=(shift, shift), dims=(1, 2))
    x = shortcut + x[:, :h, :w].reshape(b, t, c)

    y = _layer_norm(x, p["ln2"])
    y = F.gelu(y @ p["mlp_fc1_w"] + p["mlp_fc1_b"])  # exact (erf) GELU
    return x + (y @ p["mlp_fc2_w"] + p["mlp_fc2_b"])


def forward(params, cfg: SwinConfig, img: torch.Tensor) -> List[torch.Tensor]:
    """img: (B, H, W, 3) normalised, H and W multiples of 32. Returns the
    NHWC feature maps of ``cfg.out_indices`` (strides 8/16/32 for 1/2/3)."""
    b, H, W, _ = img.shape
    x = F.conv2d(img.permute(0, 3, 1, 2).to(params["patch_embed_w"].dtype),
                 params["patch_embed_w"], params["patch_embed_b"], stride=4)
    h, w = H // 4, W // 4
    x = _layer_norm(x.permute(0, 2, 3, 1), params["patch_embed_ln"]).reshape(b, h * w, -1)

    outs = []
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage["blocks"]):
            shift = 0 if bi % 2 == 0 else cfg.window // 2
            x = _block(x, blk, (h, w), cfg.heads[si], cfg.window, shift)
        if si in cfg.out_indices:
            outs.append(_layer_norm(x, params[f"out_ln{si}"]).reshape(b, h, w, -1))
        if "downsample" in stage:  # patch merging, odd sides zero-padded
            c = x.shape[-1]
            xg = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
            xg = torch.cat([xg[:, 0::2, 0::2], xg[:, 1::2, 0::2],
                            xg[:, 0::2, 1::2], xg[:, 1::2, 1::2]], -1)
            h, w = xg.shape[1], xg.shape[2]
            xg = _layer_norm(xg.reshape(b, h * w, 4 * c), stage["downsample"]["ln"])
            x = xg @ stage["downsample"]["reduction_w"]
    return outs


def convert_torch_state_dict(sd, prefix: str = "backbone.0.", cfg: SwinConfig = TINY) -> Dict:
    """Official GroundingDINO Swin naming -> the JAX package's tree as numpy
    arrays (the patch embed HWIO); ``weights.dino_convert.from_jax_params``
    turns it into the port's tensors."""

    def arr(k):
        v = sd[prefix + k]
        return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float32)

    def ln(k):
        return {"scale": arr(f"{k}.weight"), "bias": arr(f"{k}.bias")}

    stages = []
    for si, depth in enumerate(cfg.depths):
        blocks = []
        for bi in range(depth):
            p = f"layers.{si}.blocks.{bi}"
            blocks.append({
                "ln1": ln(f"{p}.norm1"), "ln2": ln(f"{p}.norm2"),
                "attn": {
                    "qkv_w": arr(f"{p}.attn.qkv.weight").T, "qkv_b": arr(f"{p}.attn.qkv.bias"),
                    "proj_w": arr(f"{p}.attn.proj.weight").T,
                    "proj_b": arr(f"{p}.attn.proj.bias"),
                    "rel_bias_table": arr(f"{p}.attn.relative_position_bias_table"),
                },
                "mlp_fc1_w": arr(f"{p}.mlp.fc1.weight").T, "mlp_fc1_b": arr(f"{p}.mlp.fc1.bias"),
                "mlp_fc2_w": arr(f"{p}.mlp.fc2.weight").T, "mlp_fc2_b": arr(f"{p}.mlp.fc2.bias"),
            })
        stage = {"blocks": blocks}
        if si < len(cfg.depths) - 1:
            stage["downsample"] = {
                "ln": ln(f"layers.{si}.downsample.norm"),
                "reduction_w": arr(f"layers.{si}.downsample.reduction.weight").T,
            }
        stages.append(stage)

    params = {
        "patch_embed_w": np.transpose(arr("patch_embed.proj.weight"), (2, 3, 1, 0)),
        "patch_embed_b": arr("patch_embed.proj.bias"),
        "patch_embed_ln": ln("patch_embed.norm"),
        "stages": stages,
    }
    for i in cfg.out_indices:
        params[f"out_ln{i}"] = ln(f"norm{i}")
    return params


def init_params(generator: torch.Generator, cfg: SwinConfig = TINY) -> Dict:
    """Seeded random parameters with the JAX init's tree and distributions
    (normal ×0.02, zero biases, unit LayerNorms), on the CPU."""

    def nrm(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    def ln(dim):
        return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}

    stages = []
    dim = cfg.embed_dim
    for si, depth in enumerate(cfg.depths):
        blocks = [{
            "ln1": ln(dim), "ln2": ln(dim),
            "attn": {
                "qkv_w": nrm(dim, 3 * dim), "qkv_b": torch.zeros(3 * dim),
                "proj_w": nrm(dim, dim), "proj_b": torch.zeros(dim),
                "rel_bias_table": nrm((2 * cfg.window - 1) ** 2, cfg.heads[si]),
            },
            "mlp_fc1_w": nrm(dim, cfg.mlp_ratio * dim),
            "mlp_fc1_b": torch.zeros(cfg.mlp_ratio * dim),
            "mlp_fc2_w": nrm(cfg.mlp_ratio * dim, dim), "mlp_fc2_b": torch.zeros(dim),
        } for _ in range(depth)]
        stage = {"blocks": blocks}
        if si < len(cfg.depths) - 1:
            stage["downsample"] = {"ln": ln(4 * dim), "reduction_w": nrm(4 * dim, 2 * dim)}
            dim *= 2
        stages.append(stage)

    params = {
        "patch_embed_w": nrm(cfg.embed_dim, 3, 4, 4),
        "patch_embed_b": torch.zeros(cfg.embed_dim),
        "patch_embed_ln": ln(cfg.embed_dim),
        "stages": stages,
    }
    dims = [cfg.embed_dim * (2**i) for i in range(len(cfg.depths))]
    for i in cfg.out_indices:
        params[f"out_ln{i}"] = ln(dims[i])
    return params
