"""Depth-Anything-V2-Small (DINOv2 ViT-S/14 + DPT head), ported from
``tbist_tpu.models.depth_anything``.

Architecture (HF config of ``depth-anything/Depth-Anything-V2-Small-hf``):
a ViT-S/14 backbone (width 384, 12 layers, 6 heads, GELU MLP ×4,
LayerScale, a CLS token, a learned 37×37 position table resized bicubically
to the input grid) whose hidden states after layers {3, 6, 9, 12} go through
the shared final LayerNorm; a DPT neck that reassembles them to {48, 96,
192, 384} channels at ×4, ×2, ×1 and ×½ the grid, projects each to 64 and
fuses them deepest first; a head of conv 64→32, an upsample to the input
size, conv 32→32 + ReLU and conv 32→1 + ReLU.

Parameters are plain dicts of tensors with the JAX package's keys (built by
``weights.depth_convert``). Linear weights keep the JAX layout (in, out) and
are used as ``x @ w + b``; convolution weights are in torch's layout (out,
in, kh, kw); the two reassemble transposed convolutions' weights are (in,
out, kh, kw), flipped in both spatial axes so that ``F.conv_transpose2d``
computes what the JAX package's ``lax.conv_transpose`` computes (the same
convT flip as SAM's, ``weights/sam.py``). Tensors are NHWC at the public
functions.

Every op is differentiable with respect to the image: the depth-loss
stylization keeps the estimator in its graph. Attention is the plain
``softmax(q·kᵀ)·v`` of the JAX package (no fused kernel: its f32 backends
accumulate in another order, and autograd runs through it). Convolutions
pad as XLA's ``"SAME"``: on an even side the stride-2 reassemble conv pads
(0, 1), where torch's ``padding=1`` would pad (1, 1).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from tbist_tpu_torch.ops.resize import resize_bilinear
from tbist_tpu_torch.utils.imageio import image_resize_bilinear, tree_to
from tbist_tpu_torch.utils.precision import full_f32

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
RESIZE_FACTORS = (4, 2, 1, 2)  # reassemble: ×4 and ×2 transposed, ×1, ×½ strided

Params = Dict[str, object]


class DAConfig(NamedTuple):
    patch: int = 14
    width: int = 384
    layers: int = 12
    heads: int = 6
    mlp_ratio: int = 4
    out_layers: tuple = (3, 6, 9, 12)  # 1-indexed encoder depths
    neck_dims: tuple = (48, 96, 192, 384)
    fusion: int = 64
    head_hidden: int = 32
    pos_grid: int = 37  # 518 / 14 positions on each side at train time
    input_size: int = 518


SMALL = DAConfig()


# ---------------------------------------------------------------------------
# DINOv2 encoder
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=1e-6)


def _mha(x: torch.Tensor, p, heads: int) -> torch.Tensor:
    b, t, d = x.shape
    qkv = (x @ p["qkv_w"] + p["qkv_b"]).reshape(b, t, 3, heads, d // heads)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)  # each (B, heads, T, d/heads)
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d / heads), dim=-1)
    out = (attn @ v).transpose(1, 2).reshape(b, t, d)
    return out @ p["proj_w"] + p["proj_b"]


def _interp_pos_embed(pos: torch.Tensor, grid_hw: Tuple[int, int], cfg: DAConfig):
    """The (1, 1+G², D) position table at the input's patch grid: the patch
    rows resized as ``jax.image.resize(..., "bicubic")`` resizes them (Keys
    a = -0.5, antialiased on a shrink, which torch's antialiased bicubic
    computes). At the table's own grid the resize is the identity."""
    gh, gw = grid_hw
    g = cfg.pos_grid
    if (gh, gw) == (g, g):
        return pos
    patch = pos[:, 1:].reshape(1, g, g, -1).permute(0, 3, 1, 2)
    patch = F.interpolate(patch, size=(gh, gw), mode="bicubic", align_corners=False,
                          antialias=True)
    return torch.cat([pos[:, :1], patch.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)], dim=1)


def encode(params: Params, cfg: DAConfig, img: torch.Tensor) -> List[torch.Tensor]:
    """img: (B, H, W, 3) ImageNet-normalized, H and W multiples of the patch.
    Returns the hidden states (CLS first) after each of ``cfg.out_layers``,
    through the shared final LayerNorm; a repeated index repeats its state."""
    b, h, w, _ = img.shape
    gh, gw = h // cfg.patch, w // cfg.patch
    x = F.conv2d(img.permute(0, 3, 1, 2), params["patch_embed_w"], params["patch_embed_b"],
                 stride=cfg.patch)
    x = x.flatten(2).transpose(1, 2)  # (B, gh·gw, D), row-major over the grid
    cls = params["cls_token"].expand(b, 1, cfg.width)
    x = torch.cat([cls, x], dim=1) + _interp_pos_embed(params["pos_embed"], (gh, gw), cfg)

    states = []
    for blk in params["blocks"]:
        x = x + _mha(_layer_norm(x, blk["ln1"]), blk["attn"], cfg.heads) * blk["ls1"]
        h2 = F.gelu(_layer_norm(x, blk["ln2"]) @ blk["mlp_fc1_w"] + blk["mlp_fc1_b"])
        x = x + (h2 @ blk["mlp_fc2_w"] + blk["mlp_fc2_b"]) * blk["ls2"]
        states.append(x)
    normed = {i: _layer_norm(states[i - 1], params["backbone_ln"]) for i in set(cfg.out_layers)}
    return [normed[i] for i in cfg.out_layers]


# ---------------------------------------------------------------------------
# DPT neck + head
# ---------------------------------------------------------------------------


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one side of length ``n``: the total that
    gives ceil(n / stride) outputs, the odd one at the end."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_same(x: torch.Tensor, w: torch.Tensor, b=None, stride: int = 1) -> torch.Tensor:
    """NHWC convolution with an (out, in, kh, kw) weight, padded as XLA's
    ``"SAME"``: symmetric pads go to the convolution, uneven ones to an
    explicit pad first."""
    (top, bottom), (left, right) = (same_pads(n, k, stride)
                                    for n, k in zip(x.shape[1:3], w.shape[2:]))
    y = x.permute(0, 3, 1, 2)
    if (top, left) == (bottom, right):
        y = F.conv2d(y, w, b, stride=stride, padding=(top, left))
    else:
        y = F.conv2d(F.pad(y, (left, right, top, bottom)), w, b, stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_transpose_same(x: torch.Tensor, w: torch.Tensor, b, stride: int) -> torch.Tensor:
    """NHWC transposed convolution with kernel size = stride, as
    ``lax.conv_transpose(..., "SAME")`` computes it: ``w`` is (in, out, k,
    k), already flipped (module docstring); the output is ``stride`` × the
    input."""
    if w.shape[2:] != (stride, stride):
        raise ValueError(f"kernel {tuple(w.shape[2:])} is not the stride {stride}")
    return F.conv_transpose2d(x.permute(0, 3, 1, 2), w, b, stride=stride).permute(0, 2, 3, 1)


def _residual_unit(x: torch.Tensor, p) -> torch.Tensor:
    h = conv_same(torch.relu(x), p["conv1_w"], p["conv1_b"])
    return x + conv_same(torch.relu(h), p["conv2_w"], p["conv2_b"])


def depth_head(params: Params, cfg: DAConfig, hidden_states: Sequence[torch.Tensor],
               grid_hw: Tuple[int, int], out_hw: Tuple[int, int]) -> torch.Tensor:
    """The DPT neck and head on ``encode``'s states -> (B, H, W) relative depth."""
    gh, gw = grid_hw
    feats = []
    for i, hs in enumerate(hidden_states):
        rs = params["reassemble"][i]
        f = (hs[:, 1:] @ rs["proj_w"] + rs["proj_b"]).reshape(hs.shape[0], gh, gw, -1)
        if "up_w" in rs:
            f = conv_transpose_same(f, rs["up_w"], rs["up_b"], RESIZE_FACTORS[i])
        elif "down_w" in rs:
            f = conv_same(f, rs["down_w"], rs["down_b"], stride=RESIZE_FACTORS[i])
        feats.append(conv_same(f, params["neck_convs"][i]["w"]))  # 3×3, no bias

    # top-down fusion, deepest first: fusion layer 0 pairs with the deepest
    # feature, and each upsample (align_corners=True) goes to the next
    # shallower feature's grid, which on an odd patch grid is not ×2
    x = None
    for i in reversed(range(4)):
        p = params["fusion"][3 - i]
        if x is None:
            x = _residual_unit(feats[i], p["res2"])
        else:
            x = _residual_unit(x + _residual_unit(feats[i], p["res1"]), p["res2"])
        target = feats[i - 1].shape[1:3] if i > 0 else (x.shape[1] * 2, x.shape[2] * 2)
        x = resize_bilinear(x, tuple(target), align_corners=True)
        x = conv_same(x, p["proj_w"], p["proj_b"])

    head = params["head"]
    h = conv_same(x, head["conv1_w"], head["conv1_b"])
    h = resize_bilinear(h, tuple(out_hw), align_corners=True)
    h = torch.relu(conv_same(h, head["conv2_w"], head["conv2_b"]))
    h = torch.relu(conv_same(h, head["conv3_w"], head["conv3_b"]))
    return h[..., 0]


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """ImageNet mean and std on ``device``, made once: a tensor built from a
    Python list on a card is a copy the host waits for, and the depth-loss
    loop calls ``predict_depth`` every step."""
    return (torch.tensor(IMAGENET_MEAN, device=device),
            torch.tensor(IMAGENET_STD, device=device))


def predict_depth(params: Params, cfg: DAConfig, image: torch.Tensor) -> torch.Tensor:
    """image: (B, H, W, 3) in [0, 1] -> (H, W) relative depth of the first
    image. Resizes to the model's square input as the HF pipeline does, and
    back to the image's size, both as ``jax.image.resize`` bilinear; the
    gradient flows through both. Convolutions and products run in full f32
    (TF32 off) for the forward; a backward runs under its caller's setting."""
    with full_f32():
        image = image.float()
        b, h, w, _ = image.shape
        size = cfg.input_size
        mean, std = _imagenet_stats(image.device)
        x = (image_resize_bilinear(image, (size, size)) - mean) / std
        g = size // cfg.patch
        depth = depth_head(params, cfg, encode(params, cfg, x), (g, g), (size, size))
        depth = image_resize_bilinear(depth[..., None], (h, w))[..., 0]
        return depth[0]


# ---------------------------------------------------------------------------
# seeded weights
# ---------------------------------------------------------------------------


def init_params(generator: torch.Generator, cfg: DAConfig = SMALL, device="cpu") -> Params:
    """Seeded random parameters with the distributions of the JAX package's
    ``_init_params_impl``: weights normal ×0.02, biases zero, LayerNorms
    ones and zeros, LayerScale 1e-5 (the same distribution, not the same
    numbers). Every tensor is f32 with ``requires_grad`` off: the depth term
    differentiates the image only."""

    def nrm(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    def zeros(n):
        return torch.zeros(n)

    def ln(n):
        return {"scale": torch.ones(n), "bias": zeros(n)}

    def res_unit(f):
        return {"conv1_w": nrm(f, f, 3, 3), "conv1_b": zeros(f),
                "conv2_w": nrm(f, f, 3, 3), "conv2_b": zeros(f)}

    d, f, hh = cfg.width, cfg.fusion, cfg.head_hidden
    blocks = [{
        "ln1": ln(d), "ln2": ln(d),
        "attn": {"qkv_w": nrm(d, 3 * d), "qkv_b": zeros(3 * d), "proj_w": nrm(d, d),
                 "proj_b": zeros(d)},
        "ls1": torch.full((d,), 1e-5), "ls2": torch.full((d,), 1e-5),
        "mlp_fc1_w": nrm(d, d * cfg.mlp_ratio), "mlp_fc1_b": zeros(d * cfg.mlp_ratio),
        "mlp_fc2_w": nrm(d * cfg.mlp_ratio, d), "mlp_fc2_b": zeros(d),
    } for _ in range(cfg.layers)]
    reassemble = []
    for i, (c, s) in enumerate(zip(cfg.neck_dims, RESIZE_FACTORS)):
        entry = {"proj_w": nrm(d, c), "proj_b": zeros(c)}
        if i < 2:
            entry.update(up_w=nrm(c, c, s, s), up_b=zeros(c))
        elif i == 3:
            entry.update(down_w=nrm(c, c, 3, 3), down_b=zeros(c))
        reassemble.append(entry)
    params = {
        "patch_embed_w": nrm(d, 3, cfg.patch, cfg.patch),
        "patch_embed_b": zeros(d),
        "cls_token": nrm(1, d),
        "pos_embed": nrm(1, 1 + cfg.pos_grid ** 2, d),
        "backbone_ln": ln(d),
        "blocks": blocks,
        "reassemble": reassemble,
        "neck_convs": [{"w": nrm(f, c, 3, 3)} for c in cfg.neck_dims],
        "fusion": [{"res1": res_unit(f), "res2": res_unit(f), "proj_w": nrm(f, f, 1, 1),
                    "proj_b": zeros(f)} for _ in range(4)],
        "head": {"conv1_w": nrm(hh, f, 3, 3), "conv1_b": zeros(hh),
                 "conv2_w": nrm(hh, hh, 3, 3), "conv2_b": zeros(hh),
                 "conv3_w": nrm(1, hh, 1, 1), "conv3_b": zeros(1)},
    }
    return tree_to(params, device)
