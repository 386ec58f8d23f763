"""Plain Depth-Anything-V2-Small (Yang et al., arXiv:2406.09414): a DINOv2
ViT-S/14 encoder and a DPT neck and head, in NCHW with
``torch.nn.functional`` alone, as Hugging Face's
``DepthAnythingForDepthEstimation`` computes it.

Weights are the tree the benchmark made (linear weights (in, out) used as
``x @ w + b``; convolutions (out, in, kh, kw); the two reassemble
transposed convolutions (in, out, k, k)). The position table is used at its
own grid, so the input side must be ``pos_grid`` patches. Convolutions pad
as XLA's "SAME" (the JAX package's definition): the stride-2 reassemble
convolution on an even grid pads (0, 1).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
FACTORS = (4, 2, 1, 2)


def _same_conv(x, w, b=None, stride=1):
    k = w.shape[-1]
    pads = []
    for n in x.shape[2:]:
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads.append((total // 2, total - total // 2))
    (top, bottom), (left, right) = pads
    return F.conv2d(F.pad(x, (left, right, top, bottom)), w, b, stride=stride)


def _ln(x, p):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=1e-6)


def _block(x, blk, heads: int):
    b, t, d = x.shape
    h = _ln(x, blk["ln1"])
    qkv = (h @ blk["attn"]["qkv_w"] + blk["attn"]["qkv_b"]).reshape(b, t, 3, heads, d // heads)
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d / heads), dim=-1)
    a = (attn @ v).transpose(1, 2).reshape(b, t, d)
    x = x + (a @ blk["attn"]["proj_w"] + blk["attn"]["proj_b"]) * blk["ls1"]
    h = F.gelu(_ln(x, blk["ln2"]) @ blk["mlp_fc1_w"] + blk["mlp_fc1_b"])
    return x + (h @ blk["mlp_fc2_w"] + blk["mlp_fc2_b"]) * blk["ls2"]


def _encode(params, da: Dict, x: torch.Tensor) -> List[torch.Tensor]:
    """Hidden states after each of ``out_layers`` through the final norm."""
    g = x.shape[-1] // da["patch"]
    if g != da["pos_grid"]:
        raise ValueError(f"input grid {g} is not the position table's {da['pos_grid']}")
    tok = F.conv2d(x, params["patch_embed_w"], params["patch_embed_b"], stride=da["patch"])
    tok = tok.flatten(2).transpose(1, 2)
    cls = params["cls_token"].reshape(1, 1, -1).expand(x.shape[0], 1, -1)
    h = torch.cat([cls, tok], dim=1) + params["pos_embed"]
    states = []
    for blk in params["blocks"]:
        h = _block(h, blk, da["heads"])
        states.append(h)
    return [_ln(states[i - 1], params["backbone_ln"]) for i in da["out_layers"]]


def _unit(x, p):
    h = _same_conv(F.relu(x), p["conv1_w"], p["conv1_b"])
    return x + _same_conv(F.relu(h), p["conv2_w"], p["conv2_b"])


def _head(params, da: Dict, states, g: int, size: int) -> torch.Tensor:
    feats = []
    for i, hs in enumerate(states):
        rs = params["reassemble"][i]
        f = hs[:, 1:] @ rs["proj_w"] + rs["proj_b"]
        f = f.transpose(1, 2).reshape(hs.shape[0], -1, g, g)
        if "up_w" in rs:
            f = F.conv_transpose2d(f, rs["up_w"], rs["up_b"], stride=FACTORS[i])
        elif "down_w" in rs:
            f = _same_conv(f, rs["down_w"], rs["down_b"], stride=FACTORS[i])
        feats.append(_same_conv(f, params["neck_convs"][i]["w"]))
    x = None
    for i in reversed(range(4)):
        p = params["fusion"][3 - i]
        x = _unit(feats[i], p["res2"]) if x is None else _unit(x + _unit(feats[i], p["res1"]),
                                                              p["res2"])
        target = feats[i - 1].shape[2:] if i > 0 else (2 * x.shape[2], 2 * x.shape[3])
        x = F.interpolate(x, size=tuple(target), mode="bilinear", align_corners=True)
        x = _same_conv(x, p["proj_w"], p["proj_b"])
    hd = params["head"]
    x = _same_conv(x, hd["conv1_w"], hd["conv1_b"])
    x = F.interpolate(x, size=(size, size), mode="bilinear", align_corners=True)
    x = F.relu(_same_conv(x, hd["conv2_w"], hd["conv2_b"]))
    return F.relu(_same_conv(x, hd["conv3_w"], hd["conv3_b"]))


def depth(params, da: Dict, image: torch.Tensor) -> torch.Tensor:
    """(1, 3, H, W) image in [0, 1] -> (H, W) relative depth: resized to the
    model's square input, normalized with ImageNet's statistics, and the
    depth resized back; both resizes bilinear, antialiased on a shrink."""
    size = da["input_size"]
    h, w = image.shape[2:]
    x = F.interpolate(image, size=(size, size), mode="bilinear", align_corners=False,
                      antialias=True)
    mean = torch.tensor(IMAGENET_MEAN, device=x.device).reshape(1, 3, 1, 1)
    std = torch.tensor(IMAGENET_STD, device=x.device).reshape(1, 3, 1, 1)
    x = (x - mean) / std
    d = _head(params, da, _encode(params, da, x), size // da["patch"], size)
    d = F.interpolate(d, size=(h, w), mode="bilinear", align_corners=False, antialias=True)
    return d[0, 0]
