"""Segment Anything ViT-B, box-prompted, written plainly from the published
model (arXiv:2304.02643; facebookresearch/segment-anything, ``sam_vit_b``:
``image_encoder.py``, ``prompt_encoder.py``, ``mask_decoder.py``,
``transformer.py``, ``predictor.py``), for the check of the location cell.
Plain PyTorch in the dtype of its inputs; the caller sets the precision.
It imports nothing of the port; its parameters are the benchmark's seeded
tree (``weights.sam``), laid out as the port's loader keeps a checkpoint
(linear weights (in, out), convolutions (out, in, kh, kw), the transposed
convolutions (in, out, kh, kw) as ``F.conv_transpose2d`` takes them, each
global layer's relative-position tables at 2 x 64 - 1 rows as in
``sam_vit_b``).

The image encoder's attention is the plain softmax of the published
``Attention`` with ``add_decomposed_rel_pos``, at every layer: the
14 x 14 windows (the grid zero-padded to 70 after ``norm1``) and the
global layers 2, 5, 8 and 11 alike. The mask decoder is the published
``TwoWayTransformer`` and ``MaskDecoder`` with ``multimask_output=False``
(mask token 0): the first block's self-attention replaces the tokens (no
residual, ``skip_first_layer_pe``), its LayerNorms take eps 1e-5 as
``nn.LayerNorm`` does, the upscaling's ``LayerNorm2d`` 1e-6.

Departures from the published code, each with the reason:

- a box is scaled by the one factor 1024 / max(H, W) before the +0.5 of
  ``_embed_boxes``, where ``ResizeLongestSide.apply_boxes`` scales x and y
  by the rounded sides' own ratios: the location path's documented sizing
  (a shift of at most half a pixel at 1024);
- the masks go back to the image by bilinear resizes antialiased where they
  shrink (``jax.image.resize``, the sizing the location path states),
  where ``postprocess_masks`` interpolates without antialiasing.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

SAM = {"img_size": 1024, "patch": 16, "heads": 12, "window": 14,
       "global_layers": (2, 5, 8, 11), "decoder_heads": 8}
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=eps)


def _resize(x: torch.Tensor, hw) -> torch.Tensor:
    """NCHW bilinear, half-pixel centres, antialiased where it shrinks."""
    return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False,
                         antialias=True)


def preprocess(image_u8: torch.Tensor, cfg: Dict = SAM) -> Tuple[torch.Tensor, float, int,
                                                                   int]:
    """(H, W, 3) uint8 -> the encoder's (1, 3, S, S) input and (scale, nh,
    nw): the longest side to S, normalised, zero-padded bottom and right."""
    h, w = image_u8.shape[:2]
    s = cfg["img_size"]
    scale = s / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    x = _resize(image_u8.float().permute(2, 0, 1)[None], (nh, nw))
    mean = torch.tensor(PIXEL_MEAN, device=x.device)[None, :, None, None]
    std = torch.tensor(PIXEL_STD, device=x.device)[None, :, None, None]
    return F.pad((x - mean) / std, (0, s - nw, 0, s - nh)), scale, nh, nw


def _rel_pos(q: int, k: int, table: torch.Tensor) -> torch.Tensor:
    """``get_rel_pos``: the table, linearly resized to 2 max(q, k) - 1 rows
    where it has another length, read at each (query, key) offset."""
    n = 2 * max(q, k) - 1
    if table.shape[0] != n:
        table = F.interpolate(table.T[None], size=n, mode="linear")[0].T
    qc = torch.arange(q, device=table.device)[:, None] * max(k / q, 1.0)
    kc = torch.arange(k, device=table.device)[None, :] * max(q / k, 1.0)
    return table[((qc - kc) + (k - 1) * max(q / k, 1.0)).long()]


def _attention(x: torch.Tensor, p: Dict, heads: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, H, W, C): the published ``Attention`` with the
    decomposed relative positions."""
    b, h, w, c = x.shape
    qkv = (x.reshape(b, h * w, c) @ p["qkv_w"] + p["qkv_b"]).reshape(b, h * w, 3, heads, -1)
    q, k, v = qkv.permute(2, 0, 3, 1, 4).reshape(3, b * heads, h * w, -1).unbind(0)
    d = q.shape[-1]
    attn = (q * d ** -0.5) @ k.transpose(-1, -2)
    rq = q.reshape(b * heads, h, w, d)
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, _rel_pos(h, h, p["rel_pos_h"]))
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, _rel_pos(w, w, p["rel_pos_w"]))
    attn = (attn.view(b * heads, h, w, h, w) + rel_h[:, :, :, :, None]
            + rel_w[:, :, :, None, :]).view(b * heads, h * w, h * w)
    out = (torch.softmax(attn, -1) @ v).view(b, heads, h, w, d).permute(0, 2, 3, 1, 4)
    return out.reshape(b, h, w, c) @ p["proj_w"] + p["proj_b"]


def encode(p: Dict, x: torch.Tensor, cfg: Dict = SAM) -> torch.Tensor:
    """(1, 3, S, S) -> the (1, 256, g, g) image embedding."""
    x = F.conv2d(x, p["patch_embed_w"], p["patch_embed_b"], stride=cfg["patch"])
    x = x.permute(0, 2, 3, 1) + p["pos_embed"]
    g, win = x.shape[1], cfg["window"]
    for i, blk in enumerate(p["blocks"]):
        shortcut = x
        y = _ln(x, blk["ln1"], 1e-6)
        if i in cfg["global_layers"]:
            y = _attention(y, blk["attn"], cfg["heads"])
        else:
            pad = (win - g % win) % win
            y = F.pad(y, (0, 0, 0, pad, 0, pad))
            gp = g + pad
            c = y.shape[-1]
            wins = y.reshape(1, gp // win, win, gp // win, win, c).permute(0, 1, 3, 2, 4, 5)
            wins = _attention(wins.reshape(-1, win, win, c), blk["attn"], cfg["heads"])
            y = wins.reshape(1, gp // win, gp // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
            y = y.reshape(1, gp, gp, c)[:, :g, :g]
        x = shortcut + y
        x = x + F.gelu(_ln(x, blk["ln2"], 1e-6) @ blk["mlp_fc1_w"] + blk["mlp_fc1_b"]) \
            @ blk["mlp_fc2_w"] + blk["mlp_fc2_b"]
    x = F.conv2d(x.permute(0, 3, 1, 2), p["neck_conv1_w"])
    x = _ln(x.permute(0, 2, 3, 1), p["neck_ln1"], 1e-6).permute(0, 3, 1, 2)
    x = F.conv2d(x, p["neck_conv2_w"], padding=1)
    return _ln(x.permute(0, 2, 3, 1), p["neck_ln2"], 1e-6).permute(0, 3, 1, 2)


def _pe(coords: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    c = (2 * coords - 1) @ gaussian * (2 * math.pi)
    return torch.cat([torch.sin(c), torch.cos(c)], -1)


def _attn(q, k, v, p, heads: int):
    """The decoder's ``Attention`` (its inner width may be downsampled)."""
    q, k, v = q @ p["q_w"] + p["q_b"], k @ p["k_w"] + p["k_b"], v @ p["v_w"] + p["v_b"]
    b, n, c = q.shape

    def split(x):
        return x.reshape(b, x.shape[1], heads, c // heads).transpose(1, 2)

    qh, kh, vh = split(q), split(k), split(v)
    a = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(c // heads), -1)
    return (a @ vh).transpose(1, 2).reshape(b, n, c) @ p["out_w"] + p["out_b"]


def two_way(p: Dict, tokens: torch.Tensor, keys: torch.Tensor, key_pe: torch.Tensor,
            heads: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The published ``TwoWayTransformer``: (N, tokens, C) prompt tokens and
    (N, g*g, C) image keys with their position embedding -> the tokens and
    keys after its blocks and the final token-to-image attention."""
    queries = tokens
    for i, blk in enumerate(p["decoder_blocks"]):
        if i == 0:  # skip_first_layer_pe: the attention replaces the tokens
            queries = _attn(queries, queries, queries, blk["self_attn"], heads)
        else:
            q = queries + tokens
            queries = queries + _attn(q, q, queries, blk["self_attn"], heads)
        queries = _ln(queries, blk["ln1"], 1e-5)
        queries = _ln(queries + _attn(queries + tokens, keys + key_pe, keys, blk["cross_t2i"],
                                      heads), blk["ln2"], 1e-5)
        mlp = torch.relu(queries @ blk["mlp_fc1_w"] + blk["mlp_fc1_b"]) @ blk["mlp_fc2_w"]
        queries = _ln(queries + mlp + blk["mlp_fc2_b"], blk["ln3"], 1e-5)
        keys = _ln(keys + _attn(keys + key_pe, queries + tokens, queries, blk["cross_i2t"],
                                heads), blk["ln4"], 1e-5)
    queries = _ln(queries + _attn(queries + tokens, keys + key_pe, keys, p["final_t2i"], heads),
                  p["final_ln"], 1e-5)
    return queries, keys


def decode(p: Dict, emb: torch.Tensor, boxes01: torch.Tensor, cfg: Dict = SAM) -> torch.Tensor:
    """emb (1, 256, g, g), boxes (N, 4) xyxy already in [0, 1] of the padded
    square -> (N, 4g, 4g) low-resolution mask logits of mask token 0."""
    n, heads = boxes01.shape[0], cfg["decoder_heads"]
    c, g = emb.shape[1], emb.shape[2]
    gauss = p["pe_gaussian"]
    sparse = _pe(boxes01.reshape(n, 2, 2), gauss) + p["point_embed"][2:4]
    out_tokens = torch.cat([p["iou_token"][None], p["mask_tokens"]], 0)
    tokens = torch.cat([out_tokens[None].expand(n, -1, -1), sparse], 1)
    src = (emb + p["no_mask_embed"][None, :, None, None]).expand(n, -1, -1, -1)
    keys = src.flatten(2).transpose(1, 2)
    xs = (torch.arange(g, dtype=emb.dtype, device=emb.device) + 0.5) / g
    grid = torch.stack(torch.meshgrid(xs, xs, indexing="xy"), -1)
    key_pe = _pe(grid, gauss).reshape(1, g * g, c)
    queries, keys = two_way(p, tokens, keys, key_pe, heads)
    feat = keys.transpose(1, 2).reshape(n, c, g, g)
    feat = F.conv_transpose2d(feat, p["upscale_conv1_w"], p["upscale_conv1_b"], stride=2)
    feat = F.gelu(_ln(feat.permute(0, 2, 3, 1), p["upscale_ln"], 1e-6).permute(0, 3, 1, 2))
    feat = F.gelu(F.conv_transpose2d(feat, p["upscale_conv2_w"], p["upscale_conv2_b"],
                                     stride=2))
    hyper = queries[:, 1]
    for i, layer in enumerate(p["hyper_mlps"][0]):
        hyper = hyper @ layer["w"] + layer["b"]
        if i < len(p["hyper_mlps"][0]) - 1:
            hyper = torch.relu(hyper)
    return torch.einsum("nc,nchw->nhw", hyper, feat)


def boxes01(boxes_xyxy: torch.Tensor, scale: float, cfg: Dict = SAM) -> torch.Tensor:
    """Pixel xyxy boxes -> the prompt encoder's [0, 1] corners: scaled to
    the encoder's side, shifted by half a pixel, over the side."""
    s = torch.tensor(scale, dtype=torch.float32)
    return (boxes_xyxy.float().cpu() * s + 0.5) / cfg["img_size"]


def full_logits(low: torch.Tensor, nh: int, nw: int, h: int, w: int,
                cfg: Dict = SAM) -> torch.Tensor:
    """(N, 4g, 4g) -> (N, H, W) mask logits over the image: up to the padded
    square, the image's region, then to the image's size."""
    up = _resize(low[:, None], (cfg["img_size"], cfg["img_size"]))
    return _resize(up[:, :, :nh, :nw].contiguous(), (h, w))[:, 0]
