"""GroundingDINO (SwinT-OGC), ported from the JAX package's
``models/dino.py``.

The official model (checkpoints/GroundingDINO_SwinT_OGC.py): 6 encoder and
6 decoder layers, hidden 256, 8 heads, 4 feature levels, 4 deformable
points, 900 queries, a BERT-base text encoder, text cross-attention and
image-text fusion.

* Swin-T (``models.swin``) gives 3 maps; a stride-2 3×3 conv on the last
  adds a fourth level; each is projected to 256 and GroupNormed.
* BERT-base (``models.bert``) with sub-sentence attention blocks, then the
  ``feat_map`` 768→256 projection.
* Encoder, per layer: bi-directional image↔text attention, a text
  self-attention layer, and deformable image self-attention with an FFN.
* Language-guided query selection: the 900 image tokens most similar to
  the text, initial boxes from a shared box head, learned content queries.
* Decoder, per layer: query self-attention, text cross-attention,
  deformable image cross-attention, FFN, and box refinement by a shared
  MLP; class logits are the contrastive dot with the text features.

Deformable attention samples with ``F.grid_sample`` (bilinear, zero
padding, ``align_corners=False``): the one form the GPU needs for the JAX
package's three TPU workarounds (gather, dense interp-matmul, ``lax.map``).

The forward never waits for the device: no ``.item()``, no boolean-mask
indexing, and the per-shape constants (sine embeddings, anchors, reference
points) are built on the device once per shape and cached. Run it under
``utils.precision.full_f32`` (``models.dino_sam`` does) to hold it to f32.
Parameters are the JAX package's tree as tensors (``weights.dino_convert``):
linear weights (in, out), convolution weights (out, in, kh, kw).
"""

from __future__ import annotations

import functools
import math
from typing import Dict, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from tbist_tpu_torch.models import bert as bert_lib
from tbist_tpu_torch.models import swin as swin_lib


class DinoConfig(NamedTuple):
    d_model: int = 256
    heads: int = 8
    levels: int = 4
    points: int = 4
    enc_layers: int = 6
    dec_layers: int = 6
    ffn: int = 2048
    num_queries: int = 900
    max_text_len: int = 256
    fusion_heads: int = 4
    fusion_dim: int = 1024


BASE = DinoConfig()

# [CLS], [SEP], '.', '?' in the bert-base-uncased vocab: the tokens that
# close a sub-sentence block (official groundingdino.get_tokenlizer)
SPECIAL_TOKEN_IDS = (101, 102, 1012, 1029)


def _layer_norm(x: torch.Tensor, p, eps: float = 1e-5) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=eps)


def _group_norm(x: torch.Tensor, p, groups: int = 32) -> torch.Tensor:
    """NCHW group norm, GroupNorm(32, 256) officially; tiny configs shrink
    the group count to the channel count (where ``F.group_norm`` refuses a
    1×1 map of one channel per group, which the JAX package normalises)."""
    b, c, h, w = x.shape
    xg = x.reshape(b, min(groups, c), -1)
    mean = xg.mean(-1, keepdim=True)
    var = xg.var(-1, unbiased=False, keepdim=True)
    x = ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(b, c, h, w)
    return x * p["scale"][:, None, None] + p["bias"][:, None, None]


def _mha(q, k, v, p, heads: int, bias=None) -> torch.Tensor:
    """Multi-head attention with torch's packed ``in_proj`` (q, k, v split
    along the output axis of the (d, 3d) weight)."""
    b, tq, d = q.shape
    tk = k.shape[1]
    wq, wk, wv = p["in_proj_w"].split(d, dim=1)
    bq, bk, bv = p["in_proj_b"].split(d)
    qh = (q @ wq + bq).reshape(b, tq, heads, -1).transpose(1, 2)
    kh = (k @ wk + bk).reshape(b, tk, heads, -1).transpose(1, 2)
    vh = (v @ wv + bv).reshape(b, tk, heads, -1).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(d // heads)
    if bias is not None:
        logits = logits + bias
    out = (torch.softmax(logits, -1) @ vh).transpose(1, 2).reshape(b, tq, d)
    return out @ p["out_proj_w"] + p["out_proj_b"]


# ---------------------------------------------------------------------------
# deformable attention
# ---------------------------------------------------------------------------


def deformable_attention(
    query: torch.Tensor,
    ref_points: torch.Tensor,
    value: torch.Tensor,
    spatial_shapes: Tuple[Tuple[int, int], ...],
    p: Dict,
    heads: int,
    points: int,
) -> torch.Tensor:
    """Multi-scale deformable attention (Deformable-DETR semantics).

    query: (B, Lq, D); ref_points: (B, Lq, 2) points (x, y) or (B, Lq, 4)
    cxcywh boxes, normalised; value: (B, Lv, D) flattened over the levels of
    ``spatial_shapes``. Each level is sampled by ``F.grid_sample`` at
    ``grid = 2·loc − 1`` (``align_corners=False``), i.e. at pixel
    ``loc·W − 0.5``, zero outside: the JAX package's ``_bilinear_sample``.
    """
    b, lq, d = query.shape
    levels = len(spatial_shapes)
    dh = d // heads

    v = value @ p["value_proj_w"] + p["value_proj_b"]
    offsets = (query @ p["sampling_offsets_w"] + p["sampling_offsets_b"]).reshape(
        b, lq, heads, levels, points, 2)
    weights = torch.softmax(
        (query @ p["attention_weights_w"] + p["attention_weights_b"]).reshape(
            b, lq, heads, levels * points), -1).reshape(b, lq, heads, levels, points)

    if ref_points.shape[-1] == 2:
        normalizer = _level_wh(spatial_shapes, query.device)  # (levels, 2) as (x, y)
        locs = ref_points[:, :, None, None, None, :] + offsets / normalizer[:, None, :]
    else:
        xy = ref_points[..., None, None, None, :2]
        wh = ref_points[..., None, None, None, 2:]
        locs = xy + offsets / points * wh * 0.5
    # (B, Lq, heads, levels, points, 2) -> per level (B·heads, Lq, points, 2)
    grids = (2.0 * locs - 1.0).permute(0, 2, 3, 1, 4, 5).reshape(b * heads, levels, lq, points, 2)
    w_all = weights.permute(0, 2, 3, 1, 4).reshape(b * heads, levels, 1, lq, points)

    out = None
    start = 0
    for li, (hl, wl) in enumerate(spatial_shapes):
        vl = v[:, start : start + hl * wl].reshape(b, hl, wl, heads, dh)
        vl = vl.permute(0, 3, 4, 1, 2).reshape(b * heads, dh, hl, wl)
        sampled = F.grid_sample(vl, grids[:, li], mode="bilinear", padding_mode="zeros",
                                align_corners=False)  # (B·heads, dh, Lq, points)
        term = (sampled * w_all[:, li]).sum(-1)  # (B·heads, dh, Lq)
        out = term if out is None else out + term
        start += hl * wl
    out = out.reshape(b, heads, dh, lq).permute(0, 3, 1, 2).reshape(b, lq, d)
    return out @ p["output_proj_w"] + p["output_proj_b"]


@functools.lru_cache(maxsize=None)
def _level_wh(spatial_shapes, device: torch.device) -> torch.Tensor:
    return torch.tensor([[wl, hl] for (hl, wl) in spatial_shapes], dtype=torch.float32,
                        device=device)


# ---------------------------------------------------------------------------
# fusion (bi-directional image<->text attention)
# ---------------------------------------------------------------------------


def bi_attention(img, text, text_mask, p, cfg: DinoConfig):
    """BiMultiHeadAttention: one joint attention map, image→text and
    text→image updates with per-branch LN and learned layer-scale gammas.

    The residuals add onto the LAYER-NORMED features (official
    BiAttentionBlock). The logits are stabilised by their max over both the
    image and the text axes; padded text gets −1e9 in the image→text
    softmax."""
    b, li, _ = img.shape
    lt = text.shape[1]
    h = cfg.fusion_heads
    dh = cfg.fusion_dim // h

    vi = _layer_norm(img, p["ln_v"])
    tx = _layer_norm(text, p["ln_l"])

    def split(x, t):
        return x.reshape(b, t, h, dh).transpose(1, 2)

    qh = split((vi @ p["v_proj_w"] + p["v_proj_b"]) * dh**-0.5, li)
    kh = split(tx @ p["l_proj_w"] + p["l_proj_b"], lt)
    vvh = split(vi @ p["values_v_w"] + p["values_v_b"], li)
    vlh = split(tx @ p["values_l_w"] + p["values_l_b"], lt)

    logits = qh @ kh.transpose(-1, -2)  # (B, h, Li, Lt)
    logits = logits - logits.amax(dim=(-2, -1), keepdim=True)
    tmask = (1.0 - text_mask[:, None, None, :]) * -1e9
    attn_i = torch.softmax(logits + tmask, -1)
    attn_t = torch.softmax(logits.transpose(-1, -2), -1)

    di = (attn_i @ vlh).transpose(1, 2).reshape(b, li, cfg.fusion_dim)
    dt = (attn_t @ vvh).transpose(1, 2).reshape(b, lt, cfg.fusion_dim)
    img = vi + p["gamma_v"] * (di @ p["out_v_w"] + p["out_v_b"])
    text = tx + p["gamma_l"] * (dt @ p["out_l_w"] + p["out_l_b"])
    return img, text


# ---------------------------------------------------------------------------
# position embeddings and per-shape constants
# ---------------------------------------------------------------------------


def _sine_pos_2d(h: int, w: int, d: int, device, temp_h=20.0, temp_w=20.0) -> torch.Tensor:
    """(H*W, D) sine embedding, PositionEmbeddingSineHW with the config's
    temperatures (pe_temperatureH/W = 20)."""
    half = d // 2
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 1.0) / h * (2 * math.pi)
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 1.0) / w * (2 * math.pi)
    dim_t = torch.arange(half // 2, dtype=torch.float32, device=device)

    def emb(vals, temp):
        ang = vals[:, None] / temp ** (2 * dim_t / half)[None, :]
        return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(vals.shape[0], -1)

    ey, ex = emb(ys, temp_h), emb(xs, temp_w)  # (H, half), (W, half)
    return torch.cat([ey[:, None, :].expand(h, w, half), ex[None, :, :].expand(h, w, half)],
                     -1).reshape(h * w, d)


def _sine_pos_1d(coords: torch.Tensor, d: int = 128, temp: float = 10000.0) -> torch.Tensor:
    """(...,) coords in [0, 1] -> (..., d) sine embedding (DETR box PE)."""
    dim_t = temp ** (2 * torch.arange(d // 2, dtype=torch.float32, device=coords.device) / d)
    ang = (coords[..., None] * (2 * math.pi)) / dim_t
    return torch.stack([torch.sin(ang), torch.cos(ang)], -1).reshape(*coords.shape, d)


def _box_pe(boxes: torch.Tensor, d_model: int) -> torch.Tensor:
    """cxcywh (..., 4) -> (..., 2·d_model), in the order pos(y), pos(x),
    pos(w), pos(h) (official gen_sineembed_for_position swaps x and y)."""
    return torch.cat([_sine_pos_1d(boxes[..., i], d_model // 2) for i in (1, 0, 2, 3)], -1)


def _centers(h: int, w: int, device) -> torch.Tensor:
    """(H*W, 2) pixel centres (x, y) normalised to [0, 1]."""
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1).reshape(-1, 2)


@functools.lru_cache(maxsize=8)
def _shape_constants(spatial_shapes, d_model: int, device: torch.device):
    """Per-shape constants, built once: the levels' sine embeddings (without
    the learned level embeddings), the encoder's reference points (Lv, 2),
    and the anchors' validity (Lv,) and logits (Lv, 4). Anchors are grid
    centres with a level-dependent size, valid only inside (0.01, 0.99)
    (generate_encoder_output_proposals); invalid ones get +inf logits."""
    pos = [_sine_pos_2d(h, w, d_model, device) for (h, w) in spatial_shapes]
    refs = torch.cat([_centers(h, w, device) for (h, w) in spatial_shapes], 0)
    anchors = torch.cat([
        torch.cat([_centers(h, w, device),
                   torch.full((h * w, 2), 0.05 * (2.0**lvl), device=device)], -1)
        for lvl, (h, w) in enumerate(spatial_shapes)], 0)
    valid = ((anchors > 0.01) & (anchors < 0.99)).all(-1)
    logits = torch.where(valid[:, None], torch.log(anchors / (1.0 - anchors)),
                         torch.full_like(anchors, math.inf))
    return pos, refs, valid, logits


def build_text_token_masks(input_ids: torch.Tensor, special_ids=SPECIAL_TOKEN_IDS):
    """Sub-sentence self-attention masks and restarted position ids.

    The vectorised equivalent of the official
    ``generate_masks_with_special_tokens_and_transfer_map``: tokens between
    consecutive special tokens attend only within their block (the closing
    special token included); a special token at position 0 or T-1 attends
    only to itself; position ids restart at 0 inside each block.
    Returns (attend (B, T, T) bool, position_ids (B, T) int64)."""
    b, t = input_ids.shape
    special = torch.zeros_like(input_ids, dtype=torch.bool)
    for sid in special_ids:
        special = special | (input_ids == sid)
    # position 0 is an implicit block boundary: the first block begins at 1
    special[:, 0] = True
    idx = torch.arange(t, device=input_ids.device).expand(b, t)

    # next special at or after i (t if none); previous special strictly before i
    nxt = torch.where(special, idx, t).flip(-1).cummin(-1).values.flip(-1)
    prev = torch.where(special, idx, -1).cummax(-1).values
    prev = torch.cat([torch.full_like(prev[:, :1], -1), prev[:, :-1]], -1)

    # a block is only "closed" by a special token at an interior position
    interior = (nxt > 0) & (nxt < t - 1)
    attend = (nxt[:, :, None] == nxt[:, None, :]) & interior[:, :, None]
    attend = attend | torch.eye(t, dtype=torch.bool, device=input_ids.device)[None]
    position_ids = torch.where(interior, idx - prev - 1, 0)
    return attend, position_ids


def _mlp(x: torch.Tensor, layers) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(eps, 1 - eps)
    return torch.log(x / (1 - x))


def select_topk(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The k highest scores' indices, as the JAX package's
    ``argsort(scores)[:, ::-1][:, :k]``: a stable ascending sort reversed,
    so that tied scores go to the higher index first."""
    return torch.argsort(scores, dim=-1, stable=True).flip(-1)[:, :k]


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------


def _text_self_bias(input_ids: torch.Tensor):
    attend, position_ids = build_text_token_masks(input_ids)
    return (1.0 - attend.float()[:, None]) * -1e9, position_ids  # (B, 1, T, T)


def encode_text(params, cfg: DinoConfig, input_ids: torch.Tensor, text_mask: torch.Tensor,
                bert_cfg: bert_lib.BertConfig = bert_lib.BASE) -> torch.Tensor:
    """The prompt-only prefix of the forward: BERT-base with the sub-sentence
    attention mask, then the 768→256 ``feat_map``. It depends on no image,
    so ``models.dino_sam`` caches it per prompt. Returns (B, T, 256)."""
    bias, position_ids = _text_self_bias(input_ids)
    text_h = bert_lib.forward(params["bert"], bert_cfg, input_ids, text_mask.float(),
                              position_ids=position_ids, attention_bias=bias)
    return text_h @ params["feat_map_w"] + params["feat_map_b"]


def forward(
    params,
    cfg: DinoConfig,
    image: torch.Tensor,
    input_ids: torch.Tensor,
    text_mask: torch.Tensor,
    swin_cfg: swin_lib.SwinConfig = swin_lib.TINY,
    bert_cfg: bert_lib.BertConfig = bert_lib.BASE,
    text_feats: torch.Tensor = None,
) -> Dict[str, torch.Tensor]:
    """image: (B, H, W, 3) ImageNet-normalised (H, W multiples of 32);
    input_ids, text_mask: (B, T). Returns "pred_logits" (B, Q, T) and
    "pred_boxes" (B, Q, 4 cxcywh), as the JAX package does, and the query
    selection: "topk_index" (B, Q), the chosen image tokens, and
    "topk_scores" (B, Q), their similarity to the text. ``text_feats``
    optionally supplies a precomputed ``encode_text`` result."""
    b = image.shape[0]
    dev = image.device
    # ---- backbone + projections ----
    feats = [f.permute(0, 3, 1, 2) for f in swin_lib.forward(params["swin"], swin_cfg, image)]
    srcs = [_group_norm(F.conv2d(f, params["input_proj"][i]["w"], params["input_proj"][i]["b"]),
                        params["input_proj"][i]["gn"]) for i, f in enumerate(feats)]
    # torch Conv2d(k=3, s=2, p=1) pads 1 on both sides, as the JAX package does
    extra = F.conv2d(feats[-1], params["input_proj"][3]["w"], params["input_proj"][3]["b"],
                     stride=2, padding=1)
    srcs.append(_group_norm(extra, params["input_proj"][3]["gn"]))

    spatial_shapes = tuple((s.shape[2], s.shape[3]) for s in srcs)
    pos, enc_ref, anchor_valid, anchor_logits = _shape_constants(spatial_shapes, cfg.d_model,
                                                                 dev)
    img = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)  # (B, Lv, D)
    pos_flat = torch.cat([pe + params["level_embed"][li] for li, pe in enumerate(pos)], 0)[None]

    # ---- text ----
    text_self_bias, position_ids = _text_self_bias(input_ids)
    if text_feats is None:
        text_feats = encode_text(params, cfg, input_ids, text_mask, bert_cfg)
    text = text_feats  # (B, T, 256)
    tmaskf = text_mask.float()
    # sine embedding of the raw restarted position ids (temperature 10000)
    text_pos = _sine_pos_1d(position_ids.float(), cfg.d_model)

    # ---- encoder ----
    enc_ref = enc_ref[None].expand(b, -1, -1)
    for li in range(cfg.enc_layers):
        img, text = bi_attention(img, text, tmaskf, params["fusion_layers"][li], cfg)

        tl = params["text_layers"][li]
        q = text + text_pos
        # text-enhance layers: heads // 2 and the sub-sentence block mask
        text = _layer_norm(text + _mha(q, q, text, tl["self_attn"], cfg.heads // 2,
                                       bias=text_self_bias), tl["ln1"])
        hft = torch.relu(text @ tl["fc1_w"] + tl["fc1_b"])
        text = _layer_norm(text + (hft @ tl["fc2_w"] + tl["fc2_b"]), tl["ln2"])

        el = params["enc_layers"][li]
        img2 = deformable_attention(img + pos_flat, enc_ref, img, spatial_shapes, el["deform"],
                                    cfg.heads, cfg.points)
        img = _layer_norm(img + img2, el["ln1"])
        hfi = torch.relu(img @ el["fc1_w"] + el["fc1_b"])
        img = _layer_norm(img + (hfi @ el["fc2_w"] + el["fc2_b"]), el["ln2"])

    # ---- language-guided query selection ----
    # invalid anchors' image tokens are zeroed before enc_output (official
    # masked_fill(~valid, 0.0)); their +inf logits make their boxes 1.0
    enc_out = _layer_norm(
        torch.where(anchor_valid[None, :, None], img, 0.0) @ params["enc_output_w"]
        + params["enc_output_b"], params["enc_output_ln"])
    sim = torch.where(tmaskf[:, None, :] > 0, enc_out @ text.transpose(1, 2), -math.inf)
    scores = sim.amax(-1)  # (B, Lv)
    topk = select_topk(scores, cfg.num_queries)

    sel = torch.gather(enc_out, 1, topk[..., None].expand(-1, -1, cfg.d_model))
    sel_anchor = anchor_logits[topk]  # (B, Q, 4)
    ref_boxes = torch.sigmoid(_mlp(sel, params["enc_bbox_mlp"]) + sel_anchor)
    queries = params["tgt_embed"][None].expand(b, -1, -1)

    # ---- decoder ----
    text_bias = (1.0 - tmaskf[:, None, None, :]) * -1e9
    ref_prev = ref_boxes  # refs INPUT to the last layer (final box head)
    for li in range(cfg.dec_layers):
        dl = params["dec_layers"][li]
        qpe = _mlp(_box_pe(ref_boxes, cfg.d_model), params["ref_point_head"])
        q = queries + qpe
        queries = _layer_norm(queries + _mha(q, q, queries, dl["self_attn"], cfg.heads),
                              dl["ln_self"])
        queries = _layer_norm(queries + _mha(queries + qpe, text, text, dl["text_cross"],
                                             cfg.heads, bias=text_bias), dl["ln_text"])
        q2 = deformable_attention(queries + qpe, ref_boxes, img, spatial_shapes, dl["deform"],
                                  cfg.heads, cfg.points)
        queries = _layer_norm(queries + q2, dl["ln_cross"])
        hf = torch.relu(queries @ dl["fc1_w"] + dl["fc1_b"])
        queries = _layer_norm(queries + (hf @ dl["fc2_w"] + dl["fc2_b"]), dl["ln_ffn"])
        # iterative refinement from the UN-normed layer output (shared head)
        ref_prev = ref_boxes
        ref_boxes = torch.sigmoid(_mlp(queries, params["bbox_mlp"])
                                  + _inverse_sigmoid(ref_boxes))

    # ---- outputs ----
    # final boxes from the LAYER-NORMED last state and the refs INPUT to the
    # last layer (official outputs_coord_list); logits are the plain dot
    queries = _layer_norm(queries, params["dec_norm"])
    pred_boxes = torch.sigmoid(_mlp(queries, params["bbox_mlp"]) + _inverse_sigmoid(ref_prev))
    logits = torch.where(tmaskf[:, None, :] > 0, queries @ text.transpose(1, 2), -math.inf)
    return {"pred_logits": logits, "pred_boxes": pred_boxes, "topk_index": topk,
            "topk_scores": torch.gather(scores, 1, topk)}
