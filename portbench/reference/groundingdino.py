"""GroundingDINO SwinT-OGC, written plainly from the published model
(arXiv:2303.05499; IDEA-Research/GroundingDINO, ``GroundingDINO_SwinT_OGC.py``,
``groundingdino/models/GroundingDINO``), for the check of the location
cell. Plain PyTorch in the dtype of its inputs; the caller sets the
precision (``reference.gatys.precision``). It imports nothing of the port
and takes nothing the port made: its parameters are the benchmark's seeded
tree (``weights.groundingdino``), laid out as the port's loader keeps a
checkpoint (linear weights (in, out), convolutions (out, in, kh, kw)).

The forward follows the published modules one for one: Swin-T (window 7,
shifted windows with the -100 mask on the padded grid, relative-position
bias, patch merging), BERT-base with the sub-sentence attention mask and
restarted position ids (``generate_masks_with_special_tokens_and_transfer_map``),
the 768 -> 256 ``feat_map``, the three projections and the stride-2 fourth
level with GroupNorm(32), the sine position embeddings (temperature 20,
and 10000 for text and boxes), six encoder layers of fusion
(``BiAttentionBlock``), text enhancement and deformable self-attention,
the two-stage query selection (``gen_encoder_output_proposals``, the
contrastive class score, top 900), six decoder layers of self-attention,
text cross-attention and deformable cross-attention with box refinement,
and the final contrastive logits and boxes. Deformable attention is the
published PyTorch fallback, ``ms_deform_attn_core_pytorch``: one
``grid_sample`` a level.

Departures from the published code, each with the reason:

- the sine embedding of the feature maps leaves out the published
  ``eps = 1e-6`` in ``y / (H + eps)``, as the JAX package the port follows
  does (a shift of 1e-6 / H in the angles);
- the fusion attention is a plain softmax: the published stabilising
  shifts by a maximum and the clamps at +-50000 change no finite softmax;
- the logits are returned for the prompt's T tokens only: the published
  model pads them to 256 with -inf, which no threshold passes;
- ``topk``, when given, replaces the query selection's own top 900, so
  that the decoder can follow the program's selection where two scores lie
  within rounding of each other (``select`` returns the scores that judge
  it).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

SWIN = {"embed_dim": 96, "depths": (2, 2, 6, 2), "heads": (3, 6, 12, 24), "window": 7}
DINO = {"d_model": 256, "heads": 8, "levels": 4, "points": 4, "enc_layers": 6,
        "dec_layers": 6, "num_queries": 900, "fusion_heads": 4, "fusion_dim": 1024}
BERT_HEADS = 12
SPECIAL = ("[CLS]", "[SEP]", ".", "?")
BOX_THRESHOLD, TEXT_THRESHOLD = 0.3, 0.5
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------


def tokenize(prompt: str, vocab: Dict[str, int]) -> List[int]:
    """bert-base-uncased's tokens of the caption the detector is given: the
    prompt lower-cased with a closing '.', each punctuation mark its own
    token, between [CLS] and [SEP]; a word the vocabulary lacks is [UNK]."""
    text = prompt.lower().strip()
    if not text.endswith("."):
        text += "."
    words: List[str] = []
    for chunk in text.split():
        cur = ""
        for ch in chunk:
            if ch.isalnum():
                cur += ch
                continue
            if cur:
                words.append(cur)
                cur = ""
            words.append(ch)
        if cur:
            words.append(cur)
    unk = vocab["[UNK]"]
    return [vocab["[CLS]"]] + [vocab.get(w, unk) for w in words] + [vocab["[SEP]"]]


def sub_sentence_masks(ids: Sequence[int], vocab: Dict[str, int]) -> Tuple[torch.Tensor,
                                                                            torch.Tensor]:
    """(attend (T, T) bool, position ids (T,)): the published loop of
    ``generate_masks_with_special_tokens_and_transfer_map``."""
    special = {vocab[s] for s in SPECIAL if s in vocab}
    t = len(ids)
    attend = torch.eye(t, dtype=torch.bool)
    pos = torch.zeros(t, dtype=torch.long)
    prev = 0
    for col, tok in enumerate(ids):
        if tok not in special:
            continue
        if col == 0 or col == t - 1:
            attend[col, col] = True
            pos[col] = 0
        else:
            attend[prev + 1:col + 1, prev + 1:col + 1] = True
            pos[prev + 1:col + 1] = torch.arange(0, col - prev)
        prev = col
    return attend, pos


def _ln(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=eps)


def _attend(q, k, v, heads: int, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled dot-product attention over (B, T, D) projections; ``mask``
    True where a query may look (broadcast to (B, heads, Tq, Tk))."""
    b, tq, d = q.shape
    tk = k.shape[1]
    qh = q.reshape(b, tq, heads, -1).transpose(1, 2)
    kh = k.reshape(b, tk, heads, -1).transpose(1, 2)
    vh = v.reshape(b, tk, heads, -1).transpose(1, 2)
    logits = qh @ kh.transpose(-1, -2) / math.sqrt(d // heads)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return (torch.softmax(logits, -1) @ vh).transpose(1, 2).reshape(b, tq, d)


def bert(p: Dict, ids: torch.Tensor, attend: torch.Tensor, pos: torch.Tensor,
         heads: int = BERT_HEADS) -> torch.Tensor:
    """BERT-base's sequence output, (1, T, 768), under the sub-sentence mask."""
    x = p["word_emb"][ids] + p["pos_emb"][pos] + p["type_emb"][0]
    x = _ln(x[None], p["emb_ln"], 1e-12)
    for blk in p["blocks"]:
        ctx = _attend(x @ blk["q_w"] + blk["q_b"], x @ blk["k_w"] + blk["k_b"],
                      x @ blk["v_w"] + blk["v_b"], heads, attend[None, None])
        x = _ln(x + ctx @ blk["o_w"] + blk["o_b"], blk["attn_ln"], 1e-12)
        x = _ln(x + F.gelu(x @ blk["fc1_w"] + blk["fc1_b"]) @ blk["fc2_w"] + blk["fc2_b"],
                blk["ffn_ln"], 1e-12)
    return x


# ---------------------------------------------------------------------------
# Swin-T
# ---------------------------------------------------------------------------


def _rel_index(win: int) -> torch.Tensor:
    coords = torch.stack(torch.meshgrid(torch.arange(win), torch.arange(win), indexing="ij"))
    flat = coords.flatten(1)
    rel = (flat[:, :, None] - flat[:, None, :]).permute(1, 2, 0) + (win - 1)
    return rel[:, :, 0] * (2 * win - 1) + rel[:, :, 1]


def _shift_mask(hp: int, wp: int, win: int, shift: int, device) -> torch.Tensor:
    img = torch.zeros(hp, wp, device=device)
    cnt = 0
    for hs in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
        for ws in (slice(0, -win), slice(-win, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    wins = img.reshape(hp // win, win, wp // win, win).permute(0, 2, 1, 3).reshape(-1, win * win)
    diff = wins[:, None, :] - wins[:, :, None]
    return torch.where(diff != 0, -100.0, 0.0)


def _swin_block(x, p, h, w, heads, win, shift):
    b, _, c = x.shape
    shortcut = x
    x = _ln(x, p["ln1"], 1e-5).reshape(b, h, w, c)
    pb, pr = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pr, 0, pb))
    hp, wp = h + pb, w + pr
    if shift:
        x = torch.roll(x, (-shift, -shift), (1, 2))
    wins = x.reshape(b, hp // win, win, wp // win, win, c).permute(0, 1, 3, 2, 4, 5)
    wins = wins.reshape(-1, win * win, c)
    n, t, _ = wins.shape
    a = p["attn"]
    qkv = (wins @ a["qkv_w"] + a["qkv_b"]).reshape(n, t, 3, heads, c // heads).permute(2, 0, 3,
                                                                                         1, 4)
    q, k, v = qkv[0] * (c // heads) ** -0.5, qkv[1], qkv[2]
    attn = q @ k.transpose(-1, -2)
    bias = a["rel_bias_table"][_rel_index(win).reshape(-1).to(x.device)].reshape(t, t, heads)
    attn = attn + bias.permute(2, 0, 1)[None]
    if shift:
        m = _shift_mask(hp, wp, win, shift, x.device).to(attn.dtype)
        attn = (attn.reshape(b, -1, heads, t, t) + m[None, :, None]).reshape(n, heads, t, t)
    out = (torch.softmax(attn, -1) @ v).transpose(1, 2).reshape(n, t, c)
    out = out @ a["proj_w"] + a["proj_b"]
    out = out.reshape(b, hp // win, wp // win, win, win, c).permute(0, 1, 3, 2, 4, 5)
    out = out.reshape(b, hp, wp, c)
    if shift:
        out = torch.roll(out, (shift, shift), (1, 2))
    x = shortcut + out[:, :h, :w].reshape(b, h * w, c)
    y = F.gelu(_ln(x, p["ln2"], 1e-5) @ p["mlp_fc1_w"] + p["mlp_fc1_b"])
    return x + y @ p["mlp_fc2_w"] + p["mlp_fc2_b"]


def swin(p: Dict, img: torch.Tensor, cfg: Dict = SWIN) -> List[torch.Tensor]:
    """(1, 3, H, W) normalised -> the LayerNormed NCHW maps of stages 2-4."""
    x = F.conv2d(img, p["patch_embed_w"], p["patch_embed_b"], stride=4)
    b, c, h, w = x.shape
    x = _ln(x.flatten(2).transpose(1, 2), p["patch_embed_ln"], 1e-5)
    outs = []
    for si, stage in enumerate(p["stages"]):
        for bi, blk in enumerate(stage["blocks"]):
            x = _swin_block(x, blk, h, w, cfg["heads"][si], cfg["window"],
                            0 if bi % 2 == 0 else cfg["window"] // 2)
        if si >= 1:
            y = _ln(x, p[f"out_ln{si}"], 1e-5)
            outs.append(y.transpose(1, 2).reshape(b, -1, h, w))
        if "downsample" in stage:
            c = x.shape[-1]
            g = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
            g = torch.cat([g[:, 0::2, 0::2], g[:, 1::2, 0::2], g[:, 0::2, 1::2],
                           g[:, 1::2, 1::2]], -1)
            h, w = g.shape[1], g.shape[2]
            x = _ln(g.reshape(b, h * w, 4 * c), stage["downsample"]["ln"], 1e-5)
            x = x @ stage["downsample"]["reduction_w"]
    return outs


# ---------------------------------------------------------------------------
# transformer parts
# ---------------------------------------------------------------------------


def _group_norm(x, p, groups: int = 32):
    """GroupNorm(32, C), eps 1e-5, written out (``F.group_norm`` refuses a
    1 x 1 map of one channel a group, which a tiny test configuration has)."""
    b, c, h, w = x.shape
    g = x.reshape(b, min(groups, c), -1)
    g = (g - g.mean(-1, keepdim=True)) / torch.sqrt(g.var(-1, unbiased=False, keepdim=True)
                                                     + 1e-5)
    return g.reshape(b, c, h, w) * p["scale"][:, None, None] + p["bias"][:, None, None]


def _sine(vals: torch.Tensor, feats: int, temp: float) -> torch.Tensor:
    """(...,) already scaled angles' bases -> (..., feats): sin and cos of
    vals / temp^(2 floor(i/2) / feats), interleaved."""
    i = torch.arange(feats, dtype=vals.dtype, device=vals.device)
    dim_t = temp ** (2 * torch.div(i, 2, rounding_mode="floor") / feats)
    a = vals[..., None] / dim_t
    return torch.stack((a[..., 0::2].sin(), a[..., 1::2].cos()), -1).flatten(-2)


def _pos_2d(h, w, d, dtype, device):
    """PositionEmbeddingSineHW, normalised, temperatures 20 (no eps)."""
    y = torch.arange(1, h + 1, dtype=dtype, device=device) / h * 2 * math.pi
    x = torch.arange(1, w + 1, dtype=dtype, device=device) / w * 2 * math.pi
    py, px = _sine(y, d // 2, 20.0), _sine(x, d // 2, 20.0)
    return torch.cat([py[:, None].expand(h, w, -1), px[None].expand(h, w, -1)], -1).reshape(
        h * w, d)


def _box_embed(boxes: torch.Tensor, d: int) -> torch.Tensor:
    """gen_sineembed_for_position of cxcywh boxes: pos(y), pos(x), pos(w), pos(h)."""
    s = 2 * math.pi
    return torch.cat([_sine(boxes[..., i] * s, d // 2, 10000.0) for i in (1, 0, 2, 3)], -1)


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-3) -> torch.Tensor:
    x = x.clamp(min=0, max=1)
    return torch.log(x.clamp(min=eps) / (1 - x).clamp(min=eps))


def _mha(q, k, v, p, heads, mask=None):
    d = q.shape[-1]
    wq, wk, wv = p["in_proj_w"].split(d, dim=1)
    bq, bk, bv = p["in_proj_b"].split(d)
    out = _attend(q @ wq + bq, k @ wk + bk, v @ wv + bv, heads, mask)
    return out @ p["out_proj_w"] + p["out_proj_b"]


def _mlp(x, layers):
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def ms_deform_attn_core(value, shapes, locations, weights):
    """The published ``ms_deform_attn_core_pytorch``: value (N, S, M, D),
    locations (N, Lq, M, L, P, 2), weights (N, Lq, M, L, P) -> (N, Lq, M*D)."""
    n, _, m, d = value.shape
    _, lq, _, lv, pts, _ = locations.shape
    values = value.split([h * w for h, w in shapes], dim=1)
    grids = 2 * locations - 1
    sampled = []
    for lid, (h, w) in enumerate(shapes):
        v = values[lid].flatten(2).transpose(1, 2).reshape(n * m, d, h, w)
        g = grids[:, :, :, lid].transpose(1, 2).flatten(0, 1)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))
    w = weights.transpose(1, 2).reshape(n * m, 1, lq, lv * pts)
    out = (torch.stack(sampled, dim=-2).flatten(-2) * w).sum(-1).view(n, m * d, lq)
    return out.transpose(1, 2)


def deform_attn(query, refs, value, shapes, p, heads: int, points: int):
    """MSDeformAttn: refs (N, Lq, 2) points or (N, Lq, 4) boxes, the same
    at every level (every valid ratio is 1)."""
    n, lq, d = query.shape
    lv = len(shapes)
    v = (value @ p["value_proj_w"] + p["value_proj_b"]).reshape(n, -1, heads, d // heads)
    off = (query @ p["sampling_offsets_w"] + p["sampling_offsets_b"]).reshape(
        n, lq, heads, lv, points, 2)
    aw = torch.softmax((query @ p["attention_weights_w"] + p["attention_weights_b"]).reshape(
        n, lq, heads, lv * points), -1).reshape(n, lq, heads, lv, points)
    if refs.shape[-1] == 2:
        norm = torch.tensor([[w, h] for h, w in shapes], dtype=query.dtype, device=query.device)
        loc = refs[:, :, None, None, None, :] + off / norm[None, None, None, :, None, :]
    else:
        loc = (refs[:, :, None, None, None, :2]
               + off / points * refs[:, :, None, None, None, 2:] * 0.5)
    out = ms_deform_attn_core(v, shapes, loc, aw)
    return out @ p["output_proj_w"] + p["output_proj_b"]


def fusion(img, text, p, heads: int, dim: int):
    """BiAttentionBlock: both sides LayerNormed, one attention map, the
    layer-scaled updates added onto the normed features."""
    v, l = _ln(img, p["ln_v"], 1e-5), _ln(text, p["ln_l"], 1e-5)
    b, li, _ = v.shape
    lt = l.shape[1]
    dh = dim // heads

    def split(x, t):
        return x.reshape(b, t, heads, dh).transpose(1, 2)

    q = split((v @ p["v_proj_w"] + p["v_proj_b"]) * dh ** -0.5, li)
    k = split(l @ p["l_proj_w"] + p["l_proj_b"], lt)
    vv = split(v @ p["values_v_w"] + p["values_v_b"], li)
    vl = split(l @ p["values_l_w"] + p["values_l_b"], lt)
    a = q @ k.transpose(-1, -2)
    dv = (torch.softmax(a, -1) @ vl).transpose(1, 2).reshape(b, li, dim)
    dl = (torch.softmax(a.transpose(-1, -2), -1) @ vv).transpose(1, 2).reshape(b, lt, dim)
    return (v + p["gamma_v"] * (dv @ p["out_v_w"] + p["out_v_b"]),
            l + p["gamma_l"] * (dl @ p["out_l_w"] + p["out_l_b"]))


def _centers(h, w, dtype, device):
    ys = (torch.arange(h, dtype=dtype, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=dtype, device=device) + 0.5) / w
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return torch.stack([gx, gy], -1).reshape(-1, 2)


# ---------------------------------------------------------------------------
# the detector
# ---------------------------------------------------------------------------


def detect(p: Dict, image_u8: torch.Tensor, det_hw: Tuple[int, int], prompt: str,
           vocab: Dict[str, int], topk: Optional[torch.Tensor] = None,
           cfg: Dict = DINO, swin_cfg: Dict = SWIN, dtype=torch.float32) -> Dict:
    """The detector on an (H, W, 3) uint8 image resized to ``det_hw``
    (bilinear, antialiased where it shrinks, as ``jax.image.resize``) and
    ImageNet-normalised. Returns ``logits`` (Q, T), ``boxes`` (Q, 4 cxcywh),
    ``scores`` (Lv,) of the query selection, ``topk`` (Q,) its choice (the
    given one where ``topk`` is given) and ``ids``."""
    dev = image_u8.device
    d, heads = cfg["d_model"], cfg["heads"]
    x = image_u8.to(dtype).permute(2, 0, 1)[None] / 255.0
    x = F.interpolate(x, size=tuple(det_hw), mode="bilinear", align_corners=False,
                      antialias=True)
    mean = torch.tensor(MEAN, dtype=dtype, device=dev)[None, :, None, None]
    std = torch.tensor(STD, dtype=dtype, device=dev)[None, :, None, None]
    feats = swin(p["swin"], (x - mean) / std, swin_cfg)
    srcs = [_group_norm(F.conv2d(f, p["input_proj"][i]["w"], p["input_proj"][i]["b"]),
                        p["input_proj"][i]["gn"]) for i, f in enumerate(feats)]
    srcs.append(_group_norm(F.conv2d(feats[-1], p["input_proj"][3]["w"],
                                     p["input_proj"][3]["b"], stride=2, padding=1),
                            p["input_proj"][3]["gn"]))
    shapes = [(s.shape[2], s.shape[3]) for s in srcs]
    img = torch.cat([s.flatten(2).transpose(1, 2) for s in srcs], 1)
    pos = torch.cat([_pos_2d(h, w, d, dtype, dev) + p["level_embed"][i]
                     for i, (h, w) in enumerate(shapes)], 0)[None]
    enc_ref = torch.cat([_centers(h, w, dtype, dev) for h, w in shapes], 0)[None]

    ids = tokenize(prompt, vocab)
    attend, tpos = sub_sentence_masks(ids, vocab)
    ids_t, attend, tpos = (torch.tensor(ids, device=dev), attend.to(dev), tpos.to(dev))
    text = bert(p["bert"], ids_t, attend, tpos, cfg.get("bert", {}).get("heads", BERT_HEADS))
    text = text @ p["feat_map_w"] + p["feat_map_b"]
    text_pos = _sine(tpos.to(dtype)[None] * 2 * math.pi, d, 10000.0)

    for li in range(cfg["enc_layers"]):
        img, text = fusion(img, text, p["fusion_layers"][li], cfg["fusion_heads"],
                           cfg["fusion_dim"])
        tl = p["text_layers"][li]
        q = text + text_pos
        text = _ln(text + _mha(q, q, text, tl["self_attn"], heads // 2, attend[None, None]),
                   tl["ln1"], 1e-5)
        text = _ln(text + torch.relu(text @ tl["fc1_w"] + tl["fc1_b"]) @ tl["fc2_w"]
                   + tl["fc2_b"], tl["ln2"], 1e-5)
        el = p["enc_layers"][li]
        img = _ln(img + deform_attn(img + pos, enc_ref, img, shapes, el["deform"], heads,
                                    cfg["points"]), el["ln1"], 1e-5)
        img = _ln(img + torch.relu(img @ el["fc1_w"] + el["fc1_b"]) @ el["fc2_w"] + el["fc2_b"],
                  el["ln2"], 1e-5)

    # gen_encoder_output_proposals and the two-stage selection
    props = torch.cat([torch.cat([_centers(h, w, dtype, dev),
                                  torch.full((h * w, 2), 0.05 * 2.0 ** lvl, dtype=dtype,
                                             device=dev)], -1)
                       for lvl, (h, w) in enumerate(shapes)], 0)
    valid = ((props > 0.01) & (props < 0.99)).all(-1)
    props = torch.log(props / (1 - props)).masked_fill(~valid[:, None], float("inf"))
    memory = img[0].masked_fill(~valid[:, None], 0.0)
    memory = _ln(memory @ p["enc_output_w"] + p["enc_output_b"], p["enc_output_ln"], 1e-5)
    scores = (memory @ text[0].T).max(-1).values
    if topk is None:
        topk = torch.argsort(scores, stable=True).flip(0)[:cfg["num_queries"]]
    topk = topk.to(dev)
    refs = torch.sigmoid(_mlp(memory[topk], p["enc_bbox_mlp"]) + props[topk])[None]
    queries = p["tgt_embed"][None]

    ref_in = refs
    for li in range(cfg["dec_layers"]):
        dl = p["dec_layers"][li]
        qpos = _mlp(_box_embed(refs, d), p["ref_point_head"])
        q = queries + qpos
        queries = _ln(queries + _mha(q, q, queries, dl["self_attn"], heads), dl["ln_self"], 1e-5)
        queries = _ln(queries + _mha(queries + qpos, text, text, dl["text_cross"], heads),
                      dl["ln_text"], 1e-5)
        queries = _ln(queries + deform_attn(queries + qpos, refs, img, shapes, dl["deform"],
                                            heads, cfg["points"]), dl["ln_cross"], 1e-5)
        queries = _ln(queries + torch.relu(queries @ dl["fc1_w"] + dl["fc1_b"]) @ dl["fc2_w"]
                      + dl["fc2_b"], dl["ln_ffn"], 1e-5)
        ref_in = refs
        refs = torch.sigmoid(_mlp(queries, p["bbox_mlp"]) + inverse_sigmoid(refs))
    hs = _ln(queries, p["dec_norm"], 1e-5)
    boxes = torch.sigmoid(_mlp(hs, p["bbox_mlp"]) + inverse_sigmoid(ref_in))
    logits = hs @ text.transpose(1, 2)
    return {"logits": logits[0], "boxes": boxes[0], "scores": scores, "topk": topk, "ids": ids}


def kept(logits: torch.Tensor) -> torch.Tensor:
    """(Q,) bool: the queries whose best token's score passes the box
    threshold and whose phrase (tokens 1 to 254 above the text threshold)
    is not empty, as the location path keeps them."""
    s = torch.sigmoid(logits.double())
    t = s.shape[1]
    return (s.max(1).values > BOX_THRESHOLD) & (s[:, 1:min(t, 255)] > TEXT_THRESHOLD).any(1)


def detection_size(h: int, w: int, size: int = 800, max_size: int = 1333) -> Tuple[int, int]:
    """RandomResize([800], max_size=1333), each side rounded to a multiple
    of 32 as the location path sizes the detector's input."""
    scale = size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    return max(32, round(nh / 32) * 32), max(32, round(nw / 32) * 32)
