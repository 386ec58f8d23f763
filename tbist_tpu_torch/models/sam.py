"""Segment Anything (ViT-B), box-prompted, ported from ``tbist_tpu.models.sam``.

Architecture (sam_vit_b): a ViT-B/16 image encoder (1024² input → 64×64
grid, width 768, 12 layers, 12 heads, decomposed relative positions, 14×14
window attention except the global layers {2, 5, 8, 11}, and a neck of
conv1×1 → LN → conv3×3 → LN to 256 channels); a prompt encoder that turns a
box into two corner points with random-Fourier positions; a two-way
transformer mask decoder with two transposed-conv upscalings. Single-mask
output (mask token 0), as ``multimask_output=False``.

Parameters are plain dicts of tensors with the JAX package's keys (built by
``weights.sam``). Linear weights keep the JAX layout (in, out) and are used
as ``x @ w + b``; convolution weights are in torch's layout, (out, in, kh,
kw), and the two transposed convolutions' weights are (in, out, kh, kw),
flipped so that ``F.conv_transpose2d`` computes what the JAX package's
``lax.conv_transpose`` computes (hazard: the convT flip, ``weights/sam.py``).

Every global-attention layer on a CUDA tensor goes through kernel K4
(``kernels.sam_attn``), whatever the grid; the window layers and every CPU
tensor take the plain formulation. Tensors are NHWC at the public
functions. Encoding and decoding run under ``no_grad`` and ``full_f32``
(TF32 off, as the JAX reference computes in full f32).

The mask decoder is the published ``TwoWayTransformer``: the first two-way
block's self-attention replaces the tokens (``skip_first_layer_pe``), and
the decoder transformer's LayerNorms take eps 1e-5 (``nn.LayerNorm``); the
encoder's, the neck's and the upscaling's take 1e-6. The JAX package's
decoder adds the first block's self-attention to the tokens and takes 1e-6
throughout; ``JaxDecoderConfig`` selects that form, for the tests that hold
the port against it.
"""

from __future__ import annotations

import functools
import math
import os
from typing import Dict, NamedTuple, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from tbist_tpu_torch.kernels import sam_attn
from tbist_tpu_torch.utils.imageio import image_resize_bilinear, resolve_device
from tbist_tpu_torch.utils.logging import logger
from tbist_tpu_torch.utils.precision import full_f32

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights_cache",
)


class SamConfig(NamedTuple):
    img_size: int = 1024
    patch: int = 16
    width: int = 768
    layers: int = 12
    heads: int = 12
    window: int = 14
    global_layers: tuple = (2, 5, 8, 11)
    embed_dim: int = 256  # neck / decoder dim
    decoder_heads: int = 8
    decoder_layers: int = 2
    mlp_dim: int = 2048
    num_mask_tokens: int = 4

    # The mask decoder's form, a class attribute and not a field: the
    # fields are the model's published widths, each of which a
    # configuration file names.
    jax_decoder = False


class JaxDecoderConfig(SamConfig):
    """A ``SamConfig`` whose mask decoder takes the JAX package's form (the
    first two-way block adds its self-attention to the tokens; every
    LayerNorm takes eps 1e-6), for the tests that hold the port against
    ``tbist_tpu.models.sam``. It compares and hashes equal to the
    ``SamConfig`` of the same widths, so no cache may key on it."""

    __slots__ = ()
    jax_decoder = True


BASE = SamConfig()

DECODE_CHUNK = 64  # boxes per decoder call (see _mask_chunks)
PIXEL_MEAN = (123.675, 116.28, 103.53)
PIXEL_STD = (58.395, 57.12, 57.375)

Params = Dict[str, object]


# ---------------------------------------------------------------------------
# image encoder
# ---------------------------------------------------------------------------


def _layer_norm(x: torch.Tensor, p) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=1e-6)


def _decoder_layer_norm(x: torch.Tensor, p) -> torch.Tensor:
    """The decoder transformer's ``nn.LayerNorm``, at its default eps."""
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=1e-5)


def _resize_rows(r: torch.Tensor, rows: int) -> torch.Tensor:
    """Linear resize of a (L, dim) table along its rows: ``jax.image.resize``
    to (rows, dim), antialiased when it shrinks."""
    return image_resize_bilinear(r[None, :, None, :], (rows, 1))[0, :, 0, :]


def _get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """Decomposed rel-pos lookup (SAM semantics; assumes q_size == k_size)."""
    max_rel = 2 * max(q_size, k_size) - 1
    r = rel_pos if rel_pos.shape[0] == max_rel else _resize_rows(rel_pos, max_rel)
    q = torch.arange(q_size, device=r.device)[:, None]
    k = torch.arange(k_size, device=r.device)[None, :]
    return r[q - k + (k_size - 1)]  # (q, k, dim)


def _attn_rel(x: torch.Tensor, p, heads: int, global_attn: bool) -> torch.Tensor:
    """Windowed or global attention with decomposed relative positions.
    x: (B, H, W, C), where (H, W) is the window or the full grid."""
    b, h, w, c = x.shape
    t, d = h * w, c // heads
    qkv = x.reshape(b, t, c) @ p["qkv_w"] + p["qkv_b"]
    qkv = qkv.reshape(b, t, 3, heads, d).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, heads, T, d)

    rh = _get_rel_pos(h, h, p["rel_pos_h"])  # (h, h, d)
    rw = _get_rel_pos(w, w, p["rel_pos_w"])
    qr = q.reshape(b, heads, h, w, d)
    bias_h = torch.einsum("bnhwd,hkd->bnhwk", qr, rh)  # (B, heads, h, w, h)
    bias_w = torch.einsum("bnhwd,wkd->bnhwk", qr, rw)  # (B, heads, h, w, w)

    n = b * heads
    args = [a.reshape(n, t, -1).contiguous()
            for a in (q * d ** -0.5, k, v, bias_h, bias_w)] + [h, w]
    if global_attn:
        out = sam_attn.attention_with_rel_bias(*args)  # K4 on the card
    else:
        out = sam_attn.attention_with_rel_bias_plain(*args)
    out = out.reshape(b, heads, t, d).permute(0, 2, 1, 3).reshape(b, t, c)
    return (out @ p["proj_w"] + p["proj_b"]).reshape(b, h, w, c)


def _window_partition(x: torch.Tensor, win: int):
    """(B, H, W, C) -> (B·nh·nw, win, win, C), zero-padding H and W up to
    multiples of ``win`` (64 → 70 for the 14×14 windows); returns the
    padded size too."""
    b, h, w, c = x.shape
    ph, pw = (win - h % win) % win, (win - w % win) % win
    x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.reshape(b, hp // win, win, wp // win, win, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, win, win, c), (hp, wp)


def _window_unpartition(wins: torch.Tensor, win: int, pad_hw, hw) -> torch.Tensor:
    hp, wp = pad_hw
    h, w = hw
    b = wins.shape[0] // ((hp // win) * (wp // win))
    x = wins.reshape(b, hp // win, wp // win, win, win, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def _conv(x: torch.Tensor, weight: torch.Tensor, bias=None, stride: int = 1,
          padding: int = 0) -> torch.Tensor:
    """NHWC convolution with an (out, in, kh, kw) weight."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


def encode_image(params: Params, cfg: SamConfig, img: torch.Tensor) -> torch.Tensor:
    """img: (B, S, S, 3) pixel-normalised, S = cfg.img_size -> (B, g, g, embed_dim)."""
    with torch.no_grad(), full_f32():
        x = _conv(img, params["patch_embed_w"], params["patch_embed_b"], stride=cfg.patch)
        x = x + params["pos_embed"]
        g = cfg.img_size // cfg.patch

        for i, blk in enumerate(params["blocks"]):
            shortcut = x
            xn = _layer_norm(x, blk["ln1"])
            if i in cfg.global_layers:
                xn = _attn_rel(xn, blk["attn"], cfg.heads, global_attn=True)
            else:
                wins, pad_hw = _window_partition(xn, cfg.window)
                wins = _attn_rel(wins, blk["attn"], cfg.heads, global_attn=False)
                xn = _window_unpartition(wins, cfg.window, pad_hw, (g, g))
            x = shortcut + xn
            h = _layer_norm(x, blk["ln2"])
            h = F.gelu(h @ blk["mlp_fc1_w"] + blk["mlp_fc1_b"])  # exact (erf) GELU
            x = x + (h @ blk["mlp_fc2_w"] + blk["mlp_fc2_b"])

        # neck: conv1x1 -> LN2d -> conv3x3 -> LN2d
        x = _layer_norm(_conv(x, params["neck_conv1_w"]), params["neck_ln1"])
        x = _layer_norm(_conv(x, params["neck_conv2_w"], padding=1), params["neck_ln2"])
        return x.contiguous()


# ---------------------------------------------------------------------------
# prompt encoder + mask decoder
# ---------------------------------------------------------------------------


def _pe_encode(coords: torch.Tensor, gaussian: torch.Tensor) -> torch.Tensor:
    """Random-Fourier positional encoding of [0,1] coords (..., 2)."""
    proj = (2.0 * math.pi) * ((2.0 * coords - 1.0) @ gaussian)
    return torch.cat([torch.sin(proj), torch.cos(proj)], -1)


def _grid_pe(gaussian: torch.Tensor, size: int) -> torch.Tensor:
    xs = (torch.arange(size, dtype=torch.float32, device=gaussian.device) + 0.5) / size
    grid = torch.stack(torch.meshgrid(xs, xs, indexing="xy"), -1)  # (H, W, [x, y])
    return _pe_encode(grid, gaussian)


def _mha_split(q, k, v, p, heads: int) -> torch.Tensor:
    q = q @ p["q_w"] + p["q_b"]
    k = k @ p["k_w"] + p["k_b"]
    v = v @ p["v_w"] + p["v_b"]
    b, tq, _ = q.shape
    tk = k.shape[1]
    qh = q.reshape(b, tq, heads, -1).transpose(1, 2)
    kh = k.reshape(b, tk, heads, -1).transpose(1, 2)
    vh = v.reshape(b, tk, heads, -1).transpose(1, 2)
    logits = (qh @ kh.transpose(-1, -2)) / math.sqrt(qh.shape[-1])
    out = torch.softmax(logits, -1) @ vh
    return out.transpose(1, 2).reshape(b, tq, -1) @ p["out_w"] + p["out_b"]


def _twoway_block(queries, keys, q_pe, k_pe, p, heads: int, skip_first_pe: bool,
                  jax_form: bool = False):
    """``TwoWayAttentionBlock``; ``jax_form``: the JAX package's (see
    ``JaxDecoderConfig``)."""
    norm = _layer_norm if jax_form else _decoder_layer_norm
    # self attention on tokens: the first block's replaces them
    q = queries if skip_first_pe else queries + q_pe
    attn = _mha_split(q, q, queries, p["self_attn"], heads)
    queries = norm(attn if skip_first_pe and not jax_form else queries + attn, p["ln1"])
    # token -> image cross attention
    k = keys + k_pe
    queries = queries + _mha_split(queries + q_pe, k, keys, p["cross_t2i"], heads)
    queries = norm(queries, p["ln2"])
    # mlp
    h = torch.relu(queries @ p["mlp_fc1_w"] + p["mlp_fc1_b"])
    queries = norm(queries + (h @ p["mlp_fc2_w"] + p["mlp_fc2_b"]), p["ln3"])
    # image -> token cross attention
    keys = keys + _mha_split(k, queries + q_pe, queries, p["cross_i2t"], heads)
    return queries, norm(keys, p["ln4"])


def _mlp_stack(x: torch.Tensor, layers) -> torch.Tensor:
    for i, p in enumerate(layers):
        x = x @ p["w"] + p["b"]
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def _conv_transpose2x2(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor):
    """NHWC stride-2 2×2 transposed convolution; ``weight`` is (in, out, 2, 2)
    already flipped to the JAX package's ``lax.conv_transpose`` semantics."""
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), weight, bias, stride=2)
    return y.permute(0, 2, 3, 1)


def _decode(params: Params, cfg: SamConfig, emb: torch.Tensor,
            boxes01: torch.Tensor) -> torch.Tensor:
    """emb: (M, g, g, C), one embedding per box (an expanded view is fine);
    boxes01: (M, 4) xyxy in [0, 1]. -> (M, 4g, 4g) single-mask logits."""
    n, g = boxes01.shape[0], emb.shape[1]
    gaussian = params["pe_gaussian"]  # (2, C/2)

    # prompt encoding: the box corners as two points with type embeddings 2, 3
    sparse = _pe_encode(boxes01.reshape(n, 2, 2), gaussian) + params["point_embed"][2:4]
    output_tokens = torch.cat([params["iou_token"][None], params["mask_tokens"]], 0)
    tokens = torch.cat([output_tokens.expand(n, *output_tokens.shape), sparse], 1)

    src = (emb + params["no_mask_embed"]).reshape(n, g * g, -1)
    pos = _grid_pe(gaussian, g).reshape(1, g * g, -1).expand(n, -1, -1)

    queries, keys = tokens, src
    # the published block takes the seven arguments alone, the signature of
    # the stand-ins that the benchmark's tests put in its place
    block, norm = _twoway_block, _decoder_layer_norm
    if cfg.jax_decoder:
        block, norm = functools.partial(_twoway_block, jax_form=True), _layer_norm
    for i, blk in enumerate(params["decoder_blocks"]):
        queries, keys = block(queries, keys, tokens, pos, blk, cfg.decoder_heads,
                              skip_first_pe=(i == 0))
    # final token -> image attention
    queries = queries + _mha_split(queries + tokens, keys + pos, keys, params["final_t2i"],
                                   cfg.decoder_heads)
    queries = norm(queries, params["final_ln"])

    # upscale 4x: convT stride 2 -> LN2d -> gelu -> convT stride 2 -> gelu
    feat = keys.reshape(n, g, g, cfg.embed_dim)
    feat = _conv_transpose2x2(feat, params["upscale_conv1_w"], params["upscale_conv1_b"])
    feat = F.gelu(_layer_norm(feat, params["upscale_ln"]))
    feat = F.gelu(_conv_transpose2x2(feat, params["upscale_conv2_w"], params["upscale_conv2_b"]))

    # single-mask output: the token-0 hypernetwork
    hyper = _mlp_stack(queries[:, 1], params["hyper_mlps"][0])  # (M, C/8)
    return torch.einsum("nhwc,nc->nhw", feat, hyper)


def decode_masks(params: Params, cfg: SamConfig, image_embedding: torch.Tensor,
                 boxes01: torch.Tensor) -> torch.Tensor:
    """image_embedding: (1, g, g, C); boxes01: (N, 4) xyxy in [0, 1].
    Returns (N, 4g, 4g) single-mask logits (256×256 at the 1024² encoder)."""
    boxes01 = boxes01.to(image_embedding.device, torch.float32)
    emb = image_embedding.float()
    with torch.no_grad(), full_f32():
        return _decode(params, cfg, emb.expand(boxes01.shape[0], *emb.shape[1:]), boxes01)


# ---------------------------------------------------------------------------
# end-to-end predictor
# ---------------------------------------------------------------------------


def params_for_size(params: Params, cfg: SamConfig, img_size: int) -> Tuple[Params, SamConfig]:
    """Adapt (params, cfg) to another encoder input size.

    The checkpoint pins the encoder to cfg.img_size (1024) through its
    position grid and the global layers' relative-position tables. For a
    grid g' this resizes ``pos_embed`` bilinearly to (1, g', g', C) and each
    global layer's rel_pos_h/w linearly to 2·g'−1 rows, as the official SAM
    does for off-size inputs. Window layers keep their (2·window−1) tables;
    the decoder reads the grid from the embedding. The default size returns
    the inputs untouched. Unlike the JAX package, nothing is cached: the
    caller keeps the result."""
    if img_size == cfg.img_size:
        return params, cfg
    if img_size % cfg.patch:
        raise ValueError(f"encoder size {img_size} not a multiple of patch {cfg.patch}")
    g_new = img_size // cfg.patch
    p2 = dict(params)
    p2["pos_embed"] = image_resize_bilinear(params["pos_embed"], (g_new, g_new))
    blocks = []
    for i, blk in enumerate(params["blocks"]):
        if i in cfg.global_layers:
            attn = dict(blk["attn"])
            for name in ("rel_pos_h", "rel_pos_w"):
                attn[name] = _resize_rows(attn[name], 2 * g_new - 1)
            blk = {**blk, "attn": attn}
        blocks.append(blk)
    p2["blocks"] = blocks
    return p2, cfg._replace(img_size=img_size)


def _preprocess(frames: torch.Tensor, cfg: SamConfig):
    """(B, H, W, 3) uint8 on the device -> the normalised, padded encoder
    input and (scale, nh, nw): the longest side to cfg.img_size, normalise,
    then zero-pad bottom and right (SamPredictor's order)."""
    h, w = frames.shape[1:3]
    scale = cfg.img_size / max(h, w)
    nh, nw = int(h * scale + 0.5), int(w * scale + 0.5)
    x = image_resize_bilinear(frames.float(), (nh, nw))
    mean = torch.tensor(PIXEL_MEAN, dtype=torch.float32, device=x.device)
    std = torch.tensor(PIXEL_STD, dtype=torch.float32, device=x.device)
    x = F.pad((x - mean) / std, (0, 0, 0, cfg.img_size - nw, 0, cfg.img_size - nh))
    return x, scale, nh, nw


def _as_device_uint8(image: Union[np.ndarray, torch.Tensor], device) -> torch.Tensor:
    if isinstance(image, torch.Tensor):
        return image.to(device)
    return torch.from_numpy(np.ascontiguousarray(image)).to(device)  # uint8 upload


def _device_of(params: Params) -> torch.device:
    return params["pos_embed"].device


def encode_uint8(params: Params, cfg: SamConfig, image) -> Tuple:
    """(H, W, 3) uint8, host numpy or a tensor -> (emb (1, g, g, C) on the
    params' device, scale, nh, nw). Returns without waiting for the card."""
    x = _as_device_uint8(image, _device_of(params))[None]
    x, scale, nh, nw = _preprocess(x, cfg)
    return encode_image(params, cfg, x), scale, nh, nw


def encode_uint8_batch(params: Params, cfg: SamConfig, frames) -> Tuple:
    """Batched ``encode_uint8``: (B, H, W, 3) uint8 -> (embs (B, g, g, C),
    scale, nh, nw), one encoder call for the whole batch."""
    x, scale, nh, nw = _preprocess(_as_device_uint8(frames, _device_of(params)), cfg)
    return encode_image(params, cfg, x), scale, nh, nw


def _boxes01(boxes_xyxy, scale: float, cfg: SamConfig, device) -> torch.Tensor:
    """Pixel xyxy boxes -> [0, 1] coords of the padded square: scaled, then
    shifted by +0.5 to pixel centres (SamPromptEncoder._embed_boxes)."""
    boxes = np.asarray(boxes_xyxy, np.float32) * np.float32(scale)
    return torch.from_numpy((boxes + np.float32(0.5)) / np.float32(cfg.img_size)).to(device)


def _logits_to_masks(logits: torch.Tensor, cfg: SamConfig, nh: int, nw: int, h: int,
                     w: int) -> torch.Tensor:
    """(M, 4g, 4g) logits -> (M, h, w) bool: up to the padded square, crop
    the image's region, resize to (h, w), threshold at 0."""
    up = image_resize_bilinear(logits[..., None], (cfg.img_size, cfg.img_size))
    full = image_resize_bilinear(up[:, :nh, :nw].contiguous(), (h, w))
    return full[..., 0] > 0.0


def _mask_chunks(params: Params, cfg: SamConfig, emb, scale, nh, nw, h, w, boxes_xyxy):
    """Yield the (M, H, W) bool masks of pixel-xyxy boxes on the device,
    DECODE_CHUNK boxes at a time. A text prompt on seeded weights keeps
    hundreds of boxes, each tens of MiB of decoder activations, so the
    boxes are decoded in chunks; every caller chunks the same way, so a
    box's mask does not depend on which function asked for it."""
    boxes01 = _boxes01(boxes_xyxy, scale, cfg, emb.device)
    for i in range(0, boxes01.shape[0], DECODE_CHUNK):
        logits = decode_masks(params, cfg, emb, boxes01[i : i + DECODE_CHUNK])
        yield _logits_to_masks(logits, cfg, nh, nw, h, w)


def masks_from_embedding(params: Params, cfg: SamConfig, emb, scale, nh, nw, h, w,
                         boxes_xyxy) -> np.ndarray:
    """Decode pixel-xyxy boxes against a precomputed embedding -> host
    (N, H, W) bool."""
    chunks = list(_mask_chunks(params, cfg, emb, scale, nh, nw, h, w, boxes_xyxy))
    if not chunks:
        return np.zeros((0, h, w), bool)
    return torch.cat(chunks).cpu().numpy()


def mask_union_from_embedding(params: Params, cfg: SamConfig, emb, scale, nh, nw, h, w,
                              boxes_xyxy) -> torch.Tensor:
    """The union of the boxes' masks, (H, W) bool on the device (not
    fetched): ``masks_from_embedding(...).any(0)`` without reading back the
    per-box masks."""
    out = torch.zeros((h, w), dtype=torch.bool, device=emb.device)
    for m in _mask_chunks(params, cfg, emb, scale, nh, nw, h, w, boxes_xyxy):
        out |= m.any(0)
    return out


def masks_from_embedding_batch(params: Params, cfg: SamConfig, embs, scale, nh, nw, h, w,
                               boxes_xyxy, valid) -> torch.Tensor:
    """Batched ``masks_from_embedding``: (B, K, 4) pixel-xyxy boxes, padded
    per frame, with ``valid`` (B, K) marking the real ones, against (B, ...)
    embeddings -> (B, H, W) bool on the device (not fetched). Per frame this
    is the union of the valid boxes' masks; a frame with no valid box is all
    False. Only the valid boxes are decoded, frame by frame in the chunks of
    ``mask_union_from_embedding``, so a frame's mask is the one the single
    path gives for the same embedding."""
    boxes_xyxy, valid = np.asarray(boxes_xyxy), np.asarray(valid, bool)
    return torch.stack([
        mask_union_from_embedding(params, cfg, embs[i : i + 1], scale, nh, nw, h, w,
                                  boxes_xyxy[i][valid[i]])
        for i in range(valid.shape[0])])


def predict_boxes(params: Params, cfg: SamConfig, image: np.ndarray,
                  boxes_xyxy: np.ndarray) -> np.ndarray:
    """image: (H, W, 3) uint8 RGB; boxes in pixel xyxy -> host (N, H, W) bool.
    SamPredictor's host bookkeeping: longest side to 1024, zero-pad to the
    square, mask logits > 0."""
    h, w = image.shape[:2]
    emb, scale, nh, nw = encode_uint8(params, cfg, image)
    return masks_from_embedding(params, cfg, emb, scale, nh, nw, h, w, boxes_xyxy)


@functools.lru_cache(maxsize=1)
def get_loaded_params(device="cuda") -> Params:
    """The official checkpoint, converted (cached); raises if it is absent."""
    from tbist_tpu_torch.weights import sam as wsam

    device = resolve_device(device)
    path = os.environ.get("TBIST_SAM_PTH", os.path.join(_CACHE_DIR, "sam_vit_b_01ec64.pth"))
    if not os.path.exists(path):
        raise FileNotFoundError(f"no SAM checkpoint at {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = wsam.convert_sam_state_dict({k: v.numpy() for k, v in sd.items()})
    logger.info("SAM ViT-B: converted checkpoint from %s", path)
    return wsam.to_device(params, device)


@functools.lru_cache(maxsize=1)
def get_predictor(device="cuda"):
    return functools.partial(predict_boxes, get_loaded_params(device), BASE)
