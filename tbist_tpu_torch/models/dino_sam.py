"""Text → binary mask: GroundingDINO detection + SAM segmentation, ported
from the JAX package's ``models/dino_sam.py``.

Capability parity with text/TextMaskExtractor.py:25-68:
* detect boxes for the prompt (with '.' appended), keep those whose
  sigmoid logit passes BOX_THRESHOLD = 0.3, then the tokens above
  TEXT_THRESHOLD = 0.5 form each box's phrase;
* cxcywh in [0, 1] → pixel xyxy;
* zero detections → an all-False (H, W) mask;
* SAM masks for all boxes, united into one bool mask.

The chain keeps the JAX package's order (PARITY.md:18): the uint8 frame is
uploaded once, DINO is queued, SAM's image encoder is queued behind it, and
only then are DINO's logits read back. The host's thresholding and phrase
decoding run while the card works.

It needs the official checkpoints (weights_cache/groundingdino_swint_ogc.pth
or ``TBIST_DINO_PTH``, and SAM's) and a BERT vocab (weights_cache/
bert_vocab.txt or ``TBIST_BERT_VOCAB``); ``effects.masking`` falls back to a
deterministic extractor when any is missing. Nothing here imports the JAX
package: the tokenizer, ``_detection_size`` and the thresholds are copies.
"""

from __future__ import annotations

import functools
import os
import unicodedata
from typing import Callable, List, Tuple, Union

import numpy as np
import torch

from tbist_tpu_torch.models import dino as dino_lib
from tbist_tpu_torch.models import sam as sam_lib
from tbist_tpu_torch.utils.imageio import image_resize_bilinear, resolve_device
from tbist_tpu_torch.utils.logging import logger
from tbist_tpu_torch.utils.precision import full_f32

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights_cache",
)

# GroundingDINO preprocess (groundingdino_text_object_detector.py:43-49):
# RandomResize([800], max_size=1333) + ImageNet normalize, the resized shape
# bucketed to multiples of 32 as the JAX package does
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
BOX_THRESHOLD = 0.3
TEXT_THRESHOLD = 0.5

ImageLike = Union[np.ndarray, torch.Tensor]


def _detection_size(h: int, w: int, size=800, max_size=1333) -> Tuple[int, int]:
    short, long = min(h, w), max(h, w)
    scale = size / short
    if long * scale > max_size:
        scale = max_size / long
    nh, nw = int(round(h * scale)), int(round(w * scale))
    # multiples of 32; Python's round rounds half to even, as in the JAX package
    return max(32, round(nh / 32) * 32), max(32, round(nw / 32) * 32)


# ---------------------------------------------------------------------------
# tokenizer (HF BertTokenizer, uncased) and phrases
# ---------------------------------------------------------------------------


def _is_punctuation(ch: str) -> bool:
    """HF BertTokenizer punctuation test: ASCII symbol ranges + Unicode P*."""
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


def _basic_tokenize(text: str) -> List[str]:
    """HF BasicTokenizer (uncased): clean, isolate CJK chars, lowercase,
    strip accents (NFD, drop Mn), split on punctuation."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in ("Cc", "Cf"):
            if ch not in ("\t", "\n", "\r"):
                continue
        if ch.isspace() or ch in ("\t", "\n", "\r"):
            cleaned.append(" ")
        elif _is_cjk(cp):
            cleaned.extend((" ", ch, " "))
        else:
            cleaned.append(ch)
    out: List[str] = []
    for token in "".join(cleaned).split():
        token = token.lower()
        token = "".join(
            c for c in unicodedata.normalize("NFD", token) if unicodedata.category(c) != "Mn"
        )
        # split on punctuation, keeping each punctuation char as its own token
        word: List[str] = []
        for ch in token:
            if _is_punctuation(ch):
                if word:
                    out.append("".join(word))
                    word = []
                out.append(ch)
            else:
                word.append(ch)
        if word:
            out.append("".join(word))
    return out


def _wordpiece(word: str, vocab: dict) -> List[str]:
    """HF WordpieceTokenizer: greedy longest-match; any unmatched remainder
    turns the WHOLE word into [UNK] (not just the tail)."""
    if len(word) > 100:
        return ["[UNK]"]
    pieces: List[str] = []
    start = 0
    while start < len(word):
        end = len(word)
        piece = None
        while start < end:
            sub = word[start:end]
            if start > 0:
                sub = "##" + sub
            if sub in vocab:
                piece = sub
                break
            end -= 1
        if piece is None:
            return ["[UNK]"]
        pieces.append(piece)
        start = end
    return pieces


def _simple_bert_tokenize(prompt: str, vocab: dict) -> List[int]:
    """Uncased BERT tokenization: [CLS] BasicTokenizer→WordPiece [SEP],
    e.g. 'boat.' → [CLS] boat . [SEP]."""
    unk = vocab.get("[UNK]", 100)
    ids = [vocab["[CLS]"]]
    for word in _basic_tokenize(prompt):
        for piece in _wordpiece(word, vocab):
            ids.append(vocab.get(piece, unk))
    ids.append(vocab["[SEP]"])
    return ids


def _decode_phrase(token_ids: List[int], inv_vocab: dict) -> str:
    """HF ``tokenizer.decode`` for wordpiece ids: '##' pieces merge into the
    previous token, others join with spaces, then the standard
    clean_up_tokenization fixes (official get_phrases_from_posmap)."""
    words: List[str] = []
    for tid in token_ids:
        tok = inv_vocab.get(tid, "[UNK]")
        if tok.startswith("##") and words:
            words[-1] += tok[2:]
        else:
            words.append(tok)
    out = " ".join(words)
    for a, b in (
        (" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","), (" ' ", "'"),
        (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"), (" 've", "'ve"),
        (" 're", "'re"),
    ):
        out = out.replace(a, b)
    return out


@functools.lru_cache(maxsize=1)
def _load_vocab():
    path = os.environ.get("TBIST_BERT_VOCAB", os.path.join(_CACHE_DIR, "bert_vocab.txt"))
    if not os.path.exists(path):
        raise FileNotFoundError(f"no BERT vocab at {path}")
    with open(path) as f:
        return {tok.rstrip("\n"): i for i, tok in enumerate(f)}


_INV_VOCAB_CACHE: list = []  # [(vocab, inverse)], identity-keyed, tiny


def _inv_vocab(vocab: dict) -> dict:
    """Inverse id→token map, cached per vocab object (inverting the 30k-entry
    vocab per call would be host work inside the window the overlap hides)."""
    for v, inv in _INV_VOCAB_CACHE:
        if v is vocab:
            return inv
    inv = {i: tok for tok, i in vocab.items()}
    if len(_INV_VOCAB_CACHE) >= 4:
        _INV_VOCAB_CACHE.clear()
    _INV_VOCAB_CACHE.append((vocab, inv))
    return inv


def filter_phrases(logits: np.ndarray, ids: List[int], inv_vocab: dict
                   ) -> Tuple[np.ndarray, List[str]]:
    """get_phrases_from_posmap over box-level sigmoid scores.

    ``logits`` is (N, T) for N boxes that passed BOX_THRESHOLD. Per box the
    tokens above TEXT_THRESHOLD form the phrase, except position 0 ([CLS])
    and positions >= 255; an empty phrase drops the box. Returns (keep bool
    (N,), the kept boxes' phrases with '(score)' suffixes)."""
    logits = np.array(logits)
    phrases, keep = [], np.zeros(logits.shape[0], bool)
    for i, row in enumerate(logits):
        token_keep = row > TEXT_THRESHOLD
        token_keep[0] = False
        token_keep[255:] = False
        phrase = _decode_phrase([ids[j] for j in np.where(token_keep)[0]], inv_vocab)
        if phrase:
            # the reference formats the score as str(x)[:4]: "(0.53)", "(0.5)"
            phrases.append(phrase + f"({str(float(row.max()))[:4]})")
            keep[i] = True
    return keep, phrases


def _boxes_to_xyxy(boxes: np.ndarray, h: int, w: int) -> np.ndarray:
    """cxcywh [0,1] -> xyxy pixels (TextMaskExtractor.py:55-59)."""
    b = boxes * np.array([w, h, w, h], np.float32)
    return np.stack([b[:, 0] - b[:, 2] / 2, b[:, 1] - b[:, 3] / 2,
                     b[:, 0] + b[:, 2] / 2, b[:, 1] + b[:, 3] / 2], axis=1)


def preprocess_image(image, resize: bool = False, square: bool = False, height: int = 512,
                     width: int = 512, left: int = 0, right: int = 0, top: int = 0,
                     bottom: int = 0, return_offsets: bool = False):
    """Crop / square / resize preprocessing on the host (TextMaskExtractor.
    _preprocess_image, text/TextMaskExtractor.py:70-131): crop
    ``left/right/top/bottom`` pixels, optionally centre-crop to a square,
    optionally resize to (height, width). Returns (H, W, 3) uint8 RGB, and
    with ``return_offsets`` also (oy, ox, ph, pw): the crop's top-left corner
    in the original frame and the pre-resize crop shape. The JAX package's
    two intended divergences from the reference are kept (PARITY.md): top is
    clamped by h-1, and the resize yields an actual height×width image."""
    if isinstance(image, str):
        from PIL import Image

        image = np.array(Image.open(image).convert("RGB"))
    else:
        image = np.asarray(image)
    if image.ndim == 2:
        image = np.stack([image] * 3, axis=-1)
    image = image[:, :, :3]
    h, w = image.shape[:2]
    left = min(left, w - 1)
    right = min(right, w - left - 1)
    top = min(top, h - 1)
    bottom = min(bottom, h - top - 1)
    image = image[top : h - bottom, left : w - right]
    oy, ox = top, left
    h, w = image.shape[:2]
    if square:
        if h < w:
            off = (w - h) // 2
            image = image[:, off : off + h]
            ox += off
        elif w < h:
            off = (h - w) // 2
            image = image[off : off + w]
            oy += off
    ph, pw = image.shape[:2]
    if resize:
        x = image_resize_bilinear(torch.from_numpy(np.array(image, np.float32))[None],
                                  (height, width))[0]
        image = torch.clamp(torch.round(x), 0, 255).to(torch.uint8).numpy()
    image = np.ascontiguousarray(image)
    if return_offsets:
        return image, (oy, ox, ph, pw)
    return image


# ---------------------------------------------------------------------------
# device side
# ---------------------------------------------------------------------------

# (params id, vocab id, prompt, cfg, bert_cfg) -> ((ids, input_ids, text_mask,
# text features), params, vocab). A video calls detect() once per frame with
# the same prompt; the BERT prefix depends on no image (dino.encode_text), so
# it runs once. Entries hold strong refs to their params and vocab, so that
# neither id can be recycled while the entry lives; code that swaps params
# calls clear_text_feature_cache() to release the old tree's memory.
_TEXT_FEAT_CACHE: dict = {}


def clear_text_feature_cache() -> None:
    """Drop cached text features (releases the params they pin)."""
    _TEXT_FEAT_CACHE.clear()


def _params_device(dino_params) -> torch.device:
    return dino_params["level_embed"].device


def _text_features(dino_params, prompt: str, vocab: dict, cfg=None, bert_cfg=None):
    cfg = cfg or dino_lib.BASE
    key = (id(dino_params), id(vocab), prompt, cfg, bert_cfg)
    hit = _TEXT_FEAT_CACHE.get(key)
    if hit is not None:
        return hit[0]
    ids = _simple_bert_tokenize(prompt, vocab)
    input_ids = torch.tensor([ids], dtype=torch.long, device=_params_device(dino_params))
    text_mask = torch.ones_like(input_ids)
    kw = {} if bert_cfg is None else {"bert_cfg": bert_cfg}
    with torch.no_grad(), full_f32():
        feats = dino_lib.encode_text(dino_params, cfg, input_ids, text_mask, **kw)
    entry = (ids, input_ids, text_mask, feats)
    if len(_TEXT_FEAT_CACHE) > 64:
        _TEXT_FEAT_CACHE.clear()
    _TEXT_FEAT_CACHE[key] = (entry, dino_params, vocab)
    return entry


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device: torch.device):
    # built once per device, so that a dispatch makes no host-to-device copy
    return (torch.tensor(IMAGENET_MEAN, device=device),
            torch.tensor(IMAGENET_STD, device=device))


def _dino_forward(dino_params, frames_dev: torch.Tensor, ids_mask_feats, det_hw, cfg,
                  swin_cfg, bert_cfg):
    """(B, H, W, 3) uint8 on the device -> DINO's outputs, queued only."""
    _, input_ids, text_mask, text_feats = ids_mask_feats
    b = frames_dev.shape[0]
    mean, std = _imagenet_stats(frames_dev.device)
    kw = {k: v for k, v in (("swin_cfg", swin_cfg), ("bert_cfg", bert_cfg)) if v is not None}
    with torch.no_grad(), full_f32():
        x = image_resize_bilinear(frames_dev.float() / 255.0, det_hw)
        x = (x - mean) / std
        return dino_lib.forward(dino_params, cfg, x, input_ids.expand(b, -1),
                                text_mask.expand(b, -1), text_feats=text_feats.expand(b, -1, -1),
                                **kw)


def _detect_dispatch(dino_params, img_dev: torch.Tensor, prompt: str, vocab: dict, cfg=None,
                     swin_cfg=None, bert_cfg=None, det_hw=None):
    """Queue the GroundingDINO forward on an (H, W, 3) uint8 device image;
    return (ids, outputs) without waiting for the card, so that the caller
    can queue more work (SAM's encoder) before the read-back. The cfg and
    det_hw overrides let tiny seeded configs drive the production chain."""
    cfg = cfg or dino_lib.BASE
    if not prompt.endswith("."):
        prompt = prompt + "."
    text = _text_features(dino_params, prompt, vocab, cfg=cfg, bert_cfg=bert_cfg)
    h, w = img_dev.shape[:2]
    det_hw = det_hw or _detection_size(h, w)
    return text[0], _dino_forward(dino_params, img_dev[None], text, det_hw, cfg, swin_cfg,
                                  bert_cfg)


def _detect_collect(ids, out, vocab) -> Tuple[np.ndarray, List[str]]:
    """Read DINO's outputs back, threshold, and decode the phrases."""
    logits = torch.sigmoid(out["pred_logits"][0]).cpu().numpy()  # (Q, T)
    boxes = out["pred_boxes"][0].cpu().numpy()  # (Q, 4)
    keep = logits.max(axis=1) > BOX_THRESHOLD
    keep2, phrases = filter_phrases(logits[keep], ids, _inv_vocab(vocab))
    return boxes[keep][keep2], phrases


def detect(dino_params, image: ImageLike, prompt: str, **cfg_kw) -> Tuple[np.ndarray, List[str]]:
    """(H, W, 3) uint8 RGB + prompt -> (boxes cxcywh in [0, 1], phrases)."""
    vocab = cfg_kw.pop("vocab", None) or _load_vocab()
    img_dev = sam_lib._as_device_uint8(image, _params_device(dino_params))
    ids, out = _detect_dispatch(dino_params, img_dev, prompt, vocab, **cfg_kw)
    return _detect_collect(ids, out, vocab)


def _detect_dispatch_batch(dino_params, frames_dev: torch.Tensor, prompt: str, vocab: dict,
                           cfg=None, swin_cfg=None, bert_cfg=None, det_hw=None):
    """Queue ONE GroundingDINO forward over a (B, H, W, 3) uint8 chunk; the
    prompt's text features compute once and broadcast over the batch.
    Returns (ids, outputs) without waiting, like ``_detect_dispatch``."""
    cfg = cfg or dino_lib.BASE
    if not prompt.endswith("."):
        prompt = prompt + "."
    text = _text_features(dino_params, prompt, vocab, cfg=cfg, bert_cfg=bert_cfg)
    h, w = frames_dev.shape[1:3]
    det_hw = det_hw or _detection_size(h, w)
    return text[0], _dino_forward(dino_params, frames_dev, text, det_hw, cfg, swin_cfg,
                                  bert_cfg)


def extract_masks_batch(dino_params, sam_params, frames: ImageLike, prompt: str, sam_cfg=None,
                        vocab=None, det_size: int = 800, det_max: int = 1333, seg_size: int = 0,
                        **cfg_kw) -> torch.Tensor:
    """Batched TextMaskExtractor: (B, H, W, 3) uint8 frames + ONE prompt ->
    (B, H, W) bool masks on the device.

    One DINO forward over the chunk and one SAM encoder call over it, the
    encoder queued before the host reads DINO's logits, then each frame's
    boxes decoded against its embedding. As in the JAX package each frame's
    box count is padded to a shared K (a power of two) with the padded boxes
    marked invalid; a frame with no detection gets an all-False mask."""
    sam_cfg = sam_cfg or sam_lib.BASE
    if seg_size:
        sam_params, sam_cfg = sam_lib.params_for_size(sam_params, sam_cfg, seg_size)
    vocab = vocab or _load_vocab()
    frames_dev = sam_lib._as_device_uint8(frames, _params_device(dino_params))
    b, h, w = frames_dev.shape[:3]
    cfg_kw.setdefault("det_hw", _detection_size(h, w, det_size, det_max))
    ids, pending = _detect_dispatch_batch(dino_params, frames_dev, prompt, vocab, **cfg_kw)
    embs, scale, nh, nw = sam_lib.encode_uint8_batch(sam_params, sam_cfg, frames_dev)
    logits = torch.sigmoid(pending["pred_logits"]).cpu().numpy()  # (B, Q, T)
    pboxes = pending["pred_boxes"].cpu().numpy()
    inv = _inv_vocab(vocab)
    per_frame = []
    for i in range(b):
        keep = logits[i].max(axis=1) > BOX_THRESHOLD
        keep2, _ = filter_phrases(logits[i][keep], ids, inv)
        per_frame.append(_boxes_to_xyxy(pboxes[i][keep][keep2], h, w))
    nmax = max(bx.shape[0] for bx in per_frame)
    if nmax == 0:
        return torch.zeros((b, h, w), dtype=torch.bool, device=frames_dev.device)
    k = 1 << (nmax - 1).bit_length()
    boxes = np.zeros((b, k, 4), np.float32)
    valid = np.zeros((b, k), bool)
    for i, bx in enumerate(per_frame):
        boxes[i, : bx.shape[0]] = bx
        valid[i, : bx.shape[0]] = True
    return sam_lib.masks_from_embedding_batch(sam_params, sam_cfg, embs, scale, nh, nw, h, w,
                                              boxes, valid)


def extract_mask(dino_params, sam_params, image: ImageLike, prompt: str, sam_cfg=None,
                 vocab=None, det_size: int = 800, det_max: int = 1333, seg_size: int = 0,
                 **cfg_kw) -> torch.Tensor:
    """The TextMaskExtractor chain on an (H, W, 3) uint8 image (host numpy
    or a tensor) -> (H, W) bool mask on the device.

    The frame is uploaded once and shared by both models, and SAM's image
    encoder (which needs no box) is queued before the host waits for DINO's
    logits, so that the card runs DINO and the encoder back to back while
    the host thresholds. When DINO detects nothing the encoder ran for
    naught (the serial reference skips it, TextMaskExtractor.py:52-53):
    the encoder cannot wait for the box count without losing the overlap."""
    sam_cfg = sam_cfg or sam_lib.BASE
    if seg_size:  # TextEffectConfig.segmentation_size (0/default = 1024)
        sam_params, sam_cfg = sam_lib.params_for_size(sam_params, sam_cfg, seg_size)
    h, w = image.shape[:2]
    vocab = vocab or _load_vocab()
    img_dev = sam_lib._as_device_uint8(image, _params_device(dino_params))
    # detection resolution knob (TextEffectConfig.detection_size): defaults
    # reproduce the reference RandomResize([800], max 1333)
    cfg_kw.setdefault("det_hw", _detection_size(h, w, det_size, det_max))
    ids, pending = _detect_dispatch(dino_params, img_dev, prompt, vocab, **cfg_kw)
    emb, scale, nh, nw = sam_lib.encode_uint8(sam_params, sam_cfg, img_dev)
    boxes, _ = _detect_collect(ids, pending, vocab)
    if boxes.shape[0] == 0:
        return torch.zeros((h, w), dtype=torch.bool, device=img_dev.device)
    return sam_lib.mask_union_from_embedding(sam_params, sam_cfg, emb, scale, nh, nw, h, w,
                                             _boxes_to_xyxy(boxes, h, w))


def _as_uint8_frame(image: ImageLike) -> ImageLike:
    """An extractor's input, (H, W, 3) or (1, H, W, 3), uint8 or float in
    [0, 1], host or device -> (H, W, 3) uint8 where it lies. Floats map as
    the JAX package maps them, ``(clip(x, 0, 1) * 255).astype(uint8)``."""
    if image.ndim == 4:
        image = image[0]
    if isinstance(image, torch.Tensor):
        if image.is_floating_point():
            image = (image.float().clamp(0, 1) * 255).to(torch.uint8)
        return image
    image = np.asarray(image)
    if image.dtype.kind == "f":
        image = (np.clip(image, 0, 1) * 255).astype(np.uint8)
    return image


def make_mask_extractor(dino_params, sam_params, vocab=None) -> Callable:
    """(image, prompt, det_size, det_max, seg_size) -> (H, W) bool mask on the
    params' device, through ``extract_mask``."""

    def extractor(image, prompt: str, det_size: int = 800, det_max: int = 1333,
                  seg_size: int = 0) -> torch.Tensor:
        return extract_mask(dino_params, sam_params, _as_uint8_frame(image), prompt,
                            vocab=vocab, det_size=det_size, det_max=det_max, seg_size=seg_size)

    return extractor


@functools.lru_cache(maxsize=1)
def get_loaded_params(device="cuda") -> Tuple:
    """(dino_params, sam_params) converted from the checkpoints on ``device``;
    raises if either checkpoint or the BERT vocab is missing."""
    device = resolve_device(device)
    dino_path = os.environ.get("TBIST_DINO_PTH",
                               os.path.join(_CACHE_DIR, "groundingdino_swint_ogc.pth"))
    if not os.path.exists(dino_path):
        raise FileNotFoundError(f"no GroundingDINO checkpoint at {dino_path}")
    _load_vocab()  # raise early if the vocab is missing
    from tbist_tpu_torch.weights import dino_convert

    ckpt = torch.load(dino_path, map_location="cpu", weights_only=False)
    dino_params = dino_convert.convert(ckpt.get("model", ckpt))
    logger.info("GroundingDINO: converted checkpoint from %s", dino_path)
    sam_params = sam_lib.get_loaded_params(device)  # raises if SAM's is missing
    return dino_convert.to_device(dino_params, device), sam_params


@functools.lru_cache(maxsize=1)
def get_mask_extractor(device="cuda") -> Callable:
    return make_mask_extractor(*get_loaded_params(device))


@functools.lru_cache(maxsize=1)
def get_batch_mask_extractor(device="cuda") -> Callable:
    """Batch variant of ``get_mask_extractor``: (frames (B, H, W, 3) uint8,
    prompt, ...) -> (B, H, W) bool masks through ``extract_masks_batch``.
    Raises like it when a checkpoint is missing (``effects.masking`` falls
    back)."""
    dino_params, sam_params = get_loaded_params(device)

    def extractor(frames, prompt: str, det_size: int = 800, det_max: int = 1333,
                  seg_size: int = 0) -> torch.Tensor:
        return extract_masks_batch(dino_params, sam_params, frames, prompt, det_size=det_size,
                                   det_max=det_max, seg_size=seg_size)

    return extractor
