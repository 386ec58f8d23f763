"""CLIP ViT-B/32 text encoder, ported from ``tbist_tpu.models.clip_text``.

The reference encodes prompts with openai-clip's ``encode_text``
(text/FastTextTransfer.py:32,52-56). The tower: vocab 49408, context 77,
width 512, 12 layers, 8 heads, QuickGELU MLPs, causal attention, a final
LayerNorm (eps 1e-5), features taken at the EOT position
(``argmax(tokens)``) and projected by ``text_projection``. Attention is a
matmul and a softmax, as in the JAX package (no kernel of its own there).

Weights and vocab, in the JAX package's order:
* ``TBIST_CLIP_PTH`` or ``weights_cache/clip_vitb32.pth``: an openai CLIP
  state dict, converted on first use;
* ``TBIST_CLIP_BPE`` or ``weights_cache/bpe_simple_vocab_16e6.txt.gz``:
  the CLIP BPE merges file;
* otherwise the prompt-seeded fallback embedding
  (``effects.text_transfer.fallback_text_embedding``), flagged
  ``clip_text_fallback``.

Parameters keep the JAX tree's names and torch's (out, in) linear layout.
"""

from __future__ import annotations

import functools
import gzip
import html
import math
import os
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.imageio import resolve_device, tree_from_numpy, tree_to, upload
from tbist_tpu_torch.utils.logging import logger
from tbist_tpu_torch.utils.precision import full_f32

CONTEXT = 77
WIDTH = 512
LAYERS = 12
HEADS = 8
VOCAB = 49408

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights_cache",
)


# ---------------------------------------------------------------------------
# BPE tokenizer (needs the CLIP merges file)
# ---------------------------------------------------------------------------


def _bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PATTERN = (r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]"""
            r"""|[^\s\p{L}\p{N}]+""")
_ASCII_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+"


class ClipTokenizer:
    """CLIP's byte-level BPE. The exact pattern needs the ``regex`` module
    (unicode classes); without it, an ASCII approximation that suits
    English prompts."""

    def __init__(self, bpe_path: str):
        self.byte_encoder = _bytes_to_unicode()
        merges = gzip.open(bpe_path).read().decode("utf-8").split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        try:
            import regex

            self.pat = regex.compile(_PATTERN, regex.IGNORECASE)
        except ImportError:
            self.pat = re.compile(_ASCII_PATTERN, re.IGNORECASE)

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = html.unescape(html.unescape(text))
        text = re.sub(r"\s+", " ", text).strip().lower()
        ids: List[int] = []
        for token in self.pat.findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def tokenize(self, text: str) -> np.ndarray:
        sot, eot = self.encoder["<|startoftext|>"], self.encoder["<|endoftext|>"]
        ids = [sot] + self.encode(text)[: CONTEXT - 2] + [eot]
        out = np.zeros((1, CONTEXT), np.int32)
        out[0, : len(ids)] = ids
        return out


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------


def _layer_norm(x, p, eps=1e-5):
    return torch.nn.functional.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps)


def _attention(x, p, mask):
    b, t, d = x.shape
    qkv = x @ p["in_proj_w"].T + p["in_proj_b"]
    q, k, v = (z.reshape(b, t, HEADS, d // HEADS).transpose(1, 2) for z in qkv.chunk(3, dim=-1))
    logits = (q @ k.transpose(-1, -2)) * (1.0 / math.sqrt(d / HEADS)) + mask
    out = torch.softmax(logits, dim=-1) @ v
    return out.transpose(1, 2).reshape(b, t, d) @ p["out_proj_w"].T + p["out_proj_b"]


def encode_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, 77) int on the params' device -> (B, 512) text
    embeddings (not normalized)."""
    x = params["token_embedding"][tokens.long()] + params["positional_embedding"]
    t = tokens.shape[1]
    mask = torch.full((t, t), float("-inf"), device=x.device).triu(1)
    for blk in params["blocks"]:
        x = x + _attention(_layer_norm(x, blk["ln_1"]), blk["attn"], mask)
        h = _layer_norm(x, blk["ln_2"])
        h = h @ blk["mlp"]["fc_w"].T + blk["mlp"]["fc_b"]
        h = h * torch.sigmoid(1.702 * h)  # QuickGELU
        x = x + (h @ blk["mlp"]["proj_w"].T + blk["mlp"]["proj_b"])
    x = _layer_norm(x, params["ln_final"])
    eot = tokens.argmax(dim=-1)
    feats = x[torch.arange(x.shape[0], device=x.device), eot]
    return feats @ params["text_projection"]


def from_jax_params(tree):
    """The JAX package's numpy tree (same names, same layout) -> f32 CPU
    tensors."""
    return tree_from_numpy(tree)


def convert_openai_state_dict(sd) -> Dict:
    """openai CLIP state dict -> the text tower's parameters."""

    def arr(k):
        return np.asarray(sd[k], dtype=np.float32)

    blocks = []
    for i in range(LAYERS):
        pre = f"transformer.resblocks.{i}"
        blocks.append({
            "ln_1": {"scale": arr(f"{pre}.ln_1.weight"), "bias": arr(f"{pre}.ln_1.bias")},
            "ln_2": {"scale": arr(f"{pre}.ln_2.weight"), "bias": arr(f"{pre}.ln_2.bias")},
            "attn": {
                "in_proj_w": arr(f"{pre}.attn.in_proj_weight"),
                "in_proj_b": arr(f"{pre}.attn.in_proj_bias"),
                "out_proj_w": arr(f"{pre}.attn.out_proj.weight"),
                "out_proj_b": arr(f"{pre}.attn.out_proj.bias"),
            },
            "mlp": {
                "fc_w": arr(f"{pre}.mlp.c_fc.weight"), "fc_b": arr(f"{pre}.mlp.c_fc.bias"),
                "proj_w": arr(f"{pre}.mlp.c_proj.weight"),
                "proj_b": arr(f"{pre}.mlp.c_proj.bias"),
            },
        })
    return from_jax_params({
        "token_embedding": arr("token_embedding.weight"),
        "positional_embedding": arr("positional_embedding"),
        "blocks": blocks,
        "ln_final": {"scale": arr("ln_final.weight"), "bias": arr("ln_final.bias")},
        "text_projection": arr("text_projection"),
    })


def init_params(gen: torch.Generator, device="cpu") -> Dict:
    """Seeded random tower with the JAX package's scales (a full-width
    stand-in when no checkpoint exists; the draws are torch's)."""

    def norm(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def ln():
        return {"scale": torch.ones(WIDTH, device=device), "bias": torch.zeros(WIDTH, device=device)}

    z = functools.partial(torch.zeros, device=device)
    blocks = [{
        "ln_1": ln(), "ln_2": ln(),
        "attn": {"in_proj_w": norm((3 * WIDTH, WIDTH), WIDTH**-0.5), "in_proj_b": z(3 * WIDTH),
                 "out_proj_w": norm((WIDTH, WIDTH), WIDTH**-0.5), "out_proj_b": z(WIDTH)},
        "mlp": {"fc_w": norm((4 * WIDTH, WIDTH), WIDTH**-0.5), "fc_b": z(4 * WIDTH),
                "proj_w": norm((WIDTH, 4 * WIDTH), (4 * WIDTH) ** -0.5), "proj_b": z(WIDTH)},
    } for _ in range(LAYERS)]
    return {
        "token_embedding": norm((VOCAB, WIDTH), 0.02),
        "positional_embedding": norm((CONTEXT, WIDTH), 0.01),
        "blocks": blocks,
        "ln_final": ln(),
        "text_projection": norm((WIDTH, WIDTH), WIDTH**-0.5),
    }


def make_encoder(params, tokenizer: ClipTokenizer, device):
    """prompt -> (1, 512) embedding on ``device``, f32 with TF32 off."""

    def encoder(text: str) -> torch.Tensor:
        with full_f32():
            return encode_tokens(params, upload(tokenizer.tokenize(text), device))

    return encoder


def _find(paths: List[str]) -> Optional[str]:
    for p in paths:
        if p and os.path.exists(p):
            return p
    return None


@functools.lru_cache(maxsize=None)
def get_default_encoder(device="cuda"):
    """Resolve a prompt -> embedding callable on ``device``: the converted
    CLIP tower when its checkpoint and vocab exist, else the fallback."""
    device = resolve_device(device)
    pth = _find([os.environ.get("TBIST_CLIP_PTH", ""), os.path.join(_CACHE_DIR, "clip_vitb32.pth")])
    bpe = _find([os.environ.get("TBIST_CLIP_BPE", ""),
                 os.path.join(_CACHE_DIR, "bpe_simple_vocab_16e6.txt.gz")])
    if pth and bpe:
        sd = torch.load(pth, map_location="cpu", weights_only=False)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
        params = convert_openai_state_dict(
            {k: v.float().numpy() for k, v in sd.items() if isinstance(v, torch.Tensor)})
        params = tree_to(params, device)
        logger.info("CLIP text encoder: loaded converted ViT-B/32 weights")
        return make_encoder(params, ClipTokenizer(bpe), device)

    degraded.mark("text_transfer", "clip_text_fallback")
    logger.warning("CLIP text encoder: no checkpoint/vocab found — using deterministic "
                   "prompt-seeded fallback embeddings (set TBIST_CLIP_PTH / TBIST_CLIP_BPE)")
    from tbist_tpu_torch.effects.text_transfer import fallback_text_embedding

    return fallback_text_embedding
