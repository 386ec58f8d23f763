"""BERT-base text encoder, ported from the JAX package's
``models/bert.py`` (GroundingDINO's language tower, ``bert-base-uncased``).

Word, position and type embeddings with a LayerNorm, then 12 post-LN
transformer layers (exact GELU, 3072 FFN), hidden 768. LayerNorm eps is
1e-12 throughout. GroundingDINO reads the sequence output; the pooler is
unused. Linear weights are (in, out), used as ``x @ w + b``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F


class BertConfig(NamedTuple):
    vocab: int = 30522
    hidden: int = 768
    layers: int = 12
    heads: int = 12
    ffn: int = 3072
    max_pos: int = 512
    type_vocab: int = 2


BASE = BertConfig()


def _layer_norm(x: torch.Tensor, p) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), p["scale"], p["bias"], eps=1e-12)


def forward(
    params,
    cfg: BertConfig,
    input_ids: torch.Tensor,
    attention_mask: torch.Tensor,
    position_ids: Optional[torch.Tensor] = None,
    token_type_ids: Optional[torch.Tensor] = None,
    attention_bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(B, T) ids -> (B, T, hidden) sequence output.

    ``attention_bias``, when given, replaces the padding mask with a full
    (B, 1, T, T) additive bias (GroundingDINO's sub-sentence blocks)."""
    b, t = input_ids.shape
    if position_ids is None:
        position_ids = torch.arange(t, device=input_ids.device).expand(b, t)
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(input_ids)

    x = (params["word_emb"][input_ids] + params["pos_emb"][position_ids]
         + params["type_emb"][token_type_ids])
    x = _layer_norm(x, params["emb_ln"])

    if attention_bias is None:
        attention_bias = (1.0 - attention_mask[:, None, None, :].float()) * -1e9

    h = cfg.heads
    d = cfg.hidden // h
    for blk in params["blocks"]:
        q, k, v = ((x @ blk[f"{n}_w"] + blk[f"{n}_b"]).reshape(b, t, h, d).transpose(1, 2)
                   for n in ("q", "k", "v"))
        logits = (q @ k.transpose(-1, -2)) / math.sqrt(d) + attention_bias
        ctx = (torch.softmax(logits, -1) @ v).transpose(1, 2).reshape(b, t, cfg.hidden)
        x = _layer_norm(x + (ctx @ blk["o_w"] + blk["o_b"]), blk["attn_ln"])
        ffn = F.gelu(x @ blk["fc1_w"] + blk["fc1_b"])  # exact (erf) GELU
        x = _layer_norm(x + (ffn @ blk["fc2_w"] + blk["fc2_b"]), blk["ffn_ln"])
    return x


def convert_hf_state_dict(sd, prefix: str = "bert.", cfg: BertConfig = BASE) -> Dict:
    """HF ``BertModel`` naming -> the JAX package's tree as numpy arrays."""

    def arr(k):
        v = sd[prefix + k]
        return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float32)

    def ln(k):
        return {"scale": arr(f"{k}.weight"), "bias": arr(f"{k}.bias")}

    blocks = []
    for i in range(cfg.layers):
        p = f"encoder.layer.{i}"
        a = f"{p}.attention"
        blocks.append({
            "q_w": arr(f"{a}.self.query.weight").T, "q_b": arr(f"{a}.self.query.bias"),
            "k_w": arr(f"{a}.self.key.weight").T, "k_b": arr(f"{a}.self.key.bias"),
            "v_w": arr(f"{a}.self.value.weight").T, "v_b": arr(f"{a}.self.value.bias"),
            "o_w": arr(f"{a}.output.dense.weight").T, "o_b": arr(f"{a}.output.dense.bias"),
            "attn_ln": ln(f"{a}.output.LayerNorm"),
            "fc1_w": arr(f"{p}.intermediate.dense.weight").T,
            "fc1_b": arr(f"{p}.intermediate.dense.bias"),
            "fc2_w": arr(f"{p}.output.dense.weight").T, "fc2_b": arr(f"{p}.output.dense.bias"),
            "ffn_ln": ln(f"{p}.output.LayerNorm"),
        })
    return {
        "word_emb": arr("embeddings.word_embeddings.weight"),
        "pos_emb": arr("embeddings.position_embeddings.weight"),
        "type_emb": arr("embeddings.token_type_embeddings.weight"),
        "emb_ln": ln("embeddings.LayerNorm"),
        "blocks": blocks,
    }


def init_params(generator: torch.Generator, cfg: BertConfig = BASE) -> Dict:
    """Seeded random parameters with the JAX init's tree and distributions."""

    def nrm(*shape):
        return torch.randn(shape, generator=generator) * 0.02

    def ln(dim):
        return {"scale": torch.ones(dim), "bias": torch.zeros(dim)}

    h = cfg.hidden
    blocks = [{
        "q_w": nrm(h, h), "q_b": torch.zeros(h), "k_w": nrm(h, h), "k_b": torch.zeros(h),
        "v_w": nrm(h, h), "v_b": torch.zeros(h), "o_w": nrm(h, h), "o_b": torch.zeros(h),
        "attn_ln": ln(h),
        "fc1_w": nrm(h, cfg.ffn), "fc1_b": torch.zeros(cfg.ffn),
        "fc2_w": nrm(cfg.ffn, h), "fc2_b": torch.zeros(h),
        "ffn_ln": ln(h),
    } for _ in range(cfg.layers)]
    return {
        "word_emb": nrm(cfg.vocab, h),
        "pos_emb": nrm(cfg.max_pos, h),
        "type_emb": nrm(cfg.type_vocab, h),
        "emb_ln": ln(h),
        "blocks": blocks,
    }
