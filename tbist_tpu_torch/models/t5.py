"""T5 encoder-decoder for the emoji texture path, ported from
``tbist_tpu.models.t5``.

The reference (text/EmojiMaskExtractor.py) calls HF
``KomeijiForce/t5-base-emojilm``'s ``generate``. T5 v1.0: RMSNorm (eps
1e-6, no mean), relative-position-bias attention with no 1/√d scale, ReLU
MLPs, tied embeddings with the d^-0.5 logit scale. ``generate`` decodes
with a key/value cache preallocated at ``max_len``.

Parameters keep the JAX tree: linears are (in, out), so a layer is
``x @ W``.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from tbist_tpu_torch.utils.imageio import tree_from_numpy
from tbist_tpu_torch.utils.precision import full_f32


class T5Config(NamedTuple):
    vocab: int = 32128
    d_model: int = 768
    d_ff: int = 3072
    heads: int = 12
    d_kv: int = 64
    layers: int = 12
    rel_buckets: int = 32
    rel_distance: int = 128
    pad_id: int = 0
    eos_id: int = 1
    decoder_start_id: int = 0


BASE = T5Config()
# the JAX package's test config (tests/test_t5.py)
TINY = T5Config(vocab=64, d_model=16, d_ff=32, heads=2, d_kv=8, layers=2, rel_buckets=8,
                rel_distance=16)


def _rms_norm(x, scale, eps=1e-6):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)) * scale


def _rel_bucket(rel_pos: torch.Tensor, bidirectional: bool, num_buckets: int,
                max_dist: int) -> torch.Tensor:
    """T5 relative-position buckets, as the JAX package computes them (its
    log has a +1e-9 that HF's has not)."""
    ret = torch.zeros_like(rel_pos)
    n = -rel_pos
    if bidirectional:
        num_buckets //= 2
        ret = ret + (n < 0).to(rel_pos.dtype) * num_buckets
        n = n.abs()
    else:
        n = n.clamp(min=0)
    max_exact = num_buckets // 2
    val_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9) / math.log(max_dist / max_exact)
        * (num_buckets - max_exact)
    ).to(rel_pos.dtype)
    val_large = val_large.clamp(max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n, val_large)


def _rel_bias(emb, q_len, k_len, bidirectional, cfg: T5Config, q_offset=0):
    """(heads, q_len, k_len) bias from the (buckets, heads) embedding."""
    ctx = torch.arange(q_len, device=emb.device)[:, None] + q_offset
    mem = torch.arange(k_len, device=emb.device)[None, :]
    buckets = _rel_bucket(mem - ctx, bidirectional, cfg.rel_buckets, cfg.rel_distance)
    return emb[buckets].permute(2, 0, 1)


def _attn(q, k, v, bias):
    """q: (B, H, Tq, D); k, v: (B, H, Tk, D); no 1/√d scale (T5)."""
    probs = torch.softmax((q @ k.transpose(-1, -2) + bias).float(), dim=-1).to(q.dtype)
    return probs @ v


def _heads(x, cfg: T5Config):
    b, t, _ = x.shape
    return x.reshape(b, t, cfg.heads, cfg.d_kv).transpose(1, 2)


def _merge(x):
    b, h, t, d = x.shape
    return x.transpose(1, 2).reshape(b, t, h * d)


def _self_attention(x, p, bias, cfg):
    h = _rms_norm(x, p["ln"])
    q, k, v = (_heads(h @ p[w], cfg) for w in ("q", "k", "v"))
    return x + _merge(_attn(q, k, v, bias)) @ p["o"]


def _mlp(x, p):
    h = _rms_norm(x, p["ln"])
    return x + torch.relu(h @ p["wi"]) @ p["wo"]


def _mask_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) 1/0 mask -> (B, 1, 1, T) additive bias."""
    return (1.0 - mask.float()[:, None, None, :]) * -1e9


def encode(params, cfg: T5Config, input_ids: torch.Tensor, attn_mask: torch.Tensor):
    """input_ids/attn_mask: (B, T) on the params' device -> (B, T, D)."""
    x = params["shared"][input_ids.long()]
    t = input_ids.shape[1]
    bias = _rel_bias(params["enc_rel"], t, t, True, cfg)[None] + _mask_bias(attn_mask)
    for layer in params["encoder"]:
        x = _mlp(_self_attention(x, layer["self"], bias, cfg), layer["mlp"])
    return _rms_norm(x, params["enc_ln"])


def sample_filter(logits: torch.Tensor, top_k: int, top_p: float) -> torch.Tensor:
    """Top-k then top-p filtering (HF's TopK then TopP warpers): keep the k
    largest logits, then the shortest descending prefix of the survivors
    whose cumulative probability reaches ``top_p``. Dropped entries become
    -inf. (B, V) -> (B, V)."""
    kth = torch.sort(logits, dim=-1).values[:, -top_k][:, None]
    filt = torch.where(logits < kth, float("-inf"), logits)
    sorted_logits = torch.sort(filt, dim=-1, descending=True).values
    cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
    cutoff_logit = torch.gather(sorted_logits, -1, cutoff_idx)
    return torch.where(filt < cutoff_logit, float("-inf"), filt)


def generate(params, cfg: T5Config, input_ids: torch.Tensor, attn_mask: torch.Tensor,
             max_len: int = 16, do_sample: bool = False, top_k: int = 10, top_p: float = 0.95,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Greedy (default) or top-k/top-p sampled decode -> (B, max_len) ids,
    pads after EOS; EOS is forbidden at the first position (min_length 1).

    The JAX package's ``while_loop`` stops once every row has emitted EOS.
    This loop always runs ``max_len`` steps, with no read-back inside it: a
    finished row only appends ``pad_id``, so the tokens are the same.
    Each decoder layer's cross-attention keys and values are computed once
    per call rather than once per step (the same products). Sampling draws
    from ``generator`` (JAX's distribution, not its numbers)."""
    with full_f32():
        return _generate(params, cfg, input_ids, attn_mask, max_len, do_sample, top_k, top_p,
                         generator)


def _generate(params, cfg, input_ids, attn_mask, max_len, do_sample, top_k, top_p, generator):
    b = input_ids.shape[0]
    dev = params["shared"].device
    enc_out = encode(params, cfg, input_ids, attn_mask)
    cross_bias = _mask_bias(attn_mask)
    cross_kv = [(_heads(enc_out @ layer["cross"]["k"], cfg), _heads(enc_out @ layer["cross"]["v"], cfg))
                for layer in params["decoder"]]
    cache_k = torch.zeros((cfg.layers, b, cfg.heads, max_len, cfg.d_kv), device=dev)
    cache_v = torch.zeros_like(cache_k)
    # per position: the relative bias over the whole cache, and -1e9 past it
    later = torch.arange(max_len, device=dev)[None, :] > torch.arange(max_len, device=dev)[:, None]
    self_bias = torch.stack([
        _rel_bias(params["dec_rel"], 1, max_len, False, cfg, q_offset=pos)[:, 0]
        for pos in range(max_len)
    ]) + later[:, None, :] * -1e9  # (max_len, H, max_len)
    eos_only = torch.arange(cfg.vocab, device=dev) == cfg.eos_id

    tokens = torch.full((b, max_len), cfg.pad_id, dtype=torch.long, device=dev)
    tok = torch.full((b,), cfg.decoder_start_id, dtype=torch.long, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    for pos in range(max_len):
        x = params["shared"][tok][:, None, :]
        bias = self_bias[pos][None, :, None, :]
        for li, layer in enumerate(params["decoder"]):
            h = _rms_norm(x, layer["self"]["ln"])
            q = _heads(h @ layer["self"]["q"], cfg)
            cache_k[li, :, :, pos] = _heads(h @ layer["self"]["k"], cfg)[:, :, 0]
            cache_v[li, :, :, pos] = _heads(h @ layer["self"]["v"], cfg)[:, :, 0]
            x = x + _merge(_attn(q, cache_k[li], cache_v[li], bias)) @ layer["self"]["o"]
            h = _rms_norm(x, layer["cross"]["ln"])
            q = _heads(h @ layer["cross"]["q"], cfg)
            x = x + _merge(_attn(q, *cross_kv[li], cross_bias)) @ layer["cross"]["o"]
            x = _mlp(x, layer["mlp"])
        x = _rms_norm(x, params["dec_ln"])
        logits = ((x * cfg.d_model**-0.5) @ params["shared"].T)[:, 0]
        if pos == 0:
            logits = logits.masked_fill(eos_only, float("-inf"))
        if do_sample:
            probs = torch.softmax(sample_filter(logits, top_k, top_p), dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = logits.argmax(dim=-1)
        nxt = torch.where(done, cfg.pad_id, nxt)
        tokens[:, pos] = nxt
        done = done | (nxt == cfg.eos_id)
        tok = nxt
    return tokens


def from_jax_params(tree):
    """The JAX package's numpy tree (same names, same layout) -> f32 CPU
    tensors."""
    return tree_from_numpy(tree)


def convert_hf_state_dict(sd, cfg: T5Config = BASE) -> Dict:
    """HF T5 state dict ((out, in) linears) -> the port's parameters."""

    def arr(k):
        return np.asarray(sd[k], dtype=np.float32)

    def lin(k):
        return arr(k).T

    def attn(pre, name):
        return {"ln": arr(f"{pre}.layer_norm.weight"),
                **{w: lin(f"{pre}.{name}.{w}.weight") for w in ("q", "k", "v", "o")}}

    def block(side, i, is_dec):
        pre = f"{side}.block.{i}.layer"
        out = {"self": attn(f"{pre}.0", "SelfAttention")}
        if is_dec:
            out["cross"] = attn(f"{pre}.1", "EncDecAttention")
        m = 2 if is_dec else 1
        out["mlp"] = {"ln": arr(f"{pre}.{m}.layer_norm.weight"),
                      "wi": lin(f"{pre}.{m}.DenseReluDense.wi.weight"),
                      "wo": lin(f"{pre}.{m}.DenseReluDense.wo.weight")}
        return out

    return from_jax_params({
        "shared": arr("shared.weight"),
        "enc_rel": arr("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "dec_rel": arr("decoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight"),
        "encoder": [block("encoder", i, False) for i in range(cfg.layers)],
        "decoder": [block("decoder", i, True) for i in range(cfg.layers)],
        "enc_ln": arr("encoder.final_layer_norm.weight"),
        "dec_ln": arr("decoder.final_layer_norm.weight"),
    })


def init_params(gen: torch.Generator, cfg: T5Config = BASE, device="cpu") -> Dict:
    """Seeded random parameters with the JAX package's scales (torch's
    draws): a full-width stand-in when no checkpoint exists."""

    def normal(shape, scale):
        return (torch.randn(shape, generator=gen) * scale).to(device)

    def lin(cin, cout, scale=None):
        return normal((cin, cout), scale if scale is not None else cin**-0.5)

    def ones():
        return torch.ones(cfg.d_model, device=device)

    inner = cfg.heads * cfg.d_kv

    def attn():
        return {"ln": ones(), "q": lin(cfg.d_model, inner, (cfg.d_model * cfg.d_kv) ** -0.5),
                "k": lin(cfg.d_model, inner), "v": lin(cfg.d_model, inner),
                "o": lin(inner, cfg.d_model)}

    def block(is_dec):
        d = {"self": attn(),
             "mlp": {"ln": ones(), "wi": lin(cfg.d_model, cfg.d_ff), "wo": lin(cfg.d_ff, cfg.d_model)}}
        if is_dec:
            d["cross"] = attn()
        return d

    return {
        "shared": normal((cfg.vocab, cfg.d_model), 1.0),
        "enc_rel": normal((cfg.rel_buckets, cfg.heads), 0.1),
        "dec_rel": normal((cfg.rel_buckets, cfg.heads), 0.1),
        "encoder": [block(False) for _ in range(cfg.layers)],
        "decoder": [block(True) for _ in range(cfg.layers)],
        "enc_ln": ones(),
        "dec_ln": ones(),
    }
