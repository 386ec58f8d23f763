"""Feed-forward text-based stylization, ported from
``tbist_tpu.effects.text_transfer`` (reference text/FastTextTransfer.py:
36-66): prompt → CLIP ViT-B/32 text embedding (mean over the batch, f32,
L2-normalized) → the 5-layer MLP → a 100-d style embedding → the Ghiasi
transformer → a sigmoid image.

The text encoder is pluggable (``models.clip_text.get_default_encoder``).
With no CLIP checkpoint and vocab it resolves to
``fallback_text_embedding``, which draws the JAX package's prompt-seeded
Gaussian with JAX's own PRNG reimplemented in numpy (``utils/threefry.py``),
so a prompt gives the same embedding, and the same image, in both packages.

The JAX package shards a wide image over an ``sp`` mesh and a batch over a
``dp`` mesh; one GPU has no counterpart of either, so the port keeps no
mesh code: a batch is one batched call on one device.
"""

from __future__ import annotations

import os
import zlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tbist_tpu_torch.models import clip_mlp, ghiasi
from tbist_tpu_torch.utils import threefry
from tbist_tpu_torch.utils.imageio import upload
from tbist_tpu_torch.utils.precision import full_f32


def default_params(device="cuda"):
    """(ghiasi, clip_mlp) parameters on ``device`` (``weights/ghiasi_convert``)."""
    from tbist_tpu_torch.weights import ghiasi_convert

    return ghiasi_convert.get_params(device)


def fallback_text_embedding(text: str) -> torch.Tensor:
    """Deterministic (1, 512) unit embedding of a prompt when no CLIP
    weights exist: ``jax.random.normal(jax.random.key(crc32(prompt)),
    (1, 512))`` normalized, as the JAX package draws it (a CPU tensor)."""
    vec = threefry.normal(threefry.key(zlib.crc32(text.encode("utf-8"))), (1, 512))
    return torch.from_numpy(vec / np.linalg.norm(vec, axis=-1, keepdims=True))


def compute_dtype() -> torch.dtype:
    """Activation dtype of the Ghiasi path, read at call time: bfloat16 by
    default, float32 when ``TBIST_GHIASI_BF16=0``. Instance-norm statistics
    stay f32 and the sigmoid returns f32 either way."""
    return torch.float32 if os.environ.get("TBIST_GHIASI_BF16", "1") == "0" else torch.bfloat16


def _pooled_embedding(text: str, text_encoder: Callable, device) -> torch.Tensor:
    """Prompt -> (1, 512) f32 L2-normalized embedding on ``device``
    (FastTextTransfer.py:52-56: mean over the batch, f32, L2)."""
    emb = upload(text_encoder(text), device).float().mean(dim=0, keepdim=True)
    return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def _transfer(g_params, m_params, images: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    with full_f32():
        style = clip_mlp.apply(m_params, emb)
        return ghiasi.apply(g_params, images, style, compute_dtype=compute_dtype())


def _resolve(device, g_params, m_params, text_encoder):
    if g_params is None or m_params is None:
        g_params, m_params = default_params(device)
    if text_encoder is None:
        from tbist_tpu_torch.models import clip_text

        text_encoder = clip_text.get_default_encoder(device)
    return g_params, m_params, text_encoder


def perform_transfer(image: torch.Tensor, text: str, g_params=None, m_params=None,
                     text_encoder: Optional[Callable] = None) -> torch.Tensor:
    """Apply the text style to an NHWC [0, 1] image on its device. Returns
    the same shape, f32."""
    g_params, m_params, text_encoder = _resolve(image.device, g_params, m_params, text_encoder)
    emb = _pooled_embedding(text, text_encoder, image.device)
    return _transfer(g_params, m_params, image, emb)


def perform_transfer_batch(images: torch.Tensor, texts: Sequence[str], g_params=None,
                           m_params=None, text_encoder: Optional[Callable] = None) -> torch.Tensor:
    """Batched ``perform_transfer``: N same-shape images and N prompts in
    one batched call. Each distinct prompt is encoded once. The batch is
    padded to the next power of two by repeating the last row, as the JAX
    package pads it to bound its compiled programs, and the pad rows are
    sliced away."""
    if images.dim() != 4 or images.shape[0] != len(texts):
        raise ValueError(f"images must be (N, H, W, 3) with N == len(texts); got "
                         f"{tuple(images.shape)} vs {len(texts)} prompts")
    device = images.device
    g_params, m_params, text_encoder = _resolve(device, g_params, m_params, text_encoder)
    unique = {}
    for t in texts:
        if t not in unique:
            unique[t] = _pooled_embedding(t, text_encoder, device)
    emb = torch.cat([unique[t] for t in texts], dim=0)
    n = images.shape[0]
    padded = max(1, 1 << (n - 1).bit_length())
    if padded != n:
        images = torch.cat([images, images[-1:].expand(padded - n, *images.shape[1:])])
        emb = torch.cat([emb, emb[-1:].expand(padded - n, -1)])
    return _transfer(g_params, m_params, images, emb)[:n]
