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

On two or more cards, as in the JAX package: one image at least
``sp_min_width()`` wide has its width sharded over every card (sp,
``ghiasi.apply_sharded``), and ``perform_transfer_batch`` splits its batch
over every card (dp), each card running its rows with its own replica of
the weights, the results gathered on the caller's card.
"""

from __future__ import annotations

import os
import zlib
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tbist_tpu_torch.models import clip_mlp, ghiasi
from tbist_tpu_torch.parallel import mesh as mesh_lib
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


def sp_min_width() -> int:
    """Width from which one image shards its width over the sp mesh
    (``TBIST_SP_MIN_WIDTH``, default 1024, as in the JAX package): below it
    a feed-forward Ghiasi pass is too short for the halo copies to pay."""
    return int(os.environ.get("TBIST_SP_MIN_WIDTH", "1024"))


def _transfer_sp(g_params, m_params, image: torch.Tensor, emb: torch.Tensor,
                 sharding: mesh_lib.WidthSharding) -> torch.Tensor:
    """``_transfer`` with the image's width cut over ``sharding``'s cards."""
    with full_f32():
        style = clip_mlp.apply(m_params, emb)
        out = ghiasi.apply_sharded(
            [mesh_lib.replicas_of(g_params).on(d) for d in sharding.devices],
            sharding.scatter(image, 2), [style.to(d) for d in sharding.devices],
            compute_dtype=compute_dtype())
    return mesh_lib.gather_width(out, image.device, 2)


def perform_transfer(image: torch.Tensor, text: str, g_params=None, m_params=None,
                     text_encoder: Optional[Callable] = None,
                     use_mesh: bool = True) -> torch.Tensor:
    """Apply the text style to an NHWC [0, 1] image on its device. Returns
    the same shape, f32.

    With two or more cards, ``use_mesh`` and a width of at least
    ``sp_min_width()`` that divides by sp, the width is sharded over the sp
    production mesh (``tbist_tpu/effects/text_transfer.py:205-220``)."""
    g_params, m_params, text_encoder = _resolve(image.device, g_params, m_params, text_encoder)
    emb = _pooled_embedding(text, text_encoder, image.device)
    if use_mesh and image.dim() == 4 and image.shape[2] >= sp_min_width():
        mesh = mesh_lib.production_mesh(image.device, sp_only=True)
        if mesh is not None and image.shape[2] % mesh.shape[mesh_lib.SP_AXIS] == 0:
            sharding = mesh_lib.width_sharding(image.shape[2], mesh.devices[0],
                                               mesh_lib.GHIASI_ALIGN, mesh_lib.GHIASI_MIN_WIDTH)
            if sharding is not None:
                return _transfer_sp(g_params, m_params, image, emb, sharding)
    return _transfer(g_params, m_params, image, emb)


def perform_transfer_batch(images: torch.Tensor, texts: Sequence[str], g_params=None,
                           m_params=None, text_encoder: Optional[Callable] = None) -> torch.Tensor:
    """Batched ``perform_transfer``: N same-shape images and N prompts in
    one batched call. Each distinct prompt is encoded once. The batch is
    padded to the next power of two by repeating the last row, as the JAX
    package pads it to bound its compiled programs, and the pad rows are
    sliced away.

    With two or more cards the padded batch is padded on to a multiple of
    dp and split over the dp production mesh, each card running its rows
    with its own replica of the weights (made once, ``mesh.replicas_of``),
    as at ``tbist_tpu/effects/text_transfer.py:139-157``; the results are
    gathered on the images' card in order."""
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
    mesh = mesh_lib.production_mesh(device, dp_only=True)
    if mesh is not None:
        dp = mesh.shape[mesh_lib.DP_AXIS]
        padded = -(-padded // dp) * dp
    # n <= padded, so the next multiple of padded is padded itself
    images, _ = mesh_lib.pad_to_multiple(images, padded)
    emb, _ = mesh_lib.pad_to_multiple(emb, padded)
    if mesh is None:
        return _transfer(g_params, m_params, images, emb)[:n]
    cards = [row[0] for row in mesh.devices]
    rows = padded // len(cards)
    g_reps, m_reps = mesh_lib.replicas_of(g_params), mesh_lib.replicas_of(m_params)
    outs = [_transfer(g_reps.on(d), m_reps.on(d),
                      images[i * rows:(i + 1) * rows].to(d, non_blocking=True),
                      emb[i * rows:(i + 1) * rows].to(d, non_blocking=True))
            for i, d in enumerate(cards)]
    return torch.cat([o.to(device, non_blocking=True) for o in outs])[:n]
