"""CLIP-text-embedding → Ghiasi-style-embedding MLP, ported from
``tbist_tpu.models.clip_mlp``.

Reference ClipTextEmbeddingTransformer
(text/subnetworks/clip_text_embedding_transformer.py:15-26):
512→256→256→150→150→100 with LeakyReLU(0.2) four times and a final tanh.
Parameters are a list of ``{"weight": (in, out), "bias": (out,)}``, the
JAX layout, so a layer is ``x @ weight + bias``.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

SIZES = (512, 256, 256, 150, 150, 100)

Params = List[Dict[str, torch.Tensor]]


def apply(params: Params, x: torch.Tensor) -> torch.Tensor:
    """(B, 512) CLIP text embedding -> (B, 100) style embedding in (-1, 1)."""
    for i, p in enumerate(params):
        x = x @ p["weight"] + p["bias"]
        x = F.leaky_relu(x, 0.2) if i < len(params) - 1 else torch.tanh(x)
    return x
