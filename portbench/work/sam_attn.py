"""Operations of K4 (``tbist_tpu_torch/kernels/sam_attn.py``,
``csrc/sam_attn.cu``), SAM's global attention with the decomposed
relative-position bias, in one location request, counted from the
configuration's published widths.

Each of SAM's global layers attends once over the whole encoder grid:
T = (img_size / patch)^2 tokens, N = heads at one image, head width d =
width / heads. The two products, Q K^T and P V, take 2 T^2 d operations
each a head, so 4 N T^2 d a layer; the bias adds and the softmax are left
out. K4 computes each product in 3xTF32 (three TF32 MMAs, each operand
split into a big and a small part), so its bound is three times the
operations at the card's TF32 peak.
"""

from __future__ import annotations

from typing import Dict

TF32_PARTS = 3  # MMAs a product in 3xTF32


def k4_flops(sam: Dict) -> float:
    """Operations K4 does in one encoder call at the configuration's
    ``sam`` widths, before the 3xTF32 factor."""
    t = (sam["img_size"] // sam["patch"]) ** 2
    d = sam["width"] // sam["heads"]
    return len(sam["global_layers"]) * 4.0 * sam["heads"] * t * t * d


def k4_bound_s(sam: Dict, peaks: Dict[str, float]) -> float:
    """The least time of one request's K4 work: its 3xTF32 MMAs at the
    card's TF32 peak."""
    return TF32_PARTS * k4_flops(sam) / peaks["tf32"]
