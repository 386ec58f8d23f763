"""SE-style channel attention, ported from
``tbist_tpu.models.channel_attention``.

The reference ``ChannelAttention`` can never run (``super()._init_()`` is a
typo that crashes on instantiation, multi_style_transfer/
ChannelAttention.py:11, and its weights were random per call anyway,
run_style_transfer.py:18). Like the JAX package, this implements the
intended behavior: squeeze-excite with reduction 2, ReLU after both linear
layers, then a sigmoid scale (ChannelAttention.py:23-40).
"""

from __future__ import annotations

import zlib
from typing import Dict

import torch

from tbist_tpu_torch.utils.precision import full_f32


def layer_seed(seed: int, layer: str) -> int:
    """The generator seed of ``layer``'s weights: the crc32 of the layer's
    name started from ``seed``, so both count, as the JAX package folds both
    into its key. It fits the 32 bits a CPU ``torch.Generator`` keeps."""
    return zlib.crc32(layer.encode(), seed & 0xFFFFFFFF)


def init_params(generator: torch.Generator, channels: int, reduction: int = 2) -> Dict:
    """torch nn.Linear's default init, U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    drawn from ``generator`` as float32 on the CPU: the distribution of the
    JAX package's draw, not its numbers."""
    hidden = channels // reduction
    params = {}
    for name, (fan_in, fan_out) in (("fc1", (channels, hidden)), ("fc2", (hidden, channels))):
        bound = 1.0 / fan_in ** 0.5
        params[name] = (torch.rand((fan_in, fan_out), generator=generator) * 2.0 - 1.0) * bound
    return params


def apply(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> channel-reweighted (B, H, W, C), in float32 (a
    bfloat16 ``x`` is promoted, as in the JAX package)."""
    with full_f32():
        pooled = torch.mean(x.float(), dim=(1, 2))  # (B, C)
        h = torch.relu(pooled @ params["fc1"].to(pooled.device, torch.float32))
        h = torch.relu(h @ params["fc2"].to(pooled.device, torch.float32))
    scale = torch.sigmoid(h)  # (B, C)
    return x * scale[:, None, None, :]
