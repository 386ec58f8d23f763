"""Ghiasi arbitrary-style image transformer, ported from
``tbist_tpu.models.ghiasi``.

Architecture of the reference (text/subnetworks/ghiasi_img_transformer.py,
after Ghiasi et al. 2017), in ``LAYERS`` order:

* encoder: reflect pad, VALID conv, instance norm, ReLU; 3→32 k9, 32→64
  k3 s2, 64→128 k3 s2, with no style conditioning;
* 5 residual blocks of 128 channels, each two convs with instance norm and
  FiLM γ/β from Linear(100, C);
* decoder: nearest 2× upsample, conv, instance norm, FiLM, ReLU for
  128→64 and 64→32; then 32→3 k9 with no upsample and no activation;
* a sigmoid, in f32.

Images are NHWC at the interface, as in the JAX package. Each conv runs on
an NCHW view with channels-last strides and channels-last weights (see
``models/vgg19.py``). ``compute_dtype`` bfloat16 casts activations, weights
and bias to bf16 before each conv and adds the bias after it, as the JAX
package does; instance-norm statistics and the FiLM products stay f32.

Parameters: ``{layer: {"weight": (O, I, k, k), "bias", ...}}``; FiLM
linears ``{"weight": (100, C), "bias": (C,)}`` in the JAX (in, out) layout.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Dict]

# (kind, name, cin, cout, kernel, stride_or_upsample)
LAYERS: Tuple = (
    ("conv", "enc1", 3, 32, 9, 1),
    ("conv", "enc2", 32, 64, 3, 2),
    ("conv", "enc3", 64, 128, 3, 2),
    ("res", "res1", 128, 128, 3, 1),
    ("res", "res2", 128, 128, 3, 1),
    ("res", "res3", 128, 128, 3, 1),
    ("res", "res4", 128, 128, 3, 1),
    ("res", "res5", 128, 128, 3, 1),
    ("up", "dec1", 128, 64, 3, 2),
    ("up", "dec2", 64, 32, 3, 2),
    ("up", "dec3", 32, 3, 9, None),  # no upsample, no activation
)

STYLE_DIM = 100


def _conv(x: torch.Tensor, p, pad: int, stride: int, dtype: torch.dtype) -> torch.Tensor:
    """Reflect pad, VALID conv and bias, all in ``dtype``. x is NCHW."""
    if pad:
        x = F.pad(x, (pad, pad, pad, pad), mode="reflect")
    out = F.conv2d(x.to(dtype), p["weight"].to(dtype), stride=stride)
    return out + p["bias"].to(dtype)[None, :, None, None]


def _instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-(batch, channel) spatial normalization with no affine. The mean
    and biased variance are f32 whatever x's dtype; the result is x's."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3), keepdim=True)
    var = (xf - mean).square().mean(dim=(2, 3), keepdim=True)
    scale = torch.rsqrt(var + eps)
    return (x - mean.to(x.dtype)) * scale.to(x.dtype)


def _film(x: torch.Tensor, p_gamma, p_beta, style: torch.Tensor) -> torch.Tensor:
    # the (B, 100) @ (100, C) affine is tiny: f32, cast at use
    gamma = style @ p_gamma["weight"] + p_gamma["bias"]
    beta = style @ p_beta["weight"] + p_beta["bias"]
    return gamma[:, :, None, None].to(x.dtype) * x + beta[:, :, None, None].to(x.dtype)


def _upsample_nearest_2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


def _layer(kind: str, name: str, p, x: torch.Tensor, style: torch.Tensor, k: int, stride,
           dtype: torch.dtype) -> torch.Tensor:
    """One entry of ``LAYERS`` on an NCHW activation."""
    pad = k // 2
    if kind == "conv":
        return torch.relu(_instance_norm(_conv(x, p, pad, stride, dtype)))
    if kind == "res":
        y = _conv(x, p["conv1"], 1, 1, dtype)
        y = torch.relu(_film(_instance_norm(y), p["fc_gamma1"], p["fc_beta1"], style))
        y = _conv(y, p["conv2"], 1, 1, dtype)
        return x + _film(_instance_norm(y), p["fc_gamma2"], p["fc_beta2"], style)
    h = x if stride is None else _upsample_nearest_2x(x)
    h = _film(_instance_norm(_conv(h, p, pad, 1, dtype)), p["fc_gamma"], p["fc_beta"], style)
    return torch.relu(h) if name != "dec3" else h


def apply(params: Params, x: torch.Tensor, style: torch.Tensor,
          compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x: (B, H, W, 3) in [0, 1]; style: (B, 100) f32. Returns the sigmoid
    output, (B, H, W, 3) f32."""
    x = x.permute(0, 3, 1, 2)
    for kind, name, _, _, k, stride in LAYERS:
        x = _layer(kind, name, params[name], x, style, k, stride, compute_dtype)
    return torch.sigmoid(x.float()).permute(0, 2, 3, 1)
