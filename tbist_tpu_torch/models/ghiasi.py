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

``apply_sharded`` runs the same network over an image whose width is cut
into shards on several devices (``parallel.mesh``, 4-column blocks, so the
stride-2 convolutions and the 2× upsample stay on each shard): a k×k conv
first takes k//2 columns from either neighbour, and reflects at the image's
own edges only; the instance-norm mean and variance are summed over all
shards on the first device, in f32, and divided by the whole image's count;
FiLM is local.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from tbist_tpu_torch.parallel import mesh as mesh_lib

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


def _conv_sharded(xs: Sequence[torch.Tensor], ps, pad: int, stride: int,
                  dtype: torch.dtype) -> List[torch.Tensor]:
    """``_conv`` over NCHW width shards: the width's padding is the
    neighbours' columns (a reflection at the image's edges), the height's
    a local reflection."""
    out = []
    for x, p in zip(mesh_lib.halo(xs, pad, dim=3, edge="reflect"), ps):
        if pad:
            x = F.pad(x, (0, 0, pad, pad), mode="reflect")
        out.append(F.conv2d(x.to(dtype), p["weight"].to(dtype), stride=stride)
                   + p["bias"].to(dtype)[None, :, None, None])
    return out


def _instance_norm_sharded(xs: Sequence[torch.Tensor], eps: float = 1e-5) -> List[torch.Tensor]:
    """``_instance_norm`` of the image the NCHW shards make up: its mean,
    then its biased variance about that mean, each a sum over the shards on
    the first device in shard order over the whole image's count, in f32."""
    first = xs[0].device
    count = xs[0].shape[2] * sum(x.shape[3] for x in xs)
    mean = mesh_lib.sum_on([x.float().sum(dim=(2, 3)) for x in xs], first) / count
    means = [mean.to(x.device, non_blocking=True)[:, :, None, None] for x in xs]
    var = mesh_lib.sum_on([(x.float() - m).square().sum(dim=(2, 3))
                           for x, m in zip(xs, means)], first) / count
    scale = torch.rsqrt(var + eps)
    return [(x - m.to(x.dtype)) * scale.to(x.device, non_blocking=True)[:, :, None, None].to(x.dtype)
            for x, m in zip(xs, means)]


def apply_sharded(params: Sequence[Params], shards: Sequence[torch.Tensor],
                  styles: Sequence[torch.Tensor],
                  compute_dtype: torch.dtype = torch.float32) -> List[torch.Tensor]:
    """``apply`` over an NHWC image cut along its width into ``shards``
    (``mesh.width_plan`` with ``mesh.GHIASI_ALIGN`` and
    ``mesh.GHIASI_MIN_WIDTH``), shard ``i`` on its device with ``params[i]``
    and ``styles[i]`` there. Returns each shard's sigmoid output, NHWC f32;
    joined along the width they are ``apply`` of the whole image."""
    xs = [x.permute(0, 3, 1, 2) for x in shards]

    def film(ys, name, g, b):
        return [_film(y, p[name][g], p[name][b], st) for y, p, st in zip(ys, params, styles)]

    for kind, name, _, _, k, stride in LAYERS:
        ps = [p[name] for p in params]
        if kind == "conv":
            xs = [torch.relu(y) for y in
                  _instance_norm_sharded(_conv_sharded(xs, ps, k // 2, stride, compute_dtype))]
        elif kind == "res":
            y = _instance_norm_sharded(_conv_sharded(xs, [p["conv1"] for p in ps], 1, 1,
                                                     compute_dtype))
            y = [torch.relu(t) for t in film(y, name, "fc_gamma1", "fc_beta1")]
            y = _instance_norm_sharded(_conv_sharded(y, [p["conv2"] for p in ps], 1, 1,
                                                     compute_dtype))
            xs = [x + t for x, t in zip(xs, film(y, name, "fc_gamma2", "fc_beta2"))]
        else:
            h = xs if stride is None else [_upsample_nearest_2x(x) for x in xs]
            h = film(_instance_norm_sharded(_conv_sharded(h, ps, k // 2, 1, compute_dtype)),
                     name, "fc_gamma", "fc_beta")
            xs = h if name == "dec3" else [torch.relu(t) for t in h]
    return [torch.sigmoid(x.float()).permute(0, 2, 3, 1) for x in xs]
