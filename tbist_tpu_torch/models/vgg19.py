"""VGG-19 feature extractor, ported from ``tbist_tpu.models.vgg19``.

Same feature semantics as the JAX package (and the reference ``Vgg19``
wrapper, helper_functions.py:44-101): the activation captured for
``convX_Y`` is the conv output *before* its ReLU, and computation stops
after the deepest requested layer.

Layout: features are NHWC at the interface. Each conv runs on
``x.permute(0, 3, 1, 2)``, which for a contiguous NHWC tensor is an NCHW
view with channels-last strides; the weights are kept in
``torch.channels_last`` so cuDNN runs channels-last end to end and its
output permuted back is contiguous NHWC again.

Every conv is 3x3 with stride 1 and frozen weights, so its backward needs
the input gradient alone, which is itself a forward convolution: the output
gradient convolved with the weights flipped in both spatial axes, input and
output channels swapped, at padding ``2 - p``. ``TrunkConv`` runs it so, on
cuDNN's forward engines (cuDNN's heuristics pick FFT and legacy engines for
its own f32 input gradient, at less than half the forward's rate on an
H100); at the shapes where the chip measured cuDNN's own faster
(``flips``), the conv is plain ``F.conv2d`` and autograd's own. The flipped weights are made once per weight tensor and dtype
(``flipped_weight``) and kept while the weight lives.

Every pool is ``relu_max_pool_2x2_even`` (kernel K3): the relu is applied
inside it, and its backward splits ties evenly as JAX does.
``F.max_pool2d``'s backward, which sends the gradient to one argmax, is
never used.

``extract_features_sharded`` runs the same trunk over an image whose width
is cut into shards on several devices (``parallel.mesh``): before every 3×3
conv each shard takes one column from either neighbour (zeros at the
image's edges) and convolves with padding (1, 0), so each shard's output is
exactly its columns of the whole image's; relu and the pools (K3) stay on
the shard's own device.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.weak import WeakIdKeyDictionary

from tbist_tpu_torch.kernels.relu_pool import relu_max_pool_2x2_even
from tbist_tpu_torch.parallel import mesh as mesh_lib

# (layer_name, in_channels, out_channels); "pool" entries are 2x2/2 maxpools.
# Mirrors torchvision vgg19().features ordering.
VGG19_LAYERS: Tuple = (
    ("conv1_1", 3, 64),
    ("conv1_2", 64, 64),
    ("pool1",),
    ("conv2_1", 64, 128),
    ("conv2_2", 128, 128),
    ("pool2",),
    ("conv3_1", 128, 256),
    ("conv3_2", 256, 256),
    ("conv3_3", 256, 256),
    ("conv3_4", 256, 256),
    ("pool3",),
    ("conv4_1", 256, 512),
    ("conv4_2", 512, 512),
    ("conv4_3", 512, 512),
    ("conv4_4", 512, 512),
    ("pool4",),
    ("conv5_1", 512, 512),
    ("conv5_2", 512, 512),
    ("conv5_3", 512, 512),
    ("conv5_4", 512, 512),
)

CONV_NAMES: Tuple[str, ...] = tuple(
    spec[0] for spec in VGG19_LAYERS if spec[0].startswith("conv")
)

# {layer: {"weight": (O, I, 3, 3) channels_last, "bias": (O,)}}
Params = Dict[str, Dict[str, torch.Tensor]]


# weight -> {(kind, dtype): (weight._version when made, derived tensor)}
_DERIVED = WeakIdKeyDictionary()
_COUNT_LOCK = threading.Lock()


def _derived(weight: torch.Tensor, kind: str, dtype: torch.dtype, make) -> torch.Tensor:
    """``make(weight)``, made on the first call for a weight tensor, kind
    and dtype and kept while the weight lives (made again if the weight was
    written in place)."""
    per_kind = _DERIVED.get(weight)
    if per_kind is None:
        per_kind = _DERIVED[weight] = {}
    kept = per_kind.get((kind, dtype))
    if kept is None or kept[0] != weight._version:
        kept = per_kind[(kind, dtype)] = (weight._version, make(weight))
    return kept[1]


def flipped_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``weight`` (O, I, 3, 3) in ``dtype``, flipped in both spatial axes
    with O and I swapped: (I, O, 3, 3) in channels-last. Made once per
    weight tensor and dtype (``_derived``), so that a loop's steps launch
    no flip."""
    return _derived(weight, "flip", dtype, lambda w: w.detach().to(dtype).flip(2, 3)
                    .transpose(0, 1).contiguous(memory_format=torch.channels_last))


def cast_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``weight.to(dtype)``, made once per weight tensor and dtype
    (``_derived``), so that every request of a bf16 trunk reads the same
    tensors, as a captured Gatys step's key asks."""
    if weight.dtype == dtype:
        return weight
    return _derived(weight, "cast", dtype, lambda w: w.to(dtype))


# Where the flipped forward loses to cuDNN's own input gradient: ms cuDNN's
# own / flipped on an NVIDIA H100 80GB HBM3 at 700 W, f32, TF32 off, batch
# 1 (tools/vgg_dgrad_ab.py):
# - fewer than 64 input channels, so as few output channels in the flipped
#   conv: conv1_1 (3 -> 64) at 512² 0.170 / 0.407, at 1024² 0.607 / 1.581;
#   conv1_2 (64 -> 64) at 512² 0.925 / 0.579;
# - fewer than 64² pixels: 512 -> 512 at 16², 24², 32² (conv5_1), 48² 0.079
#   / 0.135, 0.111 / 0.214, 0.171 / 0.221, 0.345 / 0.487; at 64² (conv4_2)
#   0.588 / 0.520. (At 96², off the 512px path, 1.277 / 1.540.)
# Over all 13 convs the rule beats cuDNN's own alone at 8 video frames of
# 480x864 (77.2 / 82.0 ms), in bf16 at 512² (0.612 / 0.739) and on quarter
# width shards (2.24 / 5.02), though some convs there take the slower way:
# at 8 frames cuDNN picks an FFT for conv3_1's flipped forward (17.4 /
# 3.96 ms).
_FLIP_MIN_IN_CHANNELS = 64
_FLIP_MIN_PIXELS = 64 * 64


def flips(x: torch.Tensor) -> bool:
    """Whether the input gradient of a trunk conv of NCHW ``x`` takes the
    flipped forward rather than cuDNN's own."""
    b, cin, h, w = x.shape
    return cin >= _FLIP_MIN_IN_CHANNELS and b * h * w >= _FLIP_MIN_PIXELS


class TrunkConv(torch.autograd.Function):
    """``F.conv2d(x, weight, bias, padding)`` for a 3x3 stride-1 conv whose
    weight and bias take no gradient. The forward is ``F.conv2d`` itself;
    the backward gives the input gradient alone, as the forward convolution
    of the output gradient with ``flipped_weight`` at padding ``2 - p`` on
    each axis."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding: Tuple[int, int]):
        ctx.padding = padding
        ctx.flipped = flipped_weight(weight, x.dtype)
        return F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), padding=padding)

    @staticmethod
    def backward(ctx, grad_out):
        ph, pw = ctx.padding
        grad_in = F.conv2d(grad_out, ctx.flipped, padding=(2 - ph, 2 - pw))
        return grad_in, None, None, None


_DGRAD_COUNTS = {"flipped": 0, "native": 0}


def dgrad_counts() -> Dict[str, int]:
    """Trunk convs run since the last reset whose input takes a gradient and
    whose weights take none, by the route of their input gradient:
    ``flipped`` (``TrunkConv``) or ``native`` (autograd's own)."""
    return dict(_DGRAD_COUNTS)


def reset_dgrad_counts() -> None:
    with _COUNT_LOCK:
        for route in _DGRAD_COUNTS:
            _DGRAD_COUNTS[route] = 0


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor], compute_dtype,
          padding=(1, 1)) -> torch.Tensor:
    x = x.to(compute_dtype).permute(0, 3, 1, 2)
    w, b = p["weight"], p["bias"]
    flip = False
    if x.requires_grad and not (w.requires_grad or b.requires_grad):
        flip = flips(x)
        with _COUNT_LOCK:
            _DGRAD_COUNTS["flipped" if flip else "native"] += 1
    if flip:
        out = TrunkConv.apply(x, w, b, padding)
    else:  # no input gradient, cuDNN's own faster, or a weight gradient
        out = F.conv2d(x, w.to(compute_dtype), b.to(compute_dtype), padding=padding)
    # No copy when the conv returned channels-last, as cuDNN does for
    # channels-last input; the kernels need contiguous NHWC either way.
    return out.permute(0, 2, 3, 1).contiguous()


def _deepest(layers: Sequence[str]) -> int:
    unknown = set(layers) - set(CONV_NAMES)
    if unknown:
        raise ValueError(f"Unknown VGG-19 layers: {sorted(unknown)}")
    return max(CONV_NAMES.index(l) for l in layers)


def _pool(pre: torch.Tensor) -> torch.Tensor:
    """relu + 2x2 max, odd remainders dropped."""
    _, ph, pw, _ = pre.shape
    if ph % 2 or pw % 2:
        pre = pre[:, : ph - ph % 2, : pw - pw % 2, :].contiguous()
    return relu_max_pool_2x2_even(pre)


def extract_features(
    params: Params,
    x: torch.Tensor,
    layers: Sequence[str],
    compute_dtype: torch.dtype = torch.float32,
) -> Dict[str, torch.Tensor]:
    """Run VGG-19 up to the deepest requested conv layer.

    ``x`` is a *normalized* NHWC image batch. Returns
    ``{layer: pre-ReLU conv activation (B, H', W', C')}`` in compute_dtype.
    """
    wanted = set(layers)
    deepest = _deepest(layers)

    feats: Dict[str, torch.Tensor] = {}
    h = x  # input of the next conv; None until the relu of `pre` is needed
    pre = None
    conv_idx = -1
    for spec in VGG19_LAYERS:
        if len(spec) == 1:
            h = _pool(pre)
            continue
        name = spec[0]
        conv_idx += 1
        if h is None:
            h = torch.relu(pre)
        pre = _conv(h, params[name], compute_dtype)
        h = None
        if name in wanted:
            feats[name] = pre
        if conv_idx == deepest:
            break
    return feats


def extract_features_sharded(
    params: Sequence[Params],
    shards: Sequence[torch.Tensor],
    layers: Sequence[str],
    compute_dtype: torch.dtype = torch.float32,
) -> Dict[str, List[torch.Tensor]]:
    """``extract_features`` over a normalized NHWC batch cut along its width
    into ``shards`` (``mesh.width_plan`` with ``mesh.VGG_ALIGN``, so every
    shard but the last keeps an even width down to conv5_1), shard ``i``
    on its own device with ``params[i]`` there. Returns ``{layer: [each
    shard's pre-ReLU activation]}``, whose concatenation along the width is
    ``extract_features`` of the whole image."""
    wanted = set(layers)
    deepest = _deepest(layers)
    feats: Dict[str, List[torch.Tensor]] = {}
    hs = list(shards)
    pres = None
    conv_idx = -1
    for spec in VGG19_LAYERS:
        if len(spec) == 1:
            hs = [_pool(pre) for pre in pres]
            continue
        name = spec[0]
        conv_idx += 1
        if hs is None:
            hs = [torch.relu(pre) for pre in pres]
        pres = [_conv(h, p[name], compute_dtype, padding=(1, 0))
                for h, p in zip(mesh_lib.halo(hs, 1, dim=2), params)]
        hs = None
        if name in wanted:
            feats[name] = pres
        if conv_idx == deepest:
            break
    return feats


def init_params(
    generator: torch.Generator, device="cpu", dtype: torch.dtype = torch.float32
) -> Params:
    """He-initialised parameters from a ``torch.Generator`` (used when no
    checkpoint exists). Same distribution as the JAX package's
    ``init_params``, not the same numbers: tests share weights through
    ``weights.vgg.from_jax_params`` instead."""
    params: Params = {}
    for spec in VGG19_LAYERS:
        if len(spec) == 1:
            continue
        name, cin, cout = spec
        fan_in = 3 * 3 * cin
        w = torch.randn((cout, cin, 3, 3), generator=generator, dtype=dtype)
        w = w * (2.0 / fan_in) ** 0.5
        params[name] = {
            "weight": w.to(device).contiguous(memory_format=torch.channels_last),
            "bias": torch.zeros((cout,), dtype=dtype, device=device),
        }
    return params
