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

Every pool is ``relu_max_pool_2x2_even`` (kernel K3): the relu is applied
inside it, and its backward splits ties evenly as JAX does.
``F.max_pool2d``'s backward, which sends the gradient to one argmax, is
never used.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from tbist_tpu_torch.kernels.relu_pool import relu_max_pool_2x2_even

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


def _conv(x: torch.Tensor, p: Dict[str, torch.Tensor], compute_dtype) -> torch.Tensor:
    out = F.conv2d(
        x.to(compute_dtype).permute(0, 3, 1, 2),
        p["weight"].to(compute_dtype),
        p["bias"].to(compute_dtype),
        padding=1,
    )
    # No copy when the conv returned channels-last, as cuDNN does for
    # channels-last input; the kernels need contiguous NHWC either way.
    return out.permute(0, 2, 3, 1).contiguous()


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
    unknown = wanted - set(CONV_NAMES)
    if unknown:
        raise ValueError(f"Unknown VGG-19 layers: {sorted(unknown)}")
    deepest = max(CONV_NAMES.index(l) for l in layers)

    feats: Dict[str, torch.Tensor] = {}
    h = x  # input of the next conv; None until the relu of `pre` is needed
    pre = None
    conv_idx = -1
    for spec in VGG19_LAYERS:
        if len(spec) == 1:  # pool: relu + 2x2 max, odd remainders dropped
            _, ph, pw, _ = pre.shape
            if ph % 2 or pw % 2:
                pre = pre[:, : ph - ph % 2, : pw - pw % 2, :].contiguous()
            h = relu_max_pool_2x2_even(pre)
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
