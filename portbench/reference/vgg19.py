"""Plain VGG-19 features (Simonyan & Zisserman, arXiv:1409.1556,
configuration E), in NCHW with ``torch.nn.functional`` alone.

The feature of ``convX_Y`` is that convolution's output before its ReLU
(Gatys et al., CVPR 2016, read through the reference app's ``Vgg19``
wrapper); every pool is a 2x2 max of the ReLU'd map whose gradient splits
a tie evenly among the tied maxima, as the JAX package's max reduction
differentiates (``F.max_pool2d`` would send it to one of them; flat regions
of a photograph give exact ties). The forward stops at the deepest
requested layer. Weights are the ``{convX_Y: {"weight": (O, I,
3, 3), "bias": (O,)}}`` tree the benchmark made; they are used as plain
contiguous NCHW tensors.
"""

from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn.functional as F

LAYERS = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), ("pool1",),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), ("pool2",),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv3_4", 256, 256), ("pool3",),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv4_4", 512, 512), ("pool4",),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
    ("conv5_4", 512, 512),
)
CONVS = tuple(s[0] for s in LAYERS if len(s) == 3)


def plain_weights(params) -> Dict[str, Dict[str, torch.Tensor]]:
    """The tree with every tensor contiguous in NCHW order."""
    return {k: {n: v.contiguous() for n, v in p.items()} for k, p in params.items()}


def features(params, x: torch.Tensor, layers: Sequence[str]) -> Dict[str, torch.Tensor]:
    """``{layer: (N, C, H, W) pre-ReLU activation}`` of the normalized
    NCHW batch ``x``."""
    wanted = set(layers)
    deepest = max(CONVS.index(l) for l in layers)
    out, h, k = {}, x, 0
    for spec in LAYERS:
        if len(spec) == 1:
            n, c, hh, ww = h.shape
            h = h[:, :, : hh - hh % 2, : ww - ww % 2]
            h = h.reshape(n, c, hh // 2, 2, ww // 2, 2).amax(dim=(3, 5))
            continue
        pre = F.conv2d(h, params[spec[0]]["weight"], params[spec[0]]["bias"], padding=1)
        if spec[0] in wanted:
            out[spec[0]] = pre
        if k == deepest:
            break
        h = F.relu(pre)
        k += 1
    return out
