"""Seeded weights, made on the device from the run's seed in a few large
draws, in the parameter trees the port takes from a checkpoint.

The benchmark hands the same tensors to the port (through the
``ModelRegistry`` it fills) and to the plain reference. Trained weights do
not change the work, only the numbers; these distributions keep every
layer's activations and gradients of order one, so that a fault anywhere in
a model shows in the comparison:

- VGG-19: He normal, std sqrt(2 / fan_in), zero biases (the port's own
  seeded draw takes the same distribution); weights OIHW in channels-last
  strides, as the port's loader keeps them.
- Depth-Anything-V2-Small: linear and convolution weights normal with std
  sqrt(1 / fan_in), zero biases, LayerNorms one and zero, LayerScale one,
  CLS token and position table normal x 0.02; the head's last 1x1
  convolution takes the absolute values of its draw, so that the ReLU'd
  relative depth it gives is positive, as a trained model's is.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.work.flops import VGG19_LAYERS


def _draw(shapes: List[Tuple[int, ...]], seed: int, device) -> List[torch.Tensor]:
    """Standard normal tensors of ``shapes``: views of one draw from a
    generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    return [t.view(s) for t, s in zip(torch.split(flat, sizes), shapes)]


def vgg19(seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{convX_Y: {"weight": (O, I, 3, 3) channels-last, "bias": (O,)}}``
    for all 16 convolutions of configuration E."""
    convs = [s for s in VGG19_LAYERS if len(s) == 3]
    draws = _draw([(cout, cin, 3, 3) for _, cin, cout in convs], seed, device)
    return {name: {"weight": (w * math.sqrt(2.0 / (9 * cin))).contiguous(
                       memory_format=torch.channels_last),
                   "bias": torch.zeros(cout, device=device)}
            for (name, cin, cout), w in zip(convs, draws)}


def depth_anything(da: Dict, seed: int, device) -> Dict:
    """The port's Depth Anything tree (``models.depth_anything`` keys and
    layouts: linear weights (in, out), convolutions (out, in, kh, kw),
    transposed convolutions (in, out, k, k)) for the widths in ``da``."""
    d, f, hh, p = da["width"], da["fusion"], da["head_hidden"], da["patch"]
    mlp = d * da["mlp_ratio"]
    factors = (4, 2, 1, 2)
    spec: List[Tuple[str, Tuple[int, ...], float]] = []  # path, shape, std

    def w(path, shape, fan_in):
        spec.append((path, shape, math.sqrt(1.0 / fan_in)))

    w("patch_embed_w", (d, 3, p, p), 3 * p * p)
    spec.append(("cls_token", (1, d), 0.02))
    spec.append(("pos_embed", (1, 1 + da["pos_grid"] ** 2, d), 0.02))
    for i in range(da["layers"]):
        b = f"blocks.{i}."
        w(b + "attn.qkv_w", (d, 3 * d), d)
        w(b + "attn.proj_w", (d, d), d)
        w(b + "mlp_fc1_w", (d, mlp), d)
        w(b + "mlp_fc2_w", (mlp, d), mlp)
    for i, c in enumerate(da["neck_dims"]):
        r = f"reassemble.{i}."
        w(r + "proj_w", (d, c), d)
        if i < 2:
            w(r + "up_w", (c, c, factors[i], factors[i]), c)
        elif i == 3:
            w(r + "down_w", (c, c, 3, 3), 9 * c)
        w(f"neck_convs.{i}.w", (f, c, 3, 3), 9 * c)
    for i in range(4):
        for unit in ("res1", "res2"):
            for k in ("conv1_w", "conv2_w"):
                w(f"fusion.{i}.{unit}.{k}", (f, f, 3, 3), 9 * f)
        w(f"fusion.{i}.proj_w", (f, f, 1, 1), f)
    w("head.conv1_w", (hh, f, 3, 3), 9 * f)
    w("head.conv2_w", (hh, hh, 3, 3), 9 * hh)
    w("head.conv3_w", (1, hh, 1, 1), hh)
    draws = _draw([s for _, s, _ in spec], seed, device)
    leaves = {path: t * std for (path, _, std), t in zip(spec, draws)}
    leaves["head.conv3_w"] = leaves["head.conv3_w"].abs()

    def zeros(n):
        return torch.zeros(n, device=device)

    def ln(n):
        return {"scale": torch.ones(n, device=device), "bias": zeros(n)}

    def unit(i, name):
        return {"conv1_w": leaves[f"fusion.{i}.{name}.conv1_w"], "conv1_b": zeros(f),
                "conv2_w": leaves[f"fusion.{i}.{name}.conv2_w"], "conv2_b": zeros(f)}

    blocks = [{
        "ln1": ln(d), "ln2": ln(d),
        "attn": {"qkv_w": leaves[f"blocks.{i}.attn.qkv_w"], "qkv_b": zeros(3 * d),
                 "proj_w": leaves[f"blocks.{i}.attn.proj_w"], "proj_b": zeros(d)},
        "ls1": torch.ones(d, device=device), "ls2": torch.ones(d, device=device),
        "mlp_fc1_w": leaves[f"blocks.{i}.mlp_fc1_w"], "mlp_fc1_b": zeros(mlp),
        "mlp_fc2_w": leaves[f"blocks.{i}.mlp_fc2_w"], "mlp_fc2_b": zeros(d),
    } for i in range(da["layers"])]
    reassemble = []
    for i, c in enumerate(da["neck_dims"]):
        entry = {"proj_w": leaves[f"reassemble.{i}.proj_w"], "proj_b": zeros(c)}
        if i < 2:
            entry.update(up_w=leaves[f"reassemble.{i}.up_w"], up_b=zeros(c))
        elif i == 3:
            entry.update(down_w=leaves[f"reassemble.{i}.down_w"], down_b=zeros(c))
        reassemble.append(entry)
    return {
        "patch_embed_w": leaves["patch_embed_w"], "patch_embed_b": zeros(d),
        "cls_token": leaves["cls_token"], "pos_embed": leaves["pos_embed"],
        "backbone_ln": ln(d), "blocks": blocks, "reassemble": reassemble,
        "neck_convs": [{"w": leaves[f"neck_convs.{i}.w"]} for i in range(4)],
        "fusion": [{"res1": unit(i, "res1"), "res2": unit(i, "res2"),
                    "proj_w": leaves[f"fusion.{i}.proj_w"], "proj_b": zeros(f)}
                   for i in range(4)],
        "head": {"conv1_w": leaves["head.conv1_w"], "conv1_b": zeros(hh),
                 "conv2_w": leaves["head.conv2_w"], "conv2_b": zeros(hh),
                 "conv3_w": leaves["head.conv3_w"], "conv3_b": zeros(1)},
    }
