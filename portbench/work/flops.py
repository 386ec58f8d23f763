"""Operations and bytes of the cells' work, counted from shapes.

Nothing here reads a trace or the program: the counts follow from the
configuration's published widths and the image size. A roofline share is
the least time these counts need on the card (``peaks``) over the time the
trace gives the kernels that do the work.

- VGG-19 (configuration E) to its deepest loss layer: every 3x3
  convolution, forward and input gradient (the weights are frozen, so no
  weight gradient runs).
- K1, the style Gram and its backward, and K3, the relu-fused 2x2 pool
  backward, counted as ``chip_smoke.py`` counts them for their bounds.
- Depth-Anything-V2-Small (ViT-S/14 and its DPT neck and head) at its
  square input, forward and input gradient.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# VGG-19 configuration E, torchvision ``vgg19().features`` order
VGG19_LAYERS: Tuple = (
    ("conv1_1", 3, 64), ("conv1_2", 64, 64), ("pool1",),
    ("conv2_1", 64, 128), ("conv2_2", 128, 128), ("pool2",),
    ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv3_4", 256, 256), ("pool3",),
    ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv4_4", 512, 512), ("pool4",),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
    ("conv5_4", 512, 512),
)
F32 = 4  # bytes


def vgg_convs(h: int, w: int, layers: Sequence[str]) -> List[Tuple[str, int, int, int, int]]:
    """(name, H, W, Cin, Cout) of every convolution run up to the deepest of
    ``layers`` on an h x w image (each pool halves the sides)."""
    names = [s[0] for s in VGG19_LAYERS if len(s) == 3]
    deepest = max(names.index(l) for l in layers)
    out, k = [], 0
    for spec in VGG19_LAYERS:
        if len(spec) == 1:
            h, w = h // 2, w // 2
            continue
        if k > deepest:
            break
        out.append((spec[0], h, w, spec[1], spec[2]))
        k += 1
    return out


def vgg_conv_work(h: int, w: int, layers: Sequence[str]) -> Tuple[float, float]:
    """(bytes, flops) of the convolutions of one Gatys step: forward and
    input gradient, each a 3x3 'same' convolution. Bytes count each input,
    weight and output once, per direction."""
    flops = nbytes = 0.0
    for _, hh, ww, cin, cout in vgg_convs(h, w, layers):
        flops += 2 * (2.0 * hh * ww * cin * cout * 9)
        nbytes += 2 * F32 * (hh * ww * cin + hh * ww * cout + cin * cout * 9)
    return nbytes, flops


def gram_shapes(h: int, w: int, channels: Sequence[int], b: int = 1):
    """K1's (B, H·W, C) at the style layers, conv1_1 .. conv5_1."""
    return [(b, (h >> k) * (w >> k), c) for k, c in enumerate(channels)]


def pool_shapes(h: int, w: int, channels: Sequence[int], b: int = 1):
    """K3's (B, H, W, C) at the four pools."""
    return [(b, h >> k, w >> k, c) for k, c in enumerate(channels)]


GRAM_CHANNELS = (64, 128, 256, 512, 512)  # conv1_1 .. conv5_1
POOL_CHANNELS = (64, 128, 256, 512)  # pool1 .. pool4


def gram_fwd_work(b: int, n: int, c: int) -> Tuple[float, float]:
    """K1 forward: the symmetric Gram's C(C+1)/2 dot products of length n."""
    return b * (n * c * F32 + c * c * F32), b * n * c * (c + 1)


def gram_bwd_work(b: int, n: int, c: int) -> Tuple[float, float]:
    """K1 backward: dx = x @ M, read x and M, write dx."""
    return b * (2 * n * c * F32 + c * c * F32), b * 2.0 * n * c * c


def pool_bwd_work(b: int, h: int, w: int, c: int) -> Tuple[float, float]:
    """K3: read x and write dx, read the pooled output and its gradient (a
    quarter each); a compare and a scale per input element."""
    numel = b * h * w * c
    return 2.5 * numel * F32, 2.0 * numel


def bound_s(nbytes: float, flops: float, peak_flops: float, peak_bytes: float) -> float:
    """The least time the work can take: the larger of its two bounds."""
    return max(nbytes / peak_bytes, flops / peak_flops)


def kernel_bound_s(kind: str, h: int, w: int, peak_flops: float, peak_bytes: float) -> float:
    """Least seconds of one Gatys step's K1 forward (``gram_fwd``), K1
    backward (``gram_bwd``) or K3 (``pool_bwd``) on an h x w image, summed
    over the step's launches, each shape bounded on its own."""
    if kind == "pool_bwd":
        shapes, work = pool_shapes(h, w, POOL_CHANNELS), pool_bwd_work
    else:
        shapes = gram_shapes(h, w, GRAM_CHANNELS)
        work = gram_fwd_work if kind == "gram_fwd" else gram_bwd_work
    return sum(bound_s(*work(*s), peak_flops, peak_bytes) for s in shapes)


def gram_flops(h: int, w: int) -> float:
    """Model FLOPs of one step's Grams: forward (symmetric) and backward."""
    return sum(gram_fwd_work(*s)[1] + gram_bwd_work(*s)[1]
               for s in gram_shapes(h, w, GRAM_CHANNELS))


def depth_anything_flops(da: Dict) -> Dict[str, float]:
    """FLOPs of Depth-Anything-V2-Small at its ``input_size`` square input:
    ``forward``, and ``input_gradient`` (every linear and convolution's data
    gradient costs its forward; attention's backward takes four products of
    the two its forward takes). Elementwise work, norms, softmax and
    resizes are not counted."""
    p, d, size = da["patch"], da["width"], da["input_size"]
    g = size // p
    t = g * g + 1
    fwd = 2.0 * g * g * d * 3 * p * p  # patch embedding
    attn = 0.0
    for _ in range(da["layers"]):
        fwd += 2.0 * t * d * 3 * d + 2.0 * t * d * d  # qkv, output projection
        fwd += 2.0 * t * d * d * da["mlp_ratio"] * 2  # MLP
        attn += 2 * 2.0 * t * t * d  # q·kᵀ and attn·v over all heads
    f, hh = da["fusion"], da["head_hidden"]
    down = -(-g // 2)
    sides = (4 * g, 2 * g, g, down)  # reassembled grids, x4 x2 x1 x1/2
    for i, c in enumerate(da["neck_dims"]):
        fwd += 2.0 * g * g * d * c  # readout projection
        if i == 0:
            fwd += 2.0 * g * g * c * c * 16  # transposed conv 4x4, stride 4
        elif i == 1:
            fwd += 2.0 * g * g * c * c * 4  # transposed conv 2x2, stride 2
        elif i == 3:
            fwd += 2.0 * down * down * c * c * 9  # conv 3x3, stride 2
        fwd += 2.0 * sides[i] ** 2 * c * f * 9  # 3x3 conv to the fusion width
    conv3 = 2.0 * f * f * 9  # one 3x3 f -> f convolution, per output pixel
    for i in reversed(range(4)):  # deepest first
        units = 1 if i == 3 else 2  # res2 alone, or res1 and res2
        fwd += units * 2 * sides[i] ** 2 * conv3
        out = sides[i - 1] if i > 0 else 2 * sides[0]
        fwd += 2.0 * out * out * f * f  # 1x1 projection after the upsample
    top = 2 * sides[0]
    fwd += 2.0 * top * top * f * hh * 9  # head conv1
    fwd += 2.0 * size * size * hh * hh * 9 + 2.0 * size * size * hh  # conv2, conv3
    fwd += attn
    return {"forward": fwd, "input_gradient": fwd + attn}


def step_flops(cfg: Dict, h: int, w: int) -> float:
    """Model FLOPs of one optimisation step of ``cfg`` (a configuration
    file) on an h x w image: VGG-19's convolutions forward and input
    gradient, the Grams, and Depth Anything's forward and input gradient
    where the loss holds the depth term."""
    g = cfg["gatys"]
    layers = list(g["content_layers"]) + list(g["style_layers"])
    total = vgg_conv_work(h, w, layers)[1] + gram_flops(h, w)
    if cfg.get("depth_anything"):
        da = depth_anything_flops(cfg["depth_anything"])
        total += da["forward"] + da["input_gradient"]
    return total
