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
- GroundingDINO SwinT-OGC and SAM ViT-B (``groundingdino``, ``sam``): see
  their functions; the detector's draw also fixes how many boxes it keeps.
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


# ---------------------------------------------------------------------------
# the location cell: GroundingDINO SwinT-OGC and SAM ViT-B
# ---------------------------------------------------------------------------


def _nest(leaves: Dict[str, torch.Tensor]) -> Dict:
    """Dotted paths -> nested dicts, a numeric part a list index."""
    root: Dict = {}
    for path, value in leaves.items():
        parts = path.split(".")
        node = root
        for a, b in zip(parts[:-1], parts[1:]):
            node = node.setdefault(a, [] if b.isdigit() else {}) if isinstance(node, dict) \
                else _item(node, int(a), [] if b.isdigit() else {})
        last = parts[-1]
        if isinstance(node, dict):
            node[last] = value
        else:
            _item(node, int(last), value)
    return root


def _item(seq: list, i: int, default):
    while len(seq) <= i:
        seq.append(None)
    if seq[i] is None:
        seq[i] = default
    return seq[i]


class _Spec:
    """Leaves by path: drawn ones (standard normal times a std, one draw
    for all) and fixed ones (ones, zeros, constants)."""

    def __init__(self):
        self.drawn: List[Tuple[str, Tuple[int, ...], float]] = []
        self.fixed: Dict[str, Tuple[Tuple[int, ...], float]] = {}

    def w(self, path, shape, fan_in=None, std=None):
        self.drawn.append((path, tuple(shape), std if std is not None else fan_in ** -0.5))

    def const(self, path, shape, value=0.0):
        self.fixed[path] = (tuple(shape), value)

    def ln(self, path, n):
        self.const(path + ".scale", (n,), 1.0)
        self.const(path + ".bias", (n,), 0.0)

    def lin(self, path, cin, cout, bias=True, std=None):
        self.w(path + "_w", (cin, cout), cin, std)
        if bias:
            self.const(path + "_b", (cout,))

    def build(self, seed: int, device) -> Dict[str, torch.Tensor]:
        draws = _draw([s for _, s, _ in self.drawn], seed, device)
        leaves = {p: t * std for (p, _, std), t in zip(self.drawn, draws)}
        for p, (shape, value) in self.fixed.items():
            leaves[p] = torch.full(shape, value, device=device)
        return leaves


def groundingdino(cfg: Dict, seed: int, device) -> Dict:
    """The port's GroundingDINO tree (``models.dino``, ``swin``, ``bert``
    keys) at the widths of ``cfg`` (the configuration's ``groundingdino``).

    Linear and convolution weights normal with std sqrt(1 / fan_in), biases
    zero, LayerNorms and GroupNorms one and zero; embeddings, the relative
    position tables and the level embeddings normal x 0.02 (BERT's and
    Swin's init); the fusion layers' layer scales 0.125. Deformable
    attention as Deformable DETR initialises it: the sampling offsets'
    bias a ring of directions, one a head, point k at k + 1 cells, their
    weights and the attention weights' normal x 0.01. The number of boxes
    is fixed by the draw (``cfg["boxes_kept"]``, the configuration's
    ``assumed``): a unit direction u of zero mean; the content queries of
    the first ``boxes_kept`` slots 2 x 16 u and of the others -2 x 16 u,
    on top of their normal draw; the decoder's residual branches (the
    output projections of its attention and FFN) x 0.1, so that a slot
    keeps its sign through six layers; the last text layer's LayerNorm
    scale 0.05 and bias 0.5 u, so that every token's feature lies near u.
    The final logit of slot i is then near +-7 on every image and prompt."""
    sw, bc, d = cfg["swin"], cfg["bert"], cfg["d_model"]
    s = _Spec()
    e, win = sw["embed_dim"], sw["window"]
    s.w("swin.patch_embed_w", (e, 3, 4, 4), 48)
    s.const("swin.patch_embed_b", (e,))
    s.ln("swin.patch_embed_ln", e)
    dim = e
    for si, depth in enumerate(sw["depths"]):
        heads = sw["heads"][si]
        for bi in range(depth):
            b = f"swin.stages.{si}.blocks.{bi}."
            s.ln(b + "ln1", dim)
            s.ln(b + "ln2", dim)
            s.lin(b + "attn.qkv", dim, 3 * dim)
            s.lin(b + "attn.proj", dim, dim)
            s.w(b + "attn.rel_bias_table", ((2 * win - 1) ** 2, heads), std=0.02)
            s.lin(b + "mlp_fc1", dim, sw["mlp_ratio"] * dim)
            s.lin(b + "mlp_fc2", sw["mlp_ratio"] * dim, dim)
        if si < len(sw["depths"]) - 1:
            s.ln(f"swin.stages.{si}.downsample.ln", 4 * dim)
            s.w(f"swin.stages.{si}.downsample.reduction_w", (4 * dim, 2 * dim), 4 * dim)
        if si >= 1:
            s.ln(f"swin.out_ln{si}", dim)
        dim = dim * 2 if si < len(sw["depths"]) - 1 else dim
    h, f = bc["hidden"], bc["ffn"]
    s.w("bert.word_emb", (bc["vocab"], h), std=0.02)
    s.w("bert.pos_emb", (bc["max_pos"], h), std=0.02)
    s.w("bert.type_emb", (bc["type_vocab"], h), std=0.02)
    s.ln("bert.emb_ln", h)
    for i in range(bc["layers"]):
        b = f"bert.blocks.{i}."
        for n in ("q", "k", "v", "o"):
            s.lin(b + n, h, h)
        s.ln(b + "attn_ln", h)
        s.lin(b + "fc1", h, f)
        s.lin(b + "fc2", f, h)
        s.ln(b + "ffn_ln", h)
    s.lin("feat_map", h, d)
    widths = [e * 2 ** i for i in range(len(sw["depths"]))][1:]
    for i, c in enumerate(widths):
        s.w(f"input_proj.{i}.w", (d, c, 1, 1), c)
        s.const(f"input_proj.{i}.b", (d,))
        s.ln(f"input_proj.{i}.gn", d)
    s.w("input_proj.3.w", (d, widths[-1], 3, 3), 9 * widths[-1])
    s.const("input_proj.3.b", (d,))
    s.ln("input_proj.3.gn", d)
    s.w("level_embed", (cfg["levels"], d), std=0.02)
    heads, lv, pts = cfg["heads"], cfg["levels"], cfg["points"]
    hlp = heads * lv * pts
    fd = cfg["fusion_dim"]

    def mha(path, scale=1.0):
        s.lin(path + ".in_proj", d, 3 * d)
        s.w(path + ".out_proj_w", (d, d), std=scale * d ** -0.5)
        s.const(path + ".out_proj_b", (d,))

    def deform(path, scale=1.0):
        s.lin(path + ".value_proj", d, d)
        s.lin(path + ".sampling_offsets", d, 2 * hlp, bias=False, std=0.01)
        s.w(path + ".attention_weights_w", (d, hlp), std=0.01)
        s.const(path + ".attention_weights_b", (hlp,))
        s.w(path + ".output_proj_w", (d, d), std=scale * d ** -0.5)
        s.const(path + ".output_proj_b", (d,))

    def ffn(path, width, scale=1.0):
        s.lin(path + "fc1", d, width)
        s.w(path + "fc2_w", (width, d), std=scale * width ** -0.5)
        s.const(path + "fc2_b", (d,))

    for i in range(cfg["enc_layers"]):
        b = f"fusion_layers.{i}."
        s.ln(b + "ln_v", d)
        s.ln(b + "ln_l", d)
        s.const(b + "gamma_v", (d,), 0.125)
        s.const(b + "gamma_l", (d,), 0.125)
        for n in ("v_proj", "l_proj", "values_v", "values_l"):
            s.lin(b + n, d, fd)
        for n in ("out_v", "out_l"):
            s.lin(b + n, fd, d)
        mha(f"text_layers.{i}.self_attn")
        s.ln(f"text_layers.{i}.ln1", d)
        s.ln(f"text_layers.{i}.ln2", d)
        ffn(f"text_layers.{i}.", cfg["ffn"] // 2)
        deform(f"enc_layers.{i}.deform")
        s.ln(f"enc_layers.{i}.ln1", d)
        s.ln(f"enc_layers.{i}.ln2", d)
        ffn(f"enc_layers.{i}.", cfg["ffn"])
    for i in range(cfg["dec_layers"]):
        b = f"dec_layers.{i}."
        mha(b + "self_attn", 0.1)
        mha(b + "text_cross", 0.1)
        deform(b + "deform", 0.1)
        for n in ("ln_self", "ln_text", "ln_cross", "ln_ffn"):
            s.ln(b + n, d)
        ffn(b, cfg["ffn"], 0.1)
    s.lin("enc_output", d, d)
    s.ln("enc_output_ln", d)
    for name, dims in (("enc_bbox_mlp", (d, d, d, 4)), ("bbox_mlp", (d, d, d, 4)),
                       ("ref_point_head", (2 * d, d, d))):
        for j in range(len(dims) - 1):
            s.w(f"{name}.{j}.w", (dims[j], dims[j + 1]), dims[j])
            s.const(f"{name}.{j}.b", (dims[j + 1],))
    s.ln("dec_norm", d)
    s.w("tgt_embed", (cfg["num_queries"], d), std=1.0)
    s.w("slot_direction", (d,), std=1.0)
    leaves = s.build(seed, device)

    # Deformable DETR's ring of sampling directions
    theta = torch.arange(heads, dtype=torch.float32, device=device) * (2 * math.pi / heads)
    ring = torch.stack([theta.cos(), theta.sin()], -1)
    ring = ring / ring.abs().max(-1, keepdim=True).values
    ring = ring[:, None, None, :].repeat(1, lv, pts, 1)
    ring = ring * torch.arange(1, pts + 1, dtype=torch.float32, device=device)[None, None, :,
                                                                               None]
    for i in range(cfg["enc_layers"]):
        leaves[f"enc_layers.{i}.deform.sampling_offsets_b"] = ring.flatten()
    for i in range(cfg["dec_layers"]):
        leaves[f"dec_layers.{i}.deform.sampling_offsets_b"] = ring.flatten()

    # the slots: boxes_kept of them towards u, the rest away from it
    u = leaves.pop("slot_direction")
    u = u - u.mean()
    u = u / u.norm()
    sign = torch.full((cfg["num_queries"], 1), -1.0, device=device)
    sign[:cfg["boxes_kept"]] = 1.0
    leaves["tgt_embed"] = leaves["tgt_embed"] + sign * (2.0 * math.sqrt(d)) * u
    last = f"text_layers.{cfg['enc_layers'] - 1}.ln2"
    leaves[last + ".scale"] = torch.full((d,), 0.05, device=device)
    leaves[last + ".bias"] = 0.5 * u
    return _nest(leaves)


def sam(cfg: Dict, seed: int, device) -> Dict:
    """The port's SAM tree (``models.sam`` keys) at the widths of ``cfg``
    (the configuration's ``sam``): linear and convolution weights normal
    with std sqrt(1 / fan_in), biases zero, LayerNorms one and zero; the
    position grid and the relative-position tables normal x 0.02, each
    global layer's tables at 2g - 1 rows and each window layer's at
    2 x window - 1; ``pe_gaussian`` an unscaled standard normal, as SAM
    initialises it; the prompt's embeddings and tokens standard normal."""
    dm, e, heads = cfg["width"], cfg["embed_dim"], cfg["heads"]
    g = cfg["img_size"] // cfg["patch"]
    p = cfg["patch"]
    s = _Spec()
    s.w("patch_embed_w", (dm, 3, p, p), 3 * p * p)
    s.const("patch_embed_b", (dm,))
    s.w("pos_embed", (1, g, g, dm), std=0.02)
    for i in range(cfg["layers"]):
        b = f"blocks.{i}."
        rows = 2 * g - 1 if i in cfg["global_layers"] else 2 * cfg["window"] - 1
        s.ln(b + "ln1", dm)
        s.ln(b + "ln2", dm)
        s.lin(b + "attn.qkv", dm, 3 * dm)
        s.lin(b + "attn.proj", dm, dm)
        s.w(b + "attn.rel_pos_h", (rows, dm // heads), std=0.02)
        s.w(b + "attn.rel_pos_w", (rows, dm // heads), std=0.02)
        s.lin(b + "mlp_fc1", dm, 4 * dm)
        s.lin(b + "mlp_fc2", 4 * dm, dm)
    s.w("neck_conv1_w", (e, dm, 1, 1), dm)
    s.ln("neck_ln1", e)
    s.w("neck_conv2_w", (e, e, 3, 3), 9 * e)
    s.ln("neck_ln2", e)
    s.w("pe_gaussian", (2, e // 2), std=1.0)
    s.w("point_embed", (4, e), std=1.0)
    s.w("no_mask_embed", (e,), std=1.0)
    s.w("iou_token", (e,), std=1.0)
    s.w("mask_tokens", (cfg["num_mask_tokens"], e), std=1.0)

    def attn(path, inner):
        for n in ("q", "k", "v"):
            s.lin(f"{path}.{n}", e, inner)
        s.lin(f"{path}.out", inner, e)

    for i in range(cfg["decoder_layers"]):
        b = f"decoder_blocks.{i}."
        attn(b + "self_attn", e)
        attn(b + "cross_t2i", e // 2)
        attn(b + "cross_i2t", e // 2)
        for n in ("ln1", "ln2", "ln3", "ln4"):
            s.ln(b + n, e)
        s.lin(b + "mlp_fc1", e, cfg["mlp_dim"])
        s.lin(b + "mlp_fc2", cfg["mlp_dim"], e)
    attn("final_t2i", e // 2)
    s.ln("final_ln", e)
    s.w("upscale_conv1_w", (e, e // 4, 2, 2), e)
    s.const("upscale_conv1_b", (e // 4,))
    s.ln("upscale_ln", e // 4)
    s.w("upscale_conv2_w", (e // 4, e // 8, 2, 2), e // 4)
    s.const("upscale_conv2_b", (e // 8,))
    for t in range(cfg["num_mask_tokens"]):
        for j, (a, b) in enumerate(((e, e), (e, e), (e, e // 8))):
            s.w(f"hyper_mlps.{t}.{j}.w", (a, b), a)
            s.const(f"hyper_mlps.{t}.{j}.b", (b,))
    return _nest(s.build(seed, device))
