"""GroundingDINO (SwinT-OGC) parameters for the port (counterpart of
the JAX package's ``weights/dino_convert.py`` and of ``init_params``
in its ``models/dino.py``).

Parameters are plain dicts (and lists) of tensors with the JAX package's
keys; ``models.dino`` says which layouts they hold. Three sources:

- ``from_jax_params``: the JAX package's parameter tree as numpy arrays
  (tests share weights this way);
- ``convert``: an official ``groundingdino_swint_ogc.pth`` state dict, read
  by ``models.dino_sam.get_loaded_params``;
- ``init_params``: seeded random weights from a ``torch.Generator`` with the
  JAX init's distributions (the same distribution, not the same numbers).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from tbist_tpu_torch.models import bert as bert_lib
from tbist_tpu_torch.models import dino as dino_lib
from tbist_tpu_torch.models import swin as swin_lib
from tbist_tpu_torch.weights.sam import _conv_from_hwio, _map, _tensor, to_device


def from_jax_params(np_tree: Mapping) -> Dict:
    """The JAX package's DINO parameters, as numpy arrays, -> the port's CPU
    tensors: the HWIO convolutions (Swin's patch embed, the four input
    projections) to (out, in, kh, kw), everything else as it is."""
    params = _map(np_tree, _tensor)
    params["swin"]["patch_embed_w"] = _conv_from_hwio(np_tree["swin"]["patch_embed_w"])
    for p, src in zip(params["input_proj"], np_tree["input_proj"]):
        p["w"] = _conv_from_hwio(src["w"])
    return params


def convert(
    sd_raw,
    cfg: dino_lib.DinoConfig = dino_lib.BASE,
    swin_cfg: swin_lib.SwinConfig = swin_lib.TINY,
    bert_cfg: bert_lib.BertConfig = bert_lib.BASE,
) -> Dict:
    """An official-layout state dict (numpy or tensor values, with or without
    a ``module.`` prefix) -> the port's parameters. It builds the tree that
    the JAX package's converter builds, then goes through
    ``from_jax_params``."""
    sd = {}
    for k, v in sd_raw.items():
        k = k[len("module."):] if k.startswith("module.") else k
        sd[k] = np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float32)

    def arr(k):
        return sd[k]

    def lin_w(k):
        return sd[k].T

    def ln(k):
        return {"scale": arr(f"{k}.weight"), "bias": arr(f"{k}.bias")}

    def wb(prefix, name):
        return {f"{name}_w": lin_w(f"{prefix}.weight"), f"{name}_b": arr(f"{prefix}.bias")}

    def mha(prefix):
        return {"in_proj_w": lin_w(f"{prefix}.in_proj_weight"),
                "in_proj_b": arr(f"{prefix}.in_proj_bias"),
                "out_proj_w": lin_w(f"{prefix}.out_proj.weight"),
                "out_proj_b": arr(f"{prefix}.out_proj.bias")}

    def deform(prefix):
        out = {}
        for name in ("value_proj", "sampling_offsets", "attention_weights", "output_proj"):
            out.update(wb(f"{prefix}.{name}", name))
        return out

    def mlp(prefix, n):
        return [{"w": lin_w(f"{prefix}.layers.{i}.weight"), "b": arr(f"{prefix}.layers.{i}.bias")}
                for i in range(n)]

    input_proj = [{"w": np.transpose(arr(f"input_proj.{i}.0.weight"), (2, 3, 1, 0)),
                   "b": arr(f"input_proj.{i}.0.bias"), "gn": ln(f"input_proj.{i}.1")}
                  for i in range(4)]

    fusion_layers, text_layers, enc_layers = [], [], []
    for i in range(cfg.enc_layers):
        f = f"transformer.encoder.fusion_layers.{i}"
        fusion = {"ln_v": ln(f"{f}.layer_norm_v"), "ln_l": ln(f"{f}.layer_norm_l"),
                  "gamma_v": arr(f"{f}.gamma_v"), "gamma_l": arr(f"{f}.gamma_l")}
        for name in ("v_proj", "l_proj", "values_v", "values_l", "out_v", "out_l"):
            src = f"{name}_proj" if name.startswith(("values", "out")) else name
            fusion.update(wb(f"{f}.attn.{src}", name))
        fusion_layers.append(fusion)
        tl = f"transformer.encoder.text_layers.{i}"
        text_layers.append({"self_attn": mha(f"{tl}.self_attn"), "ln1": ln(f"{tl}.norm1"),
                            "ln2": ln(f"{tl}.norm2"), **wb(f"{tl}.linear1", "fc1"),
                            **wb(f"{tl}.linear2", "fc2")})
        el = f"transformer.encoder.layers.{i}"
        enc_layers.append({"deform": deform(f"{el}.self_attn"), "ln1": ln(f"{el}.norm1"),
                           "ln2": ln(f"{el}.norm2"), **wb(f"{el}.linear1", "fc1"),
                           **wb(f"{el}.linear2", "fc2")})

    dec_layers = []
    for i in range(cfg.dec_layers):
        dl = f"transformer.decoder.layers.{i}"
        dec_layers.append({
            "self_attn": mha(f"{dl}.self_attn"), "text_cross": mha(f"{dl}.ca_text"),
            "deform": deform(f"{dl}.cross_attn"),
            "ln_self": ln(f"{dl}.norm2"), "ln_text": ln(f"{dl}.catext_norm"),
            "ln_cross": ln(f"{dl}.norm1"), "ln_ffn": ln(f"{dl}.norm3"),
            **wb(f"{dl}.linear1", "fc1"), **wb(f"{dl}.linear2", "fc2"),
        })

    return from_jax_params({
        "swin": swin_lib.convert_torch_state_dict(sd, "backbone.0.", swin_cfg),
        "bert": bert_lib.convert_hf_state_dict(sd, "bert.", bert_cfg),
        "feat_map_w": lin_w("feat_map.weight"),
        "feat_map_b": arr("feat_map.bias"),
        "input_proj": input_proj,
        "level_embed": arr("transformer.level_embed"),
        "fusion_layers": fusion_layers,
        "text_layers": text_layers,
        "enc_layers": enc_layers,
        "dec_layers": dec_layers,
        "enc_output_w": lin_w("transformer.enc_output.weight"),
        "enc_output_b": arr("transformer.enc_output.bias"),
        "enc_output_ln": ln("transformer.enc_output_norm"),
        "enc_bbox_mlp": mlp("transformer.enc_out_bbox_embed", 3),
        "bbox_mlp": mlp("bbox_embed.0", 3),
        "ref_point_head": mlp("transformer.decoder.ref_point_head", 2),
        "dec_norm": ln("transformer.decoder.norm"),
        "tgt_embed": arr("transformer.tgt_embed.weight"),
    })


def init_params(
    generator: torch.Generator,
    cfg: dino_lib.DinoConfig = dino_lib.BASE,
    swin_cfg: swin_lib.SwinConfig = swin_lib.TINY,
    bert_cfg: bert_lib.BertConfig = bert_lib.BASE,
    device="cpu",
) -> Dict:
    """Seeded random parameters with the tree and distributions of the JAX
    package's ``dino.init_params``: weights normal ×0.02, biases zero,
    LayerNorms and GroupNorms ones and zeros, the sampling offsets ×0.001
    (their bias ×0.01), the attention weights ×0.001, fusion gammas 0.125.
    Drawn on the CPU from ``generator``, then moved to ``device``."""

    def nrm(*shape, scale=0.02):
        return torch.randn(shape, generator=generator) * scale

    def zeros(n):
        return torch.zeros(n)

    def ln(n):
        return {"scale": torch.ones(n), "bias": zeros(n)}

    def lin(cin, cout):
        return {"w": nrm(cin, cout), "b": zeros(cout)}

    def mha(d):
        return {"in_proj_w": nrm(d, 3 * d), "in_proj_b": zeros(3 * d),
                "out_proj_w": nrm(d, d), "out_proj_b": zeros(d)}

    d = cfg.d_model
    hlp = cfg.heads * cfg.levels * cfg.points

    def deform():
        return {"value_proj_w": nrm(d, d), "value_proj_b": zeros(d),
                "sampling_offsets_w": nrm(d, hlp * 2, scale=0.001),
                "sampling_offsets_b": nrm(hlp * 2, scale=0.01),
                "attention_weights_w": nrm(d, hlp, scale=0.001),
                "attention_weights_b": zeros(hlp),
                "output_proj_w": nrm(d, d), "output_proj_b": zeros(d)}

    def ffn(width):
        return {"fc1_w": nrm(d, width), "fc1_b": zeros(width), "fc2_w": nrm(width, d),
                "fc2_b": zeros(d)}

    def fusion():
        fd = cfg.fusion_dim
        out = {"ln_v": ln(d), "ln_l": ln(d), "gamma_v": torch.full((d,), 0.125),
               "gamma_l": torch.full((d,), 0.125)}
        for name in ("v_proj", "l_proj", "values_v", "values_l"):
            out.update({f"{name}_w": nrm(d, fd), f"{name}_b": zeros(fd)})
        for name in ("out_v", "out_l"):
            out.update({f"{name}_w": nrm(fd, d), f"{name}_b": zeros(d)})
        return out

    swin_dims = [swin_cfg.embed_dim * (2**i) for i in swin_cfg.out_indices]
    input_proj = [{"w": nrm(d, swin_dims[i], 1, 1), "b": zeros(d), "gn": ln(d)} for i in range(3)]
    input_proj.append({"w": nrm(d, swin_dims[-1], 3, 3), "b": zeros(d), "gn": ln(d)})
    params = {
        "swin": swin_lib.init_params(generator, swin_cfg),
        "bert": bert_lib.init_params(generator, bert_cfg),
        "feat_map_w": nrm(bert_cfg.hidden, d),
        "feat_map_b": zeros(d),
        "input_proj": input_proj,
        "level_embed": nrm(cfg.levels, d),
        "fusion_layers": [fusion() for _ in range(cfg.enc_layers)],
        # the text enhancer's FFN is half the encoder's (official TextTransformer)
        "text_layers": [{"self_attn": mha(d), "ln1": ln(d), "ln2": ln(d), **ffn(cfg.ffn // 2)}
                        for _ in range(cfg.enc_layers)],
        "enc_layers": [{"deform": deform(), "ln1": ln(d), "ln2": ln(d), **ffn(cfg.ffn)}
                       for _ in range(cfg.enc_layers)],
        "dec_layers": [{"self_attn": mha(d), "text_cross": mha(d), "deform": deform(),
                        "ln_self": ln(d), "ln_text": ln(d), "ln_cross": ln(d), "ln_ffn": ln(d),
                        **ffn(cfg.ffn)} for _ in range(cfg.dec_layers)],
        "enc_output_w": nrm(d, d),
        "enc_output_b": zeros(d),
        "enc_output_ln": ln(d),
        "enc_bbox_mlp": [lin(d, d), lin(d, d), lin(d, 4)],
        "ref_point_head": [lin(2 * d, d), lin(d, d)],
        "dec_norm": ln(d),
        "bbox_mlp": [lin(d, d), lin(d, d), lin(d, 4)],
        "tgt_embed": nrm(cfg.num_queries, d),
    }
    return to_device(params, device)
