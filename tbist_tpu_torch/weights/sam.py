"""SAM ViT-B parameters for the port (counterpart of the weight code in
``tbist_tpu.models.sam``: ``convert_sam_state_dict`` :515, ``_init_params_impl``
:623).

Parameters are plain dicts (and lists) of tensors with the JAX package's
keys; ``models.sam`` says which layouts they hold. Three sources:

- ``from_jax_params``: the JAX package's parameter tree as numpy arrays
  (tests share weights this way);
- ``convert_sam_state_dict``: an official ``sam_vit_b_01ec64.pth`` state
  dict, read by ``models.sam.get_loaded_params``;
- ``init_params``: seeded random weights from a ``torch.Generator`` with the
  JAX init's distributions (the same distribution, not the same numbers).

Hazard, the transposed-conv flip. The JAX converter turns torch's
(in, out, kh, kw) ConvTranspose2d weight into HWIO without flipping it, and
``lax.conv_transpose`` (``transpose_kernel=False``) then correlates: on the
same weight the JAX package computes ``F.conv_transpose2d`` with the kernel
flipped in both spatial axes. The port is held against the JAX package, so
``_convT_from_hwio`` flips (2, 3), on both routes in.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from tbist_tpu_torch.models.sam import BASE, Params, SamConfig

_CONV_KEYS = ("patch_embed_w", "neck_conv1_w", "neck_conv2_w")
_CONVT_KEYS = ("upscale_conv1_w", "upscale_conv2_w")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv_from_hwio(a) -> torch.Tensor:
    return _tensor(np.transpose(np.asarray(a), (3, 2, 0, 1)))


def _convT_from_hwio(a) -> torch.Tensor:
    # HWIO -> (in, out, kh, kw), flipped: see the module docstring
    return _tensor(np.transpose(np.asarray(a), (2, 3, 0, 1))[:, :, ::-1, ::-1])


def _map(tree, fn):
    if isinstance(tree, Mapping):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def from_jax_params(np_tree: Mapping) -> Params:
    """The JAX package's SAM parameters, as numpy arrays, -> the port's CPU
    tensors: HWIO convs to (out, in, kh, kw), the transposed convs to
    flipped (in, out, kh, kw), everything else as it is."""
    params = {k: _map(v, _tensor) for k, v in np_tree.items()
              if k not in _CONV_KEYS + _CONVT_KEYS}
    params.update({k: _conv_from_hwio(np_tree[k]) for k in _CONV_KEYS})
    params.update({k: _convT_from_hwio(np_tree[k]) for k in _CONVT_KEYS})
    return params


def to_device(params: Params, device) -> Params:
    return _map(params, lambda t: t.to(device))


def convert_sam_state_dict(sd: Mapping, cfg: SamConfig = BASE) -> Params:
    """An official-layout state dict (numpy or tensor values) -> the port's
    parameters. It builds the tree that the JAX package's converter builds,
    then goes through ``from_jax_params``, so on the same ``sd`` the port
    computes what the JAX package computes."""

    def arr(k):
        v = sd[k]
        return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float32)

    def lin_w(k):
        return arr(k).T

    def conv_w(k):  # (out, in, kh, kw) -> HWIO
        return np.transpose(arr(k), (2, 3, 1, 0))

    def convT_w(k):  # (in, out, kh, kw) -> HWIO, as the JAX converter does
        return np.transpose(arr(k), (2, 3, 0, 1))

    def ln(prefix):
        return {"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    def attn_block(prefix):
        return {f"{n}_{s}": (lin_w if s == "w" else arr)(f"{prefix}.{n}_proj.{full}")
                for n in ("q", "k", "v", "out") for s, full in (("w", "weight"), ("b", "bias"))}

    blocks = []
    for i in range(cfg.layers):
        p = f"image_encoder.blocks.{i}"
        blocks.append({
            "ln1": ln(f"{p}.norm1"), "ln2": ln(f"{p}.norm2"),
            "attn": {
                "qkv_w": lin_w(f"{p}.attn.qkv.weight"), "qkv_b": arr(f"{p}.attn.qkv.bias"),
                "proj_w": lin_w(f"{p}.attn.proj.weight"), "proj_b": arr(f"{p}.attn.proj.bias"),
                "rel_pos_h": arr(f"{p}.attn.rel_pos_h"), "rel_pos_w": arr(f"{p}.attn.rel_pos_w"),
            },
            "mlp_fc1_w": lin_w(f"{p}.mlp.lin1.weight"), "mlp_fc1_b": arr(f"{p}.mlp.lin1.bias"),
            "mlp_fc2_w": lin_w(f"{p}.mlp.lin2.weight"), "mlp_fc2_b": arr(f"{p}.mlp.lin2.bias"),
        })

    dec_blocks = []
    for i in range(cfg.decoder_layers):
        p = f"mask_decoder.transformer.layers.{i}"
        dec_blocks.append({
            "self_attn": attn_block(f"{p}.self_attn"),
            "cross_t2i": attn_block(f"{p}.cross_attn_token_to_image"),
            "cross_i2t": attn_block(f"{p}.cross_attn_image_to_token"),
            **{f"ln{j}": ln(f"{p}.norm{j}") for j in range(1, 5)},
            "mlp_fc1_w": lin_w(f"{p}.mlp.lin1.weight"), "mlp_fc1_b": arr(f"{p}.mlp.lin1.bias"),
            "mlp_fc2_w": lin_w(f"{p}.mlp.lin2.weight"), "mlp_fc2_b": arr(f"{p}.mlp.lin2.bias"),
        })

    hyper_mlps = [
        [{"w": lin_w(f"mask_decoder.output_hypernetworks_mlps.{t}.layers.{li}.weight"),
          "b": arr(f"mask_decoder.output_hypernetworks_mlps.{t}.layers.{li}.bias")}
         for li in range(3)]
        for t in range(cfg.num_mask_tokens)
    ]

    return from_jax_params({
        "patch_embed_w": conv_w("image_encoder.patch_embed.proj.weight"),
        "patch_embed_b": arr("image_encoder.patch_embed.proj.bias"),
        "pos_embed": arr("image_encoder.pos_embed"),
        "blocks": blocks,
        "neck_conv1_w": conv_w("image_encoder.neck.0.weight"),
        "neck_ln1": ln("image_encoder.neck.1"),
        "neck_conv2_w": conv_w("image_encoder.neck.2.weight"),
        "neck_ln2": ln("image_encoder.neck.3"),
        "pe_gaussian": arr("prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"),
        "point_embed": np.stack(
            [arr(f"prompt_encoder.point_embeddings.{i}.weight")[0] for i in range(4)]
        ),
        "no_mask_embed": arr("prompt_encoder.no_mask_embed.weight")[0],
        "iou_token": arr("mask_decoder.iou_token.weight")[0],
        "mask_tokens": arr("mask_decoder.mask_tokens.weight"),
        "decoder_blocks": dec_blocks,
        "final_t2i": attn_block("mask_decoder.transformer.final_attn_token_to_image"),
        "final_ln": ln("mask_decoder.transformer.norm_final_attn"),
        "upscale_conv1_w": convT_w("mask_decoder.output_upscaling.0.weight"),
        "upscale_conv1_b": arr("mask_decoder.output_upscaling.0.bias"),
        "upscale_ln": ln("mask_decoder.output_upscaling.1"),
        "upscale_conv2_w": convT_w("mask_decoder.output_upscaling.3.weight"),
        "upscale_conv2_b": arr("mask_decoder.output_upscaling.3.bias"),
        "hyper_mlps": hyper_mlps,
    })


def init_params(generator: torch.Generator, cfg: SamConfig = BASE, device="cpu") -> Params:
    """Seeded random parameters at ``cfg`` with the distributions of the JAX
    package's ``_init_params_impl``: weights normal ×0.02, biases zero,
    LayerNorms ones and zeros, ``pe_gaussian`` an unscaled standard normal,
    and ``rel_pos`` with 2·window−1 rows at every layer (the global layers'
    tables are resized to the grid when used)."""

    def nrm(*shape, scale=0.02):
        return torch.randn(shape, generator=generator) * scale

    def zeros(n):
        return torch.zeros(n)

    def ln(n):
        return {"scale": torch.ones(n), "bias": zeros(n)}

    def attn_block(dq, inner):
        return {"q_w": nrm(dq, inner), "q_b": zeros(inner), "k_w": nrm(dq, inner),
                "k_b": zeros(inner), "v_w": nrm(dq, inner), "v_b": zeros(inner),
                "out_w": nrm(inner, dq), "out_b": zeros(dq)}

    d, e = cfg.width, cfg.embed_dim
    g = cfg.img_size // cfg.patch
    rel = 2 * cfg.window - 1
    blocks = [{
        "ln1": ln(d), "ln2": ln(d),
        "attn": {"qkv_w": nrm(d, 3 * d), "qkv_b": zeros(3 * d), "proj_w": nrm(d, d),
                 "proj_b": zeros(d), "rel_pos_h": nrm(rel, d // cfg.heads),
                 "rel_pos_w": nrm(rel, d // cfg.heads)},
        "mlp_fc1_w": nrm(d, 4 * d), "mlp_fc1_b": zeros(4 * d),
        "mlp_fc2_w": nrm(4 * d, d), "mlp_fc2_b": zeros(d),
    } for _ in range(cfg.layers)]
    dec_blocks = [{
        "self_attn": attn_block(e, e), "cross_t2i": attn_block(e, e // 2),
        "cross_i2t": attn_block(e, e // 2),
        "ln1": ln(e), "ln2": ln(e), "ln3": ln(e), "ln4": ln(e),
        "mlp_fc1_w": nrm(e, cfg.mlp_dim), "mlp_fc1_b": zeros(cfg.mlp_dim),
        "mlp_fc2_w": nrm(cfg.mlp_dim, e), "mlp_fc2_b": zeros(e),
    } for _ in range(cfg.decoder_layers)]
    hyper = [[{"w": nrm(e, e), "b": zeros(e)}, {"w": nrm(e, e), "b": zeros(e)},
              {"w": nrm(e, e // 8), "b": zeros(e // 8)}] for _ in range(cfg.num_mask_tokens)]
    params = {
        "patch_embed_w": nrm(d, 3, cfg.patch, cfg.patch), "patch_embed_b": zeros(d),
        "pos_embed": nrm(1, g, g, d),
        "blocks": blocks,
        "neck_conv1_w": nrm(e, d, 1, 1), "neck_ln1": ln(e),
        "neck_conv2_w": nrm(e, e, 3, 3), "neck_ln2": ln(e),
        "pe_gaussian": nrm(2, e // 2, scale=1.0),
        "point_embed": nrm(4, e), "no_mask_embed": nrm(e), "iou_token": nrm(e),
        "mask_tokens": nrm(cfg.num_mask_tokens, e),
        "decoder_blocks": dec_blocks,
        "final_t2i": attn_block(e, e // 2), "final_ln": ln(e),
        "upscale_conv1_w": nrm(e, e // 4, 2, 2), "upscale_conv1_b": zeros(e // 4),
        "upscale_ln": ln(e // 4),
        "upscale_conv2_w": nrm(e // 4, e // 8, 2, 2), "upscale_conv2_b": zeros(e // 8),
        "hyper_mlps": hyper,
    }
    return to_device(params, device)
