"""Depth-Anything-V2-Small parameters for the port (counterpart of the
weight code in ``tbist_tpu.models.depth_anything``: ``convert_hf_state_dict``
:258-370, ``get_depth_estimator`` :447-460).

Parameters are plain dicts (and lists) of tensors with the JAX package's
keys; ``models.depth_anything`` says which layouts they hold. Three sources:

- ``from_jax_params``: the JAX package's parameter tree as numpy arrays
  (tests share weights this way);
- ``convert_hf_state_dict``: a ``DepthAnythingForDepthEstimation`` state
  dict with HF's keys, read by ``get_depth_estimator``;
- ``models.depth_anything.init_params``: seeded random weights.

Hazard, the transposed-conv flip. The JAX converter turns torch's (in, out,
kh, kw) ConvTranspose2d weight into HWIO without flipping it (:309), and
``lax.conv_transpose`` then correlates, so on the same checkpoint the JAX
package computes HF's reassemble upsampling with the kernel flipped in both
spatial axes. The port is held against the JAX package: ``from_jax_params``
flips, and ``convert_hf_state_dict`` builds the JAX tree and goes through it.
"""

from __future__ import annotations

import functools
import os
from typing import Callable, Dict, Mapping

import numpy as np
import torch

from tbist_tpu_torch.parallel import mesh as mesh_lib

from tbist_tpu_torch.models import depth_anything as da
from tbist_tpu_torch.utils.imageio import resolve_device, tree_to
from tbist_tpu_torch.utils.logging import logger
from tbist_tpu_torch.weights.sam import _conv_from_hwio, _convT_from_hwio, _tensor

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights_cache",
)


def from_jax_params(np_tree) -> Dict:
    """The JAX package's Depth Anything parameters, as numpy arrays, -> the
    port's CPU tensors: HWIO convolutions to (out, in, kh, kw), the
    reassemble transposed convolutions (``up_w``) to flipped (in, out, kh,
    kw), everything else as it is."""

    def convert(tree, key=None):
        if isinstance(tree, Mapping):
            return {k: convert(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [convert(v) for v in tree]
        if np.ndim(tree) == 4:
            return _convT_from_hwio(tree) if key == "up_w" else _conv_from_hwio(tree)
        return _tensor(tree)

    return convert(np_tree)


def convert_hf_state_dict(sd: Mapping, cfg: da.DAConfig = da.SMALL) -> Dict:
    """A ``DepthAnythingForDepthEstimation`` state dict (numpy or tensor
    values, HF's keys) -> the port's parameters. It builds the tree that the
    JAX package's converter builds, then goes through ``from_jax_params``,
    so on the same ``sd`` the two packages compute the same function."""

    def arr(k):
        v = sd[k]
        return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v, np.float32)

    def lin_w(k):
        return arr(k).T

    def conv_w(k):  # (out, in, kh, kw) -> HWIO
        return np.transpose(arr(k), (2, 3, 1, 0))

    def ln(prefix):
        return {"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    blocks = []
    for i in range(cfg.layers):
        p = f"backbone.encoder.layer.{i}"
        a = f"{p}.attention.attention"
        blocks.append({
            "ln1": ln(f"{p}.norm1"), "ln2": ln(f"{p}.norm2"),
            "attn": {
                "qkv_w": np.concatenate([lin_w(f"{a}.{n}.weight")
                                         for n in ("query", "key", "value")], axis=1),
                "qkv_b": np.concatenate([arr(f"{a}.{n}.bias") for n in ("query", "key", "value")]),
                "proj_w": lin_w(f"{p}.attention.output.dense.weight"),
                "proj_b": arr(f"{p}.attention.output.dense.bias"),
            },
            "ls1": arr(f"{p}.layer_scale1.lambda1"),
            "ls2": arr(f"{p}.layer_scale2.lambda1"),
            "mlp_fc1_w": lin_w(f"{p}.mlp.fc1.weight"), "mlp_fc1_b": arr(f"{p}.mlp.fc1.bias"),
            "mlp_fc2_w": lin_w(f"{p}.mlp.fc2.weight"), "mlp_fc2_b": arr(f"{p}.mlp.fc2.bias"),
        })

    reassemble = []
    for i in range(4):
        p = f"neck.reassemble_stage.layers.{i}"
        proj = arr(f"{p}.projection.weight")  # a 1x1 conv or a linear
        entry = {"proj_w": proj[..., 0, 0].T if proj.ndim == 4 else proj.T,
                 "proj_b": arr(f"{p}.projection.bias")}
        if i < 2:  # transposed conv (in, out, kh, kw) -> HWIO, not flipped (JAX :309)
            entry["up_w"] = np.transpose(arr(f"{p}.resize.weight"), (2, 3, 0, 1))
            entry["up_b"] = arr(f"{p}.resize.bias")
        elif i == 3:  # stride-2 conv
            entry["down_w"] = conv_w(f"{p}.resize.weight")
            entry["down_b"] = arr(f"{p}.resize.bias")
        reassemble.append(entry)

    def res_unit(prefix):
        return {"conv1_w": conv_w(f"{prefix}.convolution1.weight"),
                "conv1_b": arr(f"{prefix}.convolution1.bias"),
                "conv2_w": conv_w(f"{prefix}.convolution2.weight"),
                "conv2_b": arr(f"{prefix}.convolution2.bias")}

    fusion = [{
        "res1": res_unit(f"neck.fusion_stage.layers.{i}.residual_layer1"),
        "res2": res_unit(f"neck.fusion_stage.layers.{i}.residual_layer2"),
        "proj_w": conv_w(f"neck.fusion_stage.layers.{i}.projection.weight"),
        "proj_b": arr(f"neck.fusion_stage.layers.{i}.projection.bias"),
    } for i in range(4)]

    head = {}
    for n in (1, 2, 3):
        head[f"conv{n}_w"] = conv_w(f"head.conv{n}.weight")
        head[f"conv{n}_b"] = arr(f"head.conv{n}.bias")
    emb = "backbone.embeddings"
    return from_jax_params({
        "patch_embed_w": conv_w(f"{emb}.patch_embeddings.projection.weight"),
        "patch_embed_b": arr(f"{emb}.patch_embeddings.projection.bias"),
        "cls_token": arr(f"{emb}.cls_token")[0],
        "pos_embed": arr(f"{emb}.position_embeddings"),
        "backbone_ln": ln("backbone.layernorm"),
        "blocks": blocks,
        "reassemble": reassemble,
        "neck_convs": [{"w": conv_w(f"neck.convs.{i}.weight")} for i in range(4)],
        "fusion": fusion,
        "head": head,
    })


@functools.lru_cache(maxsize=None)
def get_depth_estimator(device="cuda") -> Callable:
    """The (B, H, W, 3) -> (H, W) depth callable on ``device`` from the
    checkpoint at ``TBIST_DEPTH_PTH`` or
    ``weights_cache/depth_anything_v2_small.pth``; raises
    ``FileNotFoundError`` when there is none. A missing card raises too.
    An image on another card runs there, on a replica of the weights made
    the first time (the depth lanes of a dp mesh)."""
    device = resolve_device(device)
    path = os.environ.get("TBIST_DEPTH_PTH",
                          os.path.join(_CACHE_DIR, "depth_anything_v2_small.pth"))
    if not os.path.exists(path):
        raise FileNotFoundError(f"no Depth-Anything checkpoint at {path}")
    sd = torch.load(path, map_location="cpu", weights_only=True)
    params = tree_to(convert_hf_state_dict(sd), device)
    logger.info("Depth-Anything: converted checkpoint from %s", path)
    return mesh_lib.Replicated(_predict_small, params)


def _predict_small(params, image: torch.Tensor) -> torch.Tensor:
    return da.predict_depth(params, da.SMALL, image)
