"""Weights of the feed-forward text path (counterpart of
``tbist_tpu.weights.ghiasi_convert``).

``get_params`` resolves, in the JAX package's order:

1. ``TBIST_GHIASI_PTH`` / ``TBIST_CLIP_MLP_PTH``, or ``image_transformer.pth``
   and ``clip_text_embedding_transformer.pth`` in ``<repo>/weights_cache/``:
   the reference checkpoints (``state_dict_ghiasi`` with
   ``layers.{i}.conv.weight``, ``layers.{i}.fc_beta.weight``, ... for the
   11-layer ModuleList; a Sequential ``model.{0,2,4,6,8}``).
2. The JAX package's seeded init, computed in numpy
   (``utils/threefry.py``) and equal to it leaf for leaf. These are
   placeholder weights: they mark ``degraded`` ``ghiasi_seeded``.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from tbist_tpu_torch.models import clip_mlp, ghiasi
from tbist_tpu_torch.utils import degraded, threefry
from tbist_tpu_torch.utils.imageio import resolve_device, tree_to
from tbist_tpu_torch.utils.logging import logger

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights_cache",
)


def _film_fields(kind: str) -> Tuple[str, ...]:
    """A layer's FiLM linears."""
    if kind == "res":
        return ("fc_gamma1", "fc_beta1", "fc_gamma2", "fc_beta2")
    if kind == "up":
        return ("fc_gamma", "fc_beta")
    return ()


def _conv_param(kernel_hwio, bias) -> Dict[str, torch.Tensor]:
    w = torch.from_numpy(np.ascontiguousarray(np.transpose(np.asarray(kernel_hwio, np.float32),
                                                           (3, 2, 0, 1))))
    return {"weight": w.contiguous(memory_format=torch.channels_last),
            "bias": torch.from_numpy(np.array(bias, np.float32))}


def _linear_param(p) -> Dict[str, torch.Tensor]:
    return {"weight": torch.from_numpy(np.array(p["kernel"], np.float32)),
            "bias": torch.from_numpy(np.array(p["bias"], np.float32))}


def from_jax_params(g_tree: Mapping, m_list=()) -> Tuple[ghiasi.Params, clip_mlp.Params]:
    """The JAX package's numpy trees (HWIO kernels, (in, out) linears) ->
    the port's (ghiasi, clip_mlp) CPU parameters."""
    g: ghiasi.Params = {}
    for kind, name, *_ in ghiasi.LAYERS:
        p = g_tree[name]
        if kind == "res":
            g[name] = {c: _conv_param(p[c]["kernel"], p[c]["bias"]) for c in ("conv1", "conv2")}
        else:
            g[name] = _conv_param(p["kernel"], p["bias"])
        for f in _film_fields(kind):
            g[name][f] = _linear_param(p[f])
    return g, [_linear_param(p) for p in m_list]


def seeded_init() -> Tuple[Dict, List]:
    """The JAX package's seeded (ghiasi, clip_mlp) init as numpy trees:
    ``ghiasi.init_params(fold_in(key(0), 1))`` and
    ``clip_mlp.init_params(fold_in(key(0), 2))``. Each kernel and bias is a
    uniform draw in ±1/√fan_in, the bound computed in f64 (as under the
    x64 test suite that writes the JAX package's cache) and rounded to f32."""

    def draw(k1, k2, shape_k, fan_in):
        bound = 1.0 / np.sqrt(np.float64(fan_in))
        return {"kernel": threefry.uniform(k1, shape_k, -bound, bound),
                "bias": threefry.uniform(k2, (shape_k[-1],), -bound, bound)}

    def conv(key, cin, cout, k):
        return draw(*threefry.split(key), (k, k, cin, cout), cin * k * k)

    def film(key, cout):
        return draw(*threefry.split(key), (ghiasi.STYLE_DIM, cout), ghiasi.STYLE_DIM)

    root = threefry.key(0)
    key = threefry.fold_in(root, 1)
    g: Dict = {}
    for kind, name, cin, cout, k, _ in ghiasi.LAYERS:
        key, sub = threefry.split(key)
        if kind == "conv":
            g[name] = conv(sub, cin, cout, k)
        elif kind == "up":
            s1, s2, s3 = threefry.split(sub, 3)
            g[name] = {**conv(s1, cin, cout, k), "fc_gamma": film(s2, cout),
                       "fc_beta": film(s3, cout)}
        else:
            ks = threefry.split(sub, 6)
            g[name] = {"conv1": conv(ks[0], cin, cout, k), "conv2": conv(ks[1], cout, cout, k)}
            for i, f in enumerate(("fc_gamma1", "fc_beta1", "fc_gamma2", "fc_beta2")):
                g[name][f] = film(ks[2 + i], cout)
    key = threefry.fold_in(root, 2)
    mlp = []
    for cin, cout in zip(clip_mlp.SIZES[:-1], clip_mlp.SIZES[1:]):
        key, k1, k2 = threefry.split(key, 3)
        mlp.append(draw(k1, k2, (cin, cout), cin))
    return g, mlp


def convert_ghiasi(sd) -> ghiasi.Params:
    """Reference ``state_dict_ghiasi`` (torch OIHW, (out, in) linears) ->
    the port's Ghiasi parameters."""
    def conv(key):
        w = np.asarray(sd[f"{key}.weight"], np.float32)
        return np.transpose(w, (2, 3, 1, 0)), np.asarray(sd[f"{key}.bias"], np.float32)

    def lin(key):
        return {"kernel": np.asarray(sd[f"{key}.weight"], np.float32).T,
                "bias": np.asarray(sd[f"{key}.bias"], np.float32)}

    tree: Dict = {}
    for i, (kind, name, *_) in enumerate(ghiasi.LAYERS):
        pre = f"layers.{i}"
        if kind == "res":
            tree[name] = {c: dict(zip(("kernel", "bias"), conv(f"{pre}.{c}")))
                          for c in ("conv1", "conv2")}
        else:
            tree[name] = dict(zip(("kernel", "bias"), conv(f"{pre}.conv")))
        for f in _film_fields(kind):
            tree[name][f] = lin(f"{pre}.{f}")
    return from_jax_params(tree)[0]


def convert_clip_mlp(sd) -> clip_mlp.Params:
    """Reference Sequential state dict ``model.{0,2,4,6,8}`` -> the MLP."""
    return [_linear_param({"kernel": np.asarray(sd[f"model.{i}.weight"], np.float32).T,
                           "bias": np.asarray(sd[f"model.{i}.bias"], np.float32)})
            for i in (0, 2, 4, 6, 8)]


@functools.lru_cache(maxsize=None)
def get_params(device="cuda") -> Tuple[ghiasi.Params, clip_mlp.Params]:
    """(ghiasi, clip_mlp) parameters on ``device`` (see the module
    docstring for the search order)."""
    device = resolve_device(device)
    g_path = os.environ.get("TBIST_GHIASI_PTH", os.path.join(_CACHE_DIR, "image_transformer.pth"))
    m_path = os.environ.get("TBIST_CLIP_MLP_PTH",
                            os.path.join(_CACHE_DIR, "clip_text_embedding_transformer.pth"))
    if os.path.exists(g_path) and os.path.exists(m_path):
        ckpt = torch.load(g_path, map_location="cpu", weights_only=True)
        g_sd = ckpt.get("state_dict_ghiasi", ckpt)
        g = convert_ghiasi({k: v.numpy() for k, v in g_sd.items()})
        m_sd = torch.load(m_path, map_location="cpu", weights_only=True)
        m = convert_clip_mlp({k: v.numpy() for k, v in m_sd.items()})
        logger.info("Ghiasi/CLIP-MLP: converted reference checkpoints")
        return tree_to(g, device), tree_to(m, device)
    degraded.mark("text_transfer", "ghiasi_seeded")
    logger.warning("Ghiasi/CLIP-MLP: no checkpoints — seeded init (set TBIST_GHIASI_PTH "
                   "and TBIST_CLIP_MLP_PTH for the reference weights)")
    g, m = from_jax_params(*seeded_init())
    return tree_to(g, device), tree_to(m, device)
