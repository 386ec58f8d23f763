"""VGG-19 weight loading for the port (counterpart of ``tbist_tpu.weights.vgg``).

``get_params`` resolves, in order:

1. ``TBIST_VGG19_PTH`` or ``<repo>/weights_cache/vgg19.pth``: a torchvision
   state dict (``vgg19().features`` or full-model naming), already OIHW.
2. ``<repo>/weights_cache/vgg19.npz``: the JAX package's converted cache
   (HWIO kernels, keys ``<layer>.kernel`` / ``<layer>.bias``).
3. ``<repo>/weights_cache/vgg19_seeded_s<seed>.npz``: the JAX package's
   seeded-init cache (leaves by flattened pytree index).
4. He-init from a ``torch.Generator`` seeded with ``seed``, kept on disk in
   ``<repo>/weights_cache/torch/vgg19_seeded_s<seed>.pt`` by
   ``weights.seed_cache`` (``TBIST_SEED_CACHE=0`` draws anew).

3 and 4 are placeholder weights: they mark ``degraded`` ``vgg_seeded``.
None of these files is in git, so a fresh checkout runs on 4.

Parameters are ``{layer: {"weight": (O, I, 3, 3) channels_last, "bias"}}``.
"""

from __future__ import annotations

import os
from functools import lru_cache
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from tbist_tpu_torch.models import vgg19
from tbist_tpu_torch.utils import degraded
from tbist_tpu_torch.utils.imageio import resolve_device
from tbist_tpu_torch.utils.logging import logger

# torchvision vgg19().features indices of the 16 convs, in order
_TORCH_FEATURE_IDX = [0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34]

_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "weights_cache",
)


def _param(weight_oihw, bias) -> Dict[str, torch.Tensor]:
    w = torch.tensor(np.asarray(weight_oihw, dtype=np.float32))
    b = torch.tensor(np.asarray(bias, dtype=np.float32))
    return {"weight": w.contiguous(memory_format=torch.channels_last), "bias": b}


def from_jax_params(np_params: Mapping[str, Mapping[str, np.ndarray]]) -> vgg19.Params:
    """``{layer: {"kernel": HWIO, "bias"}}`` numpy arrays (the JAX
    package's parameter tree) -> the port's OIHW channels-last CPU tensors."""
    return {
        name: _param(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1)), p["bias"])
        for name, p in np_params.items()
    }


def convert_torch_state_dict(state_dict) -> vgg19.Params:
    """torchvision state dict (OIHW) -> the port's parameters."""
    params = {}
    for conv_name, idx in zip(vgg19.CONV_NAMES, _TORCH_FEATURE_IDX):
        for prefix in (f"features.{idx}", f"{idx}"):
            wkey, bkey = f"{prefix}.weight", f"{prefix}.bias"
            if wkey in state_dict:
                params[conv_name] = _param(
                    state_dict[wkey].float().numpy(), state_dict[bkey].float().numpy()
                )
                break
        else:
            raise KeyError(f"conv weights for {conv_name} not in state dict")
    return params


def _load_pth() -> Optional[vgg19.Params]:
    for path in (os.environ.get("TBIST_VGG19_PTH", ""), os.path.join(_CACHE_DIR, "vgg19.pth")):
        if path and os.path.exists(path):
            sd = torch.load(path, map_location="cpu", weights_only=True)
            if hasattr(sd, "state_dict"):
                sd = sd.state_dict()
            return convert_torch_state_dict(sd)
    return None


def _load_npz() -> Optional[vgg19.Params]:
    path = os.path.join(_CACHE_DIR, "vgg19.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)
    return from_jax_params(
        {n: {"kernel": data[f"{n}.kernel"], "bias": data[f"{n}.bias"]} for n in vgg19.CONV_NAMES}
    )


def _load_seeded_npz(seed: int) -> Optional[vgg19.Params]:
    path = os.path.join(_CACHE_DIR, f"vgg19_seeded_s{seed}.npz")
    if not os.path.exists(path):
        return None
    data = np.load(path)
    # leaves in jax.tree order: layers sorted by name, "bias" before "kernel"
    tree = {}
    for i, name in enumerate(sorted(vgg19.CONV_NAMES)):
        bias, kernel = data[str(2 * i)], data[str(2 * i + 1)]
        spec = next(s for s in vgg19.VGG19_LAYERS if s[0] == name)
        if kernel.shape != (3, 3, spec[1], spec[2]) or bias.shape != (spec[2],):
            return None  # stale cache of another model definition
        tree[name] = {"kernel": kernel, "bias": bias}
    return from_jax_params(tree)


@lru_cache(maxsize=1)
def get_params(seed: int = 0, device="cuda") -> vgg19.Params:
    """Resolve VGG-19 params (see module docstring for the search order)."""
    device = resolve_device(device)
    params = _load_pth()
    if params is not None:
        logger.info("VGG-19: loaded torchvision checkpoint")
    else:
        params = _load_npz()
        if params is not None:
            logger.info("VGG-19: loaded converted ImageNet weights from cache")
    if params is None:
        degraded.mark("vgg_params", "vgg_seeded")
        logger.warning(
            "VGG-19: no checkpoint found — using seeded init "
            "(set TBIST_VGG19_PTH to a torchvision vgg19 .pth for real weights)"
        )
        params = _load_seeded_npz(seed)
        if params is None:
            from tbist_tpu_torch.weights.seed_cache import cached_seeded_init

            spec = {name: {"weight": ((cout, cin, 3, 3), torch.float32),
                           "bias": ((cout,), torch.float32)}
                    for name, cin, cout in (s for s in vgg19.VGG19_LAYERS if len(s) == 3)}
            params = cached_seeded_init(
                f"vgg19_seeded_s{seed}",
                lambda: vgg19.init_params(torch.Generator().manual_seed(seed)), spec)
    return {
        name: {k: v.to(device) for k, v in p.items()} for name, p in params.items()
    }
