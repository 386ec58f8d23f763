"""Host-side image I/O and the host↔device boundary.

PIL stays on the host; device tensors are float32/bfloat16 NHWC in [0, 1],
as in ``tbist_tpu.utils.imageio``. Conversion happens once at the boundary.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from PIL import Image

ArrayLike = Union[np.ndarray, torch.Tensor]


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """The device an entry point runs on. A CUDA device that is not there
    raises: only an explicit ``"cpu"`` runs on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return device


def upload(x: ArrayLike, device: Union[str, torch.device]) -> torch.Tensor:
    """Array -> tensor on ``device``. A host array goes to a card from
    pinned memory without blocking, so the host does not wait for the
    card's queue to drain first (a plain copy from pageable memory does).
    A tensor already on a card moves as ``Tensor.to`` moves it."""
    t = torch.as_tensor(x)
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def load_image(path: str) -> Image.Image:
    """Open an image file as RGB PIL (host)."""
    return Image.open(path).convert("RGB")


def to_float(image: Union[Image.Image, np.ndarray]) -> np.ndarray:
    """PIL/uint8 HWC -> float32 HWC in [0, 1] (host-side, numpy)."""
    arr = np.asarray(image)
    if arr.dtype == np.uint8:
        arr = arr.astype(np.float32) / 255.0
    else:
        arr = arr.astype(np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] == 4:  # drop alpha, matching reference `[:3]` slices
        arr = arr[..., :3]
    if arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    return arr


def to_uint8(arr: ArrayLike) -> np.ndarray:
    """float [0,1] -> uint8, clipping. Accepts HWC or NHWC (squeezes N=1).
    Idempotent: uint8 input passes through unscaled."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu()
        arr = (arr.float() if arr.is_floating_point() else arr).numpy()
    arr = np.asarray(arr)
    if arr.ndim == 4 and arr.shape[0] == 1:
        arr = arr[0]
    if arr.dtype == np.uint8:
        return arr
    return np.clip(np.round(arr * 255.0), 0, 255).astype(np.uint8)


def to_pil(arr: ArrayLike) -> Image.Image:
    """Device/host float array -> PIL RGB (or L for single channel)."""
    u8 = to_uint8(arr)
    if u8.ndim == 3 and u8.shape[-1] == 1:
        u8 = u8[..., 0]
    return Image.fromarray(u8)


def save_image(arr: ArrayLike, path: str) -> None:
    to_pil(arr).save(path)


def bucket_shape(
    h: int, w: int, bucket: int = 32, max_side: Optional[int] = None
) -> Tuple[int, int]:
    """Static-shape policy: round (h, w) to multiples of ``bucket``.

    Rounding is to the *nearest* multiple (minimum one bucket), after an
    optional aspect-preserving downscale to ``max_side``. The port keeps the
    JAX package's policy so both packages optimise the same pixels.
    """
    if max_side is not None and max(h, w) > max_side:
        scale = max_side / max(h, w)
        h, w = int(round(h * scale)), int(round(w * scale))
    bh = max(bucket, int(round(h / bucket)) * bucket)
    bw = max(bucket, int(round(w / bucket)) * bucket)
    return bh, bw


def image_resize_bilinear(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize to ``size`` = (H, W), the counterpart of
    ``jax.image.resize(..., "bilinear")``. JAX antialiases when it shrinks,
    so this passes ``antialias=True`` (without it the two differ by up to
    0.5 on a shrink; with it they agree to float rounding both ways)."""
    y = F.interpolate(
        x.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
        align_corners=False, antialias=True,
    )
    return y.permute(0, 2, 3, 1).contiguous()


def to_device(
    image: Union[Image.Image, np.ndarray],
    bucket: Optional[int] = None,
    max_side: Optional[int] = None,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cuda",
) -> torch.Tensor:
    """Host image -> device NHWC float in [0,1], optionally shape-bucketed.

    The resize runs in float32; the result is then cast to ``dtype``."""
    arr = to_float(image)
    x = torch.from_numpy(arr)[None].to(resolve_device(device))
    if bucket is not None:
        h, w = x.shape[1], x.shape[2]
        bh, bw = bucket_shape(h, w, bucket, max_side)
        if (bh, bw) != (h, w):
            x = image_resize_bilinear(x, (bh, bw))
    return x.to(dtype)


def from_device(x: ArrayLike) -> Image.Image:
    """Device NHWC float -> PIL image (host). A float tensor is quantised to
    uint8 on its device before the copy, with ``to_uint8``'s semantics
    (clip(round(x*255)), round half to even as numpy does)."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        x = torch.clamp(torch.round(x.detach().float() * 255.0), 0, 255).to(torch.uint8)
    return to_pil(x)
