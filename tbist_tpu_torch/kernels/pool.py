"""K2: 2x2/2 max pool whose backward splits ties evenly, on the
hand-written CUDA kernel of ``csrc/pool_bwd.cu`` (``FUSE_RELU`` off).

Replaces ``tbist_tpu/ops/pallas_pool.py`` (``_bwd_pallas`` :87, kernel
``_bwd_kernel`` :56, custom VJP ``max_pool_2x2_even`` :117-133). The
forward is the plain reshape-max, as in the JAX package. ``F.max_pool2d``
is never differentiated: its backward sends a window's whole gradient to
one argmax, where JAX splits it among tied maxima.

The VGG trunk uses the fused relu variant (``kernels.relu_pool``, K3) at
every pool; this un-fused variant is held against its plain version at the
same shapes. A CUDA tensor goes to the kernel (or raises); a CPU tensor
takes the plain version.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tbist_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("pool_bwd.cu")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tbist_pool_bwd.argtypes = [p, p, p, p, i64, i64, i64, i64, ctypes.c_int, ctypes.c_int, p]
    lib.tbist_pool_bwd.restype = ctypes.c_int
    return lib


def pool_fwd(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max of an even-H/W NHWC tensor (reshape-max)."""
    b, h, w, c = x.shape
    return x.reshape(b, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


def pool_bwd_plain(
    x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, relu: bool = False
) -> torch.Tensor:
    """gx = eq·up(g)/cnt with eq = (x == up(out)); with ``relu`` x is the
    pre-activation: the window is relu(x) and gx is also masked by x > 0."""
    b, h, w, c = x.shape
    x6 = x.reshape(b, h // 2, 2, w // 2, 2, c)
    v = torch.clamp_min(x6, 0) if relu else x6
    eq = (v == out[:, :, None, :, None, :]).to(x.dtype)
    cnt = torch.clamp_min(eq.sum(dim=(2, 4), keepdim=True), 1)
    gx = eq * g[:, :, None, :, None, :] / cnt
    if relu:
        gx = gx * (x6 > 0).to(x.dtype)
    return gx.reshape(b, h, w, c)


def launch_pool_bwd(
    name: str, x: torch.Tensor, out: torch.Tensor, g: torch.Tensor, fuse_relu: bool
) -> torch.Tensor:
    """Check the operands and launch ``tbist_pool_bwd``; returns gx."""
    if not x.is_cuda:
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {x.dtype} is neither float32 nor bfloat16")
    if x.dim() != 4 or x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name}: x must be NHWC with even H and W, got {tuple(x.shape)}")
    b, h, w, c = x.shape
    for t, label in ((out, "out"), (g, "g")):
        if t.shape != (b, h // 2, w // 2, c) or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(
                f"{name}: {label} {tuple(t.shape)} {t.dtype} does not fit x {tuple(x.shape)}"
            )
    for t, label in ((x, "x"), (out, "out"), (g, "g")):
        if not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous NHWC")
    gx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _lib().tbist_pool_bwd(
            x.data_ptr(), out.data_ptr(), g.data_ptr(), gx.data_ptr(), b, h, w, c,
            int(fuse_relu), _DTYPE_CODE[x.dtype], torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {err}")
    return gx


def pool_bwd(x: torch.Tensor, out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Tie-splitting backward of ``pool_fwd``: the gradient w.r.t. x."""
    if x.device.type == "cpu":
        return pool_bwd_plain(x, out, g)
    gx = launch_pool_bwd("pool_bwd", x, out, g, fuse_relu=False)
    _build.count_launch(pool_bwd)
    return gx


pool_bwd.launches = 0


class MaxPool2x2Even(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = pool_fwd(x)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        x, out = ctx.saved_tensors
        return pool_bwd(x, out, g.contiguous())


def max_pool_2x2_even(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool of an even-H/W NHWC tensor; ties split the gradient."""
    return MaxPool2x2Even.apply(x)
