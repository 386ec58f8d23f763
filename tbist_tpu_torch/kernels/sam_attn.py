"""K4: SAM global attention with the decomposed relative-position bias, on
the hand-written CUDA kernel of ``csrc/sam_attn.cu``.

Replaces ``tbist_tpu/ops/pallas_sam_attn.py`` (``attention_with_rel_bias``
:57, kernel ``_kernel`` :34). The JAX package takes its kernel only for
grids of 4096 tokens or more on a TPU (``sam._use_pallas_attn``); the port's
``models.sam`` sends every global-attention layer on a CUDA tensor here,
whatever the grid.

A CUDA tensor goes to the kernel (or raises); a CPU tensor takes the plain
PyTorch version beside it. The wrapper counts its launches in
``attention_with_rel_bias.launches``. Inference only: no backward.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tbist_tpu_torch.kernels import _build

MAX_HEAD_DIM = 128


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("sam_attn.cu")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tbist_sam_attn.argtypes = [p, p, p, p, p, p, i64, i64, i64, i64, i64, p]
    lib.tbist_sam_attn.restype = ctypes.c_int
    return lib


def attention_with_rel_bias_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_h: torch.Tensor, bias_w: torch.Tensor, h: int, w: int,
) -> torch.Tensor:
    """The einsum formulation (``tbist_tpu/models/sam.py:127-131``): the
    (N, T, T) bias materialised, added to q·kᵀ, softmax, then ·v."""
    n, t, _ = q.shape
    bias = (bias_h.reshape(n, t, h, 1) + bias_w.reshape(n, t, 1, w)).reshape(n, t, t)
    logits = torch.matmul(q, k.transpose(1, 2)) + bias
    return torch.matmul(torch.softmax(logits, -1), v)


def attention_with_rel_bias(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_h: torch.Tensor, bias_w: torch.Tensor, h: int, w: int,
) -> torch.Tensor:
    """q (pre-scaled), k, v: (N, T, d); bias_h: (N, T, h); bias_w: (N, T, w)
    with T = h·w in row-major (y, x) order. Returns the f32 (N, T, d)
    softmax(q kᵀ + bias) v, where bias[i, j] = bias_h[i, j // w] + bias_w[i, j % w]."""
    if q.device.type == "cpu":
        return attention_with_rel_bias_plain(q, k, v, bias_h, bias_w, h, w)
    if q.dim() != 3:
        raise ValueError(f"sam_attn: q must be (N, T, d), got {tuple(q.shape)}")
    n, t, d = q.shape
    want = {"q": (n, t, d), "k": (n, t, d), "v": (n, t, d),
            "bias_h": (n, t, h), "bias_w": (n, t, w)}
    for name, x in zip(want, (q, k, v, bias_h, bias_w)):
        if not x.is_cuda or x.device != q.device:
            raise ValueError(f"sam_attn {name}: expected a CUDA or CPU tensor on "
                             f"{q.device}, got {x.device}")
        if x.dtype != torch.float32:
            raise TypeError(f"sam_attn {name}: dtype {x.dtype}, expected torch.float32")
        if tuple(x.shape) != want[name]:
            raise ValueError(f"sam_attn {name}: shape {tuple(x.shape)}, expected {want[name]}")
        if not x.is_contiguous():
            raise ValueError(f"sam_attn {name}: tensor must be contiguous")
    if t != h * w:
        raise ValueError(f"sam_attn: T = {t} is not h·w = {h}·{w}")
    if d % 4 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"sam_attn: head dim {d} must be a multiple of 4 in (0, {MAX_HEAD_DIM}]")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        # a block's shared memory grows with d, h and w: past the card's
        # limit the launch is refused and err says so
        err = _lib().tbist_sam_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(),
            out.data_ptr(), n, t, d, h, w, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"sam_attn: kernel launch failed with CUDA error {err}")
    attention_with_rel_bias.launches += 1
    return out


attention_with_rel_bias.launches = 0
