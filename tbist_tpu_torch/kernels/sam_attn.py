"""K4: SAM global attention with the decomposed relative-position bias,
on the hand-written CUDA kernels of ``csrc/sam_attn.cu``.

Replaces ``tbist_tpu/ops/pallas_sam_attn.py`` (``attention_with_rel_bias``
:57, kernel ``_kernel`` :34). The JAX package takes its kernel only for
grids of 4096 tokens or more on a TPU (``sam._use_pallas_attn``); the port's
``models.sam`` sends every global-attention layer on a CUDA tensor here,
whatever the grid.

The kernel runs both products on the tensor cores in 3xTF32 (each f32
operand split into two TF32 parts, three MMAs per product), which keeps
f32's accuracy; the bias and the softmax are f32. Where ``N·⌈T/64⌉`` blocks
cannot fill the card, ``kv_splits`` splits the keys: each split writes a
partial (O, m, l) to scratch and a second kernel merges them in split order
(``combine_splits_plain`` is its plain version). A call counts as one launch
either way.

A CUDA tensor goes to the kernels (or raises: a grid whose q tile's bias
rows do not fit a block's shared memory is refused by the kernel's entry
before any launch); a CPU tensor takes the plain PyTorch version beside
them. The wrapper counts its launches in
``attention_with_rel_bias.launches``. Inference only: no backward.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Tuple

import torch

from tbist_tpu_torch.kernels import _build

MAX_HEAD_DIM = 128
QUERY_TILE = 64  # query rows per block of sam_attn.cu
KEY_TILE = 64  # keys per step of its loop
BLOCKS_PER_SM = 2  # the blocks an SM holds at d <= 64 (registers and shared memory)
LOG2E = 1.4426950408889634


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("sam_attn.cu")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.tbist_sam_attn.argtypes = [p, p, p, p, p, p, p, p, p] + [i64] * 7 + [p]
    lib.tbist_sam_attn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tiles_per_split(t: int, splits: int) -> int:
    return _cdiv(_cdiv(t, KEY_TILE), splits)


def _whole_splits(t: int, splits: int) -> int:
    """The split count that covers the key tiles with none empty, at most
    ``splits``: the last split may be short, never empty."""
    return _cdiv(_cdiv(t, KEY_TILE), tiles_per_split(t, splits))


def kv_splits(n: int, t: int, sms: int) -> int:
    """Key splits for N heads of T tokens on ``sms`` SMs: 1 when the
    ``N·⌈T/64⌉`` blocks give each SM ``BLOCKS_PER_SM``, else enough splits
    (at most one per key tile) to reach that."""
    blocks = n * _cdiv(t, QUERY_TILE)
    want = min(_cdiv(t, KEY_TILE), _cdiv(BLOCKS_PER_SM * sms, blocks))
    return _whole_splits(t, max(1, want))


def split_bounds(t: int, splits: int) -> List[Tuple[int, int]]:
    """The key range [lo, hi) of each split, in split order."""
    per = tiles_per_split(t, splits) * KEY_TILE
    return [(s * per, min((s + 1) * per, t)) for s in range(_whole_splits(t, splits))]


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


def attention_partial_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_h: torch.Tensor, bias_w: torch.Tensor, h: int, w: int, lo: int, hi: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """What one key split of the kernel writes for keys [lo, hi): the
    unnormalised (N, T, d) O = Σ_j 2^(s_j - m) v_j, the row maximum m of the
    logits s in log2 units (N, T), and the row sum l = Σ_j 2^(s_j - m)."""
    n, t, _ = q.shape
    bias = (bias_h.reshape(n, t, h, 1) + bias_w.reshape(n, t, 1, w)).reshape(n, t, t)
    s = (torch.matmul(q, k[:, lo:hi].transpose(1, 2)) + bias[:, :, lo:hi]) * LOG2E
    m = s.amax(-1)
    p = torch.exp2(s - m[..., None])
    return torch.matmul(p, v[:, lo:hi]), m, p.sum(-1)


def combine_splits_plain(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The merge of ``sam_attn_combine_kernel``: (S, N, T, d) partial O and
    (S, N, T) m, l of S key splits -> (N, T, d), with the log-sum-exp
    rescale to the largest m."""
    scale = torch.exp2(m - m.amax(0))
    return (o * scale[..., None]).sum(0) / (l * scale).sum(0)[..., None]


def _check(q, k, v, bias_h, bias_w, h, w) -> None:
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
        if name in ("q", "k", "v") and x.data_ptr() % 16:
            raise ValueError(f"sam_attn {name}: data must be 16-byte aligned")
    if t != h * w:
        raise ValueError(f"sam_attn: T = {t} is not h·w = {h}·{w}")
    if d % 4 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"sam_attn: head dim {d} must be a multiple of 4 in (0, {MAX_HEAD_DIM}]")


def _launch(q, k, v, bias_h, bias_w, h: int, w: int, splits: Optional[int]) -> torch.Tensor:
    """The kernels on CUDA tensors, the keys split ``splits`` ways, or as
    ``kv_splits`` says where ``splits`` is None."""
    _check(q, k, v, bias_h, bias_w, h, w)
    n, t, d = q.shape
    if splits is None:
        splits = kv_splits(n, t, _sms(q.device.index))
    splits = _whole_splits(t, splits)
    out = torch.empty_like(q)
    scratch = [None] * 3  # partial O, m and l of each split
    if splits > 1:
        scratch = [torch.empty(shape, dtype=torch.float32, device=q.device)
                   for shape in ((splits, n, t, d), (splits, n, t), (splits, n, t))]
    with torch.cuda.device(q.device):
        err = _lib().tbist_sam_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h.data_ptr(), bias_w.data_ptr(),
            out.data_ptr(), *(None if x is None else x.data_ptr() for x in scratch),
            n, t, d, h, w, splits, tiles_per_split(t, splits),
            torch.cuda.current_stream().cuda_stream,
        )
    if err == 1:  # cudaErrorInvalidValue, from cudaFuncSetAttribute before any launch
        raise RuntimeError(f"sam_attn: CUDA error 1: a {h}x{w} grid at head dim {d} needs "
                           "more shared memory than a block can have; nothing was launched")
    if err:
        raise RuntimeError(f"sam_attn: kernel launch failed with CUDA error {err}")
    _build.count_launch(attention_with_rel_bias)
    return out


def attention_with_rel_bias(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias_h: torch.Tensor, bias_w: torch.Tensor, h: int, w: int,
) -> torch.Tensor:
    """q (pre-scaled), k, v: (N, T, d); bias_h: (N, T, h); bias_w: (N, T, w)
    with T = h·w in row-major (y, x) order. Returns the f32 (N, T, d)
    softmax(q kᵀ + bias) v, where bias[i, j] = bias_h[i, j // w] + bias_w[i, j % w]."""
    if q.device.type == "cpu":
        return attention_with_rel_bias_plain(q, k, v, bias_h, bias_w, h, w)
    return _launch(q, k, v, bias_h, bias_w, h, w, None)


attention_with_rel_bias.launches = 0
