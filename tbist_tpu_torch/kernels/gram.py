"""K1: the style Gram matrix and its VJP, on the hand-written CUDA kernels
of ``csrc/gram.cu``.

Replaces ``tbist_tpu/ops/pallas_gram.py`` (``_gram_fwd_pallas`` :59,
``_gram_bwd_pallas`` :87, the custom VJP ``gram_2d`` :106-121, the entry
``gram_matrix`` :134). Unlike the JAX package, which keeps the kernel
opt-in, the port always runs it: eager PyTorch has no graph fusion for a
custom kernel to fence.

A CUDA tensor goes to the kernel (or raises); a CPU tensor takes the plain
PyTorch version beside it. Each wrapper counts its launches in
``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from tbist_tpu_torch.kernels import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
SLAB_ROWS = 8  # BK of gram.cu: forward chunks are whole multiples of it
# gram.cu's two tile configurations, by index: output tile edge and the
# blocks per SM its registers allow (0: 128x128, 256 threads of 8x8;
# 1: 64x64, 128 threads of 8x4)
TILE_EDGE = (128, 64)
BLOCKS_PER_SM = (2, 4)


class FwdPlan(NamedTuple):
    """The forward's launch: tile configuration, tiles along C, upper tiles
    launched per (batch, chunk), and the split-K of the rows."""

    tile: int
    tiles: int
    upper: int
    chunks: int
    rows: int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.library("gram.cu")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.tbist_gram_fwd.argtypes = [p, p, p, i64, i64, i64, i64, i64, ctypes.c_float, i32, i32,
                                   i32, p]
    lib.tbist_gram_fwd.restype = i32
    lib.tbist_gram_bwd.argtypes = [p, p, p, i64, i64, i64, i32, i32, i32, p]
    lib.tbist_gram_bwd.restype = i32
    return lib


def _check_cuda(name: str, t: torch.Tensor, ndim: int, dtypes) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {sorted(map(str, dtypes))}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


@functools.lru_cache(maxsize=None)
def _sms(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def upper_tile(t: int, tiles: int) -> Tuple[int, int]:
    """(ti, tj), ti <= tj, of upper tile ``t``: row-major over the upper
    triangle of a tiles x tiles grid, as gram.cu derives it from blockIdx.x."""
    ti = 0
    while t >= tiles - ti:
        t -= tiles - ti
        ti += 1
    return ti, ti + t


def fwd_tile(c: int) -> int:
    """The forward's configuration: 64x64 tiles when C fits one of them."""
    return 0 if c > TILE_EDGE[1] else 1


def _upper_tiles(c: int) -> Tuple[int, int, int]:
    """(configuration, tiles along C, upper tiles) of the forward."""
    tile = fwd_tile(c)
    tiles = -(-c // TILE_EDGE[tile])
    return tile, tiles, tiles * (tiles + 1) // 2


def split_rows(b: int, n: int, c: int, target_blocks: int) -> Tuple[int, int]:
    """(chunks, rows_per_chunk) of the forward's split-K grid: enough
    chunks to put about ``target_blocks`` blocks in flight."""
    upper = _upper_tiles(c)[2]
    chunks = max(1, min(-(-n // SLAB_ROWS), -(-target_blocks // (upper * b))))
    rows = -(-n // chunks)
    rows = -(-rows // SLAB_ROWS) * SLAB_ROWS
    return -(-n // rows), rows


def fwd_plan(b: int, n: int, c: int, sms: int) -> FwdPlan:
    tile, tiles, upper = _upper_tiles(c)
    return FwdPlan(tile, tiles, upper, *split_rows(b, n, c, BLOCKS_PER_SM[tile] * sms))


def bwd_tile(b: int, n: int, c: int, sms: int) -> int:
    """The backward's configuration: 128x128 tiles when C is wider than 64
    and their grid gives every SM a block, else 64x64."""
    edge = TILE_EDGE[0]
    return 0 if c > TILE_EDGE[1] and b * -(-n // edge) * -(-c // edge) >= sms else 1


def vector_staging(c: int, width: int, *tensors: torch.Tensor) -> bool:
    """Whether gram.cu stages with 16-byte copies: ``width`` values of C a
    vector, and every base pointer 16-byte aligned. Else its scalar branch."""
    return c % width == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


def gram_fwd_plain(x: torch.Tensor, norm: float) -> torch.Tensor:
    """(B, N, C) -> (B, C, C) float32: XᵀX·norm, accumulated in f32."""
    xf = x.float()
    return torch.einsum("bnc,bnd->bcd", xf, xf) * norm


def gram_bwd_plain(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(B, N, C) x (B, C, C) f32 -> (B, N, C) in x's dtype: X·M in f32."""
    return torch.matmul(x.float(), m).to(x.dtype)


def gram_fwd(x: torch.Tensor, norm: float) -> torch.Tensor:
    """G = XᵀX·norm for (B, N, C) rows; float32 (B, C, C)."""
    if x.device.type == "cpu":
        return gram_fwd_plain(x, norm)
    _check_cuda("gram_fwd x", x, 3, _DTYPE_CODE)
    b, n, c = x.shape
    plan = fwd_plan(b, n, c, _sms(x.device.index))
    edge = TILE_EDGE[plan.tile]
    partial = torch.empty((b, plan.chunks, plan.upper, edge, edge), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    vector = vector_staging(c, 16 // x.element_size(), x)
    with torch.cuda.device(x.device):
        err = _lib().tbist_gram_fwd(
            x.data_ptr(), partial.data_ptr(), out.data_ptr(), b, n, c, plan.rows,
            plan.chunks, float(norm), _DTYPE_CODE[x.dtype], plan.tile, vector,
            torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gram_fwd: kernel launch failed with CUDA error {err}")
    _build.count_launch(gram_fwd)
    return out


gram_fwd.launches = 0


def gram_bwd(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """dX = X·M for (B, N, C) rows and a float32 (B, C, C) M; dX has x's dtype."""
    if x.device.type == "cpu":
        return gram_bwd_plain(x, m)
    _check_cuda("gram_bwd x", x, 3, _DTYPE_CODE)
    _check_cuda("gram_bwd m", m, 3, (torch.float32,))
    b, n, c = x.shape
    if m.shape != (b, c, c) or m.device != x.device:
        raise ValueError(f"gram_bwd: m {tuple(m.shape)} does not fit x {tuple(x.shape)}")
    dx = torch.empty_like(x)
    tile = bwd_tile(b, n, c, _sms(x.device.index))
    vector = vector_staging(c, 4, x, m, dx)
    with torch.cuda.device(x.device):
        err = _lib().tbist_gram_bwd(
            x.data_ptr(), m.data_ptr(), dx.data_ptr(), b, n, c,
            _DTYPE_CODE[x.dtype], tile, vector, torch.cuda.current_stream().cuda_stream,
        )
    if err:
        raise RuntimeError(f"gram_bwd: kernel launch failed with CUDA error {err}")
    _build.count_launch(gram_bwd)
    return dx


gram_bwd.launches = 0


class GramFunction(torch.autograd.Function):
    """(B, N, C) -> (B, C, C) f32 Gram scaled by ``norm``, with the analytic
    backward dX = X·(Ḡ + Ḡᵀ)·norm (``pallas_gram.py:114-118``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, norm: float) -> torch.Tensor:
        ctx.save_for_backward(x)
        ctx.norm = norm
        return gram_fwd(x, norm)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (x,) = ctx.saved_tensors
        m = ((g + g.transpose(1, 2)) * ctx.norm).float().contiguous()
        return gram_bwd(x, m), None


def gram_matrix(x: torch.Tensor) -> torch.Tensor:
    """Normalised Gram matrix of NHWC features -> float32 (B, C, C),
    divided by b·c·h·w as the reference does."""
    b, h, w, c = x.shape
    return GramFunction.apply(x.reshape(b, h * w, c), 1.0 / (b * c * h * w))
