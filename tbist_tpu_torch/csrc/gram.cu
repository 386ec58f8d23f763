// K1: style Gram matrix and its backward, hand-written for Hopper (sm_90a).
//
// Replaces tbist_tpu/ops/pallas_gram.py: _gram_fwd_pallas (:59, kernel
// _gram_kernel :39) and _gram_bwd_pallas (:87, kernel _bwd_kernel :78),
// joined there by the custom VJP gram_2d (:106-121).
//
//   forward   G[b] = X[b]^T X[b] * norm      X[b] is (N, C) rows, G is f32 (C, C)
//   backward  dX[b] = X[b] M[b]              M = (Gbar + Gbar^T) * norm, formed
//                                            in torch as pallas_gram.py:116-118
//
// What bounds it on an H100 (f32 outside the tensor cores: 67 TFLOP/s,
// 3.35 TB/s): at 512px, conv1_1 has N = 262144, C = 64. G is symmetric, so
// the forward needs only the upper triangle and diagonal, N*C*(C+1) =
// 1.09 GFLOP (16 us), over 67 MB of X (20 us): bytes. conv2_1..conv4_1
// have the same FLOPs on fewer bytes, so there the operations bound. This
// kernel still computes every tile, twice the FLOPs the bound counts. The
// backward moves X in and dX out, 134 MB (40 us), for 2*N*C^2 = 2.15 GFLOP
// (32 us): bytes at conv1_1, operations from conv2_1 on.
//
// Design. The TPU kernel walks the rows sequentially and carries a (C, C)
// sum in VMEM from one grid step to the next. Blocks on the GPU run in
// parallel and in no order, so the forward is split-K: each block takes a
// chunk of rows and a 64x64 output tile, stages 32-row slabs of X through
// shared memory, and keeps a 4x4 piece of the tile per thread in registers.
// Each chunk writes its own partial tile; a second kernel sums the partials
// in chunk order and applies norm. No atomics, so results repeat from run
// to run. The backward is a tiled shared-memory GEMM over 64-row x 64-column
// output tiles with the channel dimension staged 32 at a time. Both read
// X in its own dtype (f32 or bf16) and accumulate in f32; dX is written in
// X's dtype. No wgmma or TMA yet: the f32 path runs on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 64;      // output tile edge
constexpr int BK = 32;        // reduction slab staged per step
constexpr int THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// partial[b, chunk, i, j] = sum over the chunk's rows r of x[b, r, i] * x[b, r, j]
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_partial_kernel(const T* __restrict__ x, float* __restrict__ partial, int64_t n,
                    int c, int64_t rows_per_chunk, int tiles) {
  __shared__ float as[BK][TILE];
  __shared__ float bs[BK][TILE];
  const int i0 = (blockIdx.x / tiles) * TILE;
  const int j0 = (blockIdx.x % tiles) * TILE;
  const int64_t chunk = blockIdx.y;
  const int64_t b = blockIdx.z;
  const int64_t r_begin = chunk * rows_per_chunk;
  const int64_t r_end = r_begin + rows_per_chunk < n ? r_begin + rows_per_chunk : n;
  const T* xb = x + b * n * c;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += BK) {
    for (int e = tid; e < BK * TILE; e += THREADS) {
      const int k = e / TILE, col = e % TILE;
      const int64_t r = r0 + k;
      const bool in_rows = r < r_end;
      as[k][col] = (in_rows && i0 + col < c) ? load_f(xb, r * c + i0 + col) : 0.f;
      bs[k][col] = (in_rows && j0 + col < c) ? load_f(xb, r * c + j0 + col) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = as[k][ty + 16 * u];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = bs[k][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

  float* pb = partial + (b * gridDim.y + chunk) * (int64_t)c * c;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int i = i0 + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (i < c && j < c) pb[(int64_t)i * c + j] = acc[u][v];
    }
  }
}

// out[b, i, j] = norm * sum over chunks k, in order, of partial[b, k, i, j]
__global__ void gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int64_t cc, int chunks, float norm, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t b = e / cc, ij = e % cc;
  const float* p = partial + b * chunks * cc + ij;
  float s = 0.f;
  for (int k = 0; k < chunks; ++k) s += p[k * cc];
  out[e] = s * norm;
}

// dx[b, r, j] = sum over k of x[b, r, k] * m[b, k, j]
template <typename T>
__global__ void __launch_bounds__(THREADS)
gram_bwd_kernel(const T* __restrict__ x, const float* __restrict__ m, T* __restrict__ dx,
                int64_t n, int c) {
  __shared__ float as[TILE][BK + 1];  // +1: the column read below is conflict-free
  __shared__ float bs[BK][TILE];
  const int64_t r0 = (int64_t)blockIdx.x * TILE;
  const int j0 = blockIdx.y * TILE;
  const int64_t b = blockIdx.z;
  const T* xb = x + b * n * c;
  const float* mb = m + b * (int64_t)c * c;
  T* dxb = dx + b * n * c;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  float acc[4][4];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[u][v] = 0.f;

  for (int k0 = 0; k0 < c; k0 += BK) {
    for (int e = tid; e < TILE * BK; e += THREADS) {
      const int r = e / BK, k = e % BK;
      as[r][k] = (r0 + r < n && k0 + k < c) ? load_f(xb, (r0 + r) * c + k0 + k) : 0.f;
    }
    for (int e = tid; e < BK * TILE; e += THREADS) {
      const int k = e / TILE, col = e % TILE;
      bs[k][col] = (k0 + k < c && j0 + col < c) ? mb[(int64_t)(k0 + k) * c + j0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = as[ty + 16 * u][k];
#pragma unroll
      for (int v = 0; v < 4; ++v) bv[v] = bs[k][tx + 16 * v];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(a[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t r = r0 + ty + 16 * u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int j = j0 + tx + 16 * v;
      if (r < n && j < c) store_f(dxb, r * c + j, acc[u][v]);
    }
  }
}

template <typename T>
int gram_fwd(const void* x, void* partial, void* out, int64_t b, int64_t n, int64_t c,
             int64_t rows_per_chunk, int64_t chunks, float norm, cudaStream_t stream) {
  const int tiles = (int)((c + TILE - 1) / TILE);
  dim3 grid(tiles * tiles, (unsigned)chunks, (unsigned)b);
  gram_partial_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), n, (int)c, rows_per_chunk, tiles);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = b * c * c;
  gram_reduce_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), c * c, (int)chunks, norm,
      total);
  return (int)cudaGetLastError();
}

template <typename T>
int gram_bwd(const void* x, const void* m, void* dx, int64_t b, int64_t n, int64_t c,
             cudaStream_t stream) {
  dim3 grid((unsigned)((n + TILE - 1) / TILE), (unsigned)((c + TILE - 1) / TILE), (unsigned)b);
  gram_bwd_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(m), static_cast<T*>(dx), n, (int)c);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Each entry returns cudaGetLastError().
extern "C" int tbist_gram_fwd(const void* x, void* partial, void* out, int64_t b, int64_t n,
                              int64_t c, int64_t rows_per_chunk, int64_t chunks, float norm,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gram_fwd<float>(x, partial, out, b, n, c, rows_per_chunk, chunks, norm, s);
  if (dtype == 1)
    return gram_fwd<__nv_bfloat16>(x, partial, out, b, n, c, rows_per_chunk, chunks, norm, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tbist_gram_bwd(const void* x, const void* m, void* dx, int64_t b, int64_t n,
                              int64_t c, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gram_bwd<float>(x, m, dx, b, n, c, s);
  if (dtype == 1) return gram_bwd<__nv_bfloat16>(x, m, dx, b, n, c, s);
  return (int)cudaErrorInvalidValue;
}
