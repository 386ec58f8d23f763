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
// have the same FLOPs on fewer bytes, so there the operations bound. The
// backward moves X in and dX out, 134 MB (40 us), for 2*N*C^2 = 2.15 GFLOP
// (32 us): bytes at conv1_1, operations from conv2_1 on.
//
// Design. Both directions are one SIMT SGEMM core on the CUDA cores: full
// f32 with sequential fmaf inside a thread, no tensor cores, no TF32 (the
// main path runs TF32 off, and wgmma has no full-f32 mode). A block owns a
// square BT x BT output tile; each thread owns a TM x TN register tile (8x8,
// or 8x4 in the small configuration), split into groups of 4 rows and 4
// columns at a stride of half the tile, so every fragment is one float4
// read from a [BK][BT] shared layout and a warp's reads are free of bank
// conflicts. That is 4 shared-memory reads per 64 FMAs (8x8), where a 4x4
// tile of scalar reads needs 8 per 16. Operands reach shared memory in slabs
// of BK = 8 along the reduction through a ring of 3 stages: slab k + 2 is
// in flight while slab k is multiplied.
//
// Two configurations: 128x128 tiles with 256 threads of 8x8 (Big), and 64x64
// tiles with 128 threads of 8x4 (Small), for C = 64 and for grids that
// would leave SMs idle at 128x128. kernels/gram.py picks one per call.
//
// Forward. The TPU kernel walks the rows in order and carries a (C, C) sum
// in VMEM across grid steps; GPU blocks run in parallel and in no order, so
// the rows are split into chunks (split-K) and each block sums one chunk for
// one output tile. Only tiles with ti <= tj are launched (the upper
// triangle), derived from blockIdx.x by arithmetic; on a diagonal tile both
// operands are the same slab, staged once, and the tile's lower-left
// quadrant, wholly below the diagonal, is not computed (a quarter of the
// products of the one tile at conv1_1 and conv2_1). Both operands are rows
// of X, contiguous along C, so a slab is BK runs of BT values: cp.async
// 16-byte copies (cp.async.cg, zero-filled past the ragged edge) with no
// transpose.
// bf16 is copied raw and widened to f32 at the fragment read. Each block
// writes its tile to a partial buffer that holds the upper tiles only; a
// second kernel sums the partials in chunk order, applies norm, and writes
// G[i, j] and G[j, i] (a diagonal tile's upper-right quadrant to both). No
// atomics, so results repeat bit for bit.
//
// Backward. dX = X M does not assume M symmetric. The M slab (BK rows x BT
// columns) is row-contiguous: cp.async into [BK][BT]. The X tile (BT rows x
// BK channels) is contiguous along channels and must be transposed into
// [BK][BT]: each thread loads one 4-channel vector a slab ahead into
// registers, and stores it transposed after the current slab's products
// (the register-staged buffer of the classic SGEMM). The other choice,
// cp.async into [BT][BK + pad], would leave scalar fragment reads along
// rows: twice the shared-memory instructions of the float4 reads the core
// is built on. A row stride of BT + 4 makes the transposed stores
// conflict-free. dX is written with float4 (f32) or 4 x bf16 stores.
//
// Edges. C not a multiple of the vector width (16 bytes of X in the
// forward, 4 values in the backward), or a base pointer not 16-byte
// aligned, takes a scalar staging branch of the same kernels (VEC = false):
// guarded element loads stored straight into the ring's stage.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 8;      // slab depth along the reduction
constexpr int STAGES = 3;  // cp.async ring depth

template <int BT_, int THREADS_, int TM_, int TN_, int LANE_COLS_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BT = BT_, THREADS = THREADS_, TM = TM_, TN = TN_;
  static constexpr int LANE_COLS = LANE_COLS_;    // thread columns a warp's lanes span
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // blocks per SM the registers must allow
  static constexpr int COLS = BT / TN;  // threads across a tile row
  static_assert(COLS % LANE_COLS == 0 && 32 % LANE_COLS == 0, "whole warps tile the threads");
  static_assert((BT / TM) * COLS == THREADS, "thread grid covers the tile");
  static_assert(TM % 4 == 0 && TN % 4 == 0, "fragments are float4");
  // the backward stages one 4-channel vector of X per thread per slab
  static_assert(THREADS * 4 == BT * BK, "one X vector per thread");
};
// Lanes: Big's warps span 2 x 16 threads and Small's 4 x 8, the faster of
// the two layouts for each on an H100 (PERF.md); in Small, 8 columns keep
// the diagonal tile's skip (gram_fwd_kernel) uniform within a warp.
using Big = Tile<128, 256, 8, 8, 16, 2>;
using Small = Tile<64, 128, 8, 4, 8, 4>;

// ---------------------------------------------------------------- cp.async

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- values

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.f); }

// four consecutive values from shared or global memory, widened to f32
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  f[0] = __bfloat162float(lo.x); f[1] = __bfloat162float(lo.y);
  f[2] = __bfloat162float(hi.x); f[3] = __bfloat162float(hi.y);
}
__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(f[0], f[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(f[2], f[3]);
  uint2 u;
  u.x = *reinterpret_cast<unsigned*>(&lo);
  u.y = *reinterpret_cast<unsigned*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ---------------------------------------------------------------- the core

// Tile coordinates of a thread's u-th row and v-th column: groups of 4 at a
// stride of half the tile (or one group when the tile is 4 wide).
template <class Cfg>
__device__ __forceinline__ int row_of(int ty, int u) {
  return (u / 4) * (Cfg::BT * 4 / Cfg::TM) + ty * 4 + u % 4;
}
template <class Cfg>
__device__ __forceinline__ int col_of(int tx, int v) {
  return (v / 4) * (Cfg::BT * 4 / Cfg::TN) + tx * 4 + v % 4;
}

// A thread's place (ty, tx) in the BT/TM x COLS thread grid: a warp's lanes
// cover 32/LANE_COLS thread rows x LANE_COLS thread columns.
template <class Cfg>
__device__ __forceinline__ void thread_pos(int& ty, int& tx) {
  constexpr int WCOLS = Cfg::COLS / Cfg::LANE_COLS;  // warps across the grid
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ty = (warp / WCOLS) * (32 / Cfg::LANE_COLS) + lane / Cfg::LANE_COLS;
  tx = (warp % WCOLS) * Cfg::LANE_COLS + lane % Cfg::LANE_COLS;
}

// acc[u][v] += sum over the slab's k of a[k][row u] * b[k][col v]. With
// SKIP, the 4 x 4 block of the thread's lower row group (rows in the tile's
// lower half) by its first column group is left out: the caller sets SKIP
// where those columns lie in the left half, so on a diagonal tile of G the
// block is wholly below the diagonal, and the reduce mirrors it from above.
template <class Cfg, bool SKIP, typename TA, typename TB>
__device__ __forceinline__ void mma_slab(const TA* a, int lda, const TB* b, int ldb, int ty,
                                         int tx, float (&acc)[Cfg::TM][Cfg::TN]) {
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float fa[Cfg::TM], fb[Cfg::TN];
#pragma unroll
    for (int u = 0; u < Cfg::TM; u += 4) load4(a + k * lda + row_of<Cfg>(ty, u), fa + u);
#pragma unroll
    for (int v = 0; v < Cfg::TN; v += 4) load4(b + k * ldb + col_of<Cfg>(tx, v), fb + v);
#pragma unroll
    for (int u = 0; u < Cfg::TM; ++u)
#pragma unroll
      for (int v = 0; v < Cfg::TN; ++v)
        if (!(SKIP && u >= 4 && v < 4)) acc[u][v] = fmaf(fa[u], fb[v], acc[u][v]);
  }
}

// The ring. issue(s, stage) starts slab s into a stage (cp.async copies, or
// global loads into registers); finish(stage) ends what issue left in
// registers; compute(stage) multiplies a stage. One barrier per slab: after
// it, the stage that slab s - 1 used is free for slab s + STAGES - 1.
template <class Issue, class Finish, class Compute>
__device__ __forceinline__ void run_ring(int slabs, Issue issue, Finish finish,
                                         Compute compute) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < slabs) issue(s, s);
    cp_async_commit();
    if (s < slabs) finish(s);
  }
  for (int s = 0; s < slabs; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = s + STAGES - 1;
    if (next < slabs) issue(next, next % STAGES);
    cp_async_commit();
    compute(s % STAGES);
    if (next < slabs) finish(next % STAGES);
  }
}

// (ti, tj), ti <= tj, of upper tile t in row-major order over the upper
// triangle of a tiles x tiles grid (kernels/gram.py:upper_tile mirrors it)
__device__ __forceinline__ void upper_tile(int t, int tiles, int& ti, int& tj) {
  ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  tj = ti + t;
}

// ---------------------------------------------------------------- forward

// BK rows of X from row r0 (rows >= r_end read as 0), columns col0.. col0+BT
// (columns >= c read as 0), into a [BK][BT] stage
template <class Cfg, bool VEC, typename T>
__device__ __forceinline__ void stage_rows(const T* __restrict__ xb, int c, int64_t r0,
                                           int64_t r_end, int col0, T* dst) {
  constexpr int BT = Cfg::BT;
  if (VEC) {
    constexpr int W = 16 / sizeof(T);  // values per 16-byte copy
    for (int e = threadIdx.x; e < BK * BT / W; e += Cfg::THREADS) {
      const int k = e / (BT / W), col = (e % (BT / W)) * W;
      const int64_t r = r0 + k;
      const bool in = r < r_end && col0 + col < c;
      cp_async16(dst + k * BT + col, in ? xb + r * c + col0 + col : xb, in ? 16 : 0);
    }
  } else {
    for (int e = threadIdx.x; e < BK * BT; e += Cfg::THREADS) {
      const int k = e / BT, col = e % BT;
      const int64_t r = r0 + k;
      dst[k * BT + col] = (r < r_end && col0 + col < c) ? xb[r * c + col0 + col] : zero<T>();
    }
  }
}

// partial[b, chunk, t] = the chunk's rows' contribution to upper tile t, a
// dense BT x BT block (rows and columns past C hold zeros)
template <class Cfg, typename T, bool VEC>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
gram_fwd_kernel(const T* __restrict__ x, float* __restrict__ partial, int64_t n, int c,
                int64_t rows_per_chunk, int tiles) {
  constexpr int BT = Cfg::BT;
  __shared__ __align__(16) T sa[STAGES][BK][BT];
  __shared__ __align__(16) T sb[STAGES][BK][BT];
  int ti, tj;
  upper_tile(blockIdx.x, tiles, ti, tj);
  const bool diag = ti == tj;
  const int64_t chunk = blockIdx.y, b = blockIdx.z;
  const int64_t r_begin = chunk * rows_per_chunk;
  const int64_t r_end = r_begin + rows_per_chunk < n ? r_begin + rows_per_chunk : n;
  const T* xb = x + b * n * c;
  int ty, tx;
  thread_pos<Cfg>(ty, tx);
  // on a diagonal tile, a thread whose first column group lies in the left
  // half skips its rows in the lower half there: the lower-left quadrant,
  // a quarter of the tile's products. Warp-uniform: always true in Big, and
  // a warp of Small spans 8 thread columns, 32 columns of one half.
  const bool skip = diag && col_of<Cfg>(tx, 3) < BT / 2;

  float acc[Cfg::TM][Cfg::TN];
#pragma unroll
  for (int u = 0; u < Cfg::TM; ++u)
#pragma unroll
    for (int v = 0; v < Cfg::TN; ++v) acc[u][v] = 0.f;

  run_ring(
      (int)((r_end - r_begin + BK - 1) / BK),
      [&](int s, int st) {
        const int64_t r0 = r_begin + (int64_t)s * BK;
        stage_rows<Cfg, VEC>(xb, c, r0, r_end, ti * BT, &sa[st][0][0]);
        if (!diag) stage_rows<Cfg, VEC>(xb, c, r0, r_end, tj * BT, &sb[st][0][0]);
      },
      [](int) {},
      [&](int st) {
        if (skip) {
          mma_slab<Cfg, true>(&sa[st][0][0], BT, &sa[st][0][0], BT, ty, tx, acc);
        } else {
          mma_slab<Cfg, false>(&sa[st][0][0], BT, diag ? &sa[st][0][0] : &sb[st][0][0], BT,
                               ty, tx, acc);
        }
      });

  float* pb = partial + ((b * gridDim.y + chunk) * gridDim.x + blockIdx.x) * (int64_t)BT * BT;
#pragma unroll
  for (int u = 0; u < Cfg::TM; ++u)
#pragma unroll
    for (int v = 0; v < Cfg::TN; v += 4)
      store4(pb + row_of<Cfg>(ty, u) * BT + col_of<Cfg>(tx, v), &acc[u][v]);
}

// out[b, i, j] = out[b, j, i] = norm * sum over chunks k, in order, of the
// partials of the upper tile holding (i, j); one thread per tile element.
// A diagonal tile's lower-left quadrant was not computed: the upper-right
// one is written to both places instead.
__global__ void gram_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                   int c, int tiles, int bt, int64_t upper, int chunks,
                                   float norm, int64_t total) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t tile_elems = (int64_t)bt * bt, per_chunk = upper * tile_elems;
  const int64_t b = e / per_chunk, rem = e % per_chunk;
  int ti, tj;
  upper_tile((int)(rem / tile_elems), tiles, ti, tj);
  const int qi = (int)(rem % tile_elems) / bt, qj = (int)(rem % tile_elems) % bt;
  const int i = ti * bt + qi, j = tj * bt + qj;
  const bool upper_right = qi < bt / 2 && qj >= bt / 2;
  if (i >= c || j >= c || (ti == tj && qi >= bt / 2 && qj < bt / 2)) return;
  const float* p = partial + b * chunks * per_chunk + rem;
  // Few elements each sum many chunks (4096 x 521 at conv1_1), so each
  // thread keeps AHEAD loads in flight; the sum stays in chunk order.
  constexpr int AHEAD = 32;
  float s = 0.f;
  for (int k = 0; k < chunks; k += AHEAD) {
    float v[AHEAD];
#pragma unroll
    for (int a = 0; a < AHEAD; ++a) v[a] = k + a < chunks ? p[(k + a) * per_chunk] : 0.f;
#pragma unroll
    for (int a = 0; a < AHEAD; ++a)
      if (k + a < chunks) s += v[a];
  }
  float* ob = out + b * c * (int64_t)c;
  ob[(int64_t)i * c + j] = s * norm;
  if (ti != tj || upper_right) ob[(int64_t)j * c + i] = s * norm;
}

// ---------------------------------------------------------------- backward

// dx[b, r, j] = sum over k of x[b, r, k] * m[b, k, j]
template <class Cfg, typename T, bool VEC>
__global__ void __launch_bounds__(Cfg::THREADS, Cfg::MIN_BLOCKS)
gram_bwd_kernel(const T* __restrict__ x, const float* __restrict__ m, T* __restrict__ dx,
                int64_t n, int c) {
  constexpr int BT = Cfg::BT, LDA = BT + 4;  // +4: conflict-free transposed stores
  __shared__ __align__(16) float sa[STAGES][BK][LDA];
  __shared__ __align__(16) float sb[STAGES][BK][BT];
  const int64_t r0 = (int64_t)blockIdx.x * BT;
  const int j0 = blockIdx.y * BT;
  const int64_t b = blockIdx.z;
  const T* xb = x + b * n * c;
  const float* mb = m + b * (int64_t)c * c;
  T* dxb = dx + b * n * c;
  const int tid = threadIdx.x;
  int ty, tx;
  thread_pos<Cfg>(ty, tx);
  // this thread's X vector in each slab: row xr, channels xk..xk+3
  const int xr = tid / (BK / 4), xk = (tid % (BK / 4)) * 4;
  float xv[4];

  float acc[Cfg::TM][Cfg::TN];
#pragma unroll
  for (int u = 0; u < Cfg::TM; ++u)
#pragma unroll
    for (int v = 0; v < Cfg::TN; ++v) acc[u][v] = 0.f;

  run_ring(
      (c + BK - 1) / BK,
      [&](int s, int st) {
        const int k0 = s * BK;
        if (VEC) {
          if (r0 + xr < n && k0 + xk < c) {
            load4(xb + (r0 + xr) * c + k0 + xk, xv);
          } else {
            xv[0] = xv[1] = xv[2] = xv[3] = 0.f;
          }
          for (int e = tid; e < BK * BT / 4; e += Cfg::THREADS) {
            const int k = e / (BT / 4), col = (e % (BT / 4)) * 4;
            const bool in = k0 + k < c && j0 + col < c;
            cp_async16(&sb[st][k][col], in ? mb + (int64_t)(k0 + k) * c + j0 + col : mb,
                       in ? 16 : 0);
          }
        } else {
          for (int e = tid; e < BT * BK; e += Cfg::THREADS) {
            const int r = e / BK, k = e % BK;
            sa[st][k][r] = (r0 + r < n && k0 + k < c) ? to_f(xb[(r0 + r) * c + k0 + k]) : 0.f;
          }
          for (int e = tid; e < BK * BT; e += Cfg::THREADS) {
            const int k = e / BT, col = e % BT;
            sb[st][k][col] =
                (k0 + k < c && j0 + col < c) ? mb[(int64_t)(k0 + k) * c + j0 + col] : 0.f;
          }
        }
      },
      [&](int st) {
        if (VEC) {
#pragma unroll
          for (int q = 0; q < 4; ++q) sa[st][xk + q][xr] = xv[q];
        }
      },
      [&](int st) {
        mma_slab<Cfg, false>(&sa[st][0][0], LDA, &sb[st][0][0], BT, ty, tx, acc);
      });

#pragma unroll
  for (int u = 0; u < Cfg::TM; ++u) {
    const int64_t r = r0 + row_of<Cfg>(ty, u);
    if (r >= n) continue;
#pragma unroll
    for (int v = 0; v < Cfg::TN; v += 4) {
      const int j = j0 + col_of<Cfg>(tx, v);
      if (VEC) {
        if (j < c) store4(dxb + r * c + j, &acc[u][v]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (j + q < c) store1(dxb + r * c + j + q, acc[u][v + q]);
      }
    }
  }
}

// ---------------------------------------------------------------- launches

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <class Cfg, typename T>
int gram_fwd(const void* x, void* partial, void* out, int64_t b, int64_t n, int64_t c,
             int64_t rows_per_chunk, int64_t chunks, float norm, bool vec, cudaStream_t stream) {
  if (vec && (c % (16 / sizeof(T)) != 0 || !aligned16(x))) return (int)cudaErrorMisalignedAddress;
  const int tiles = (int)((c + Cfg::BT - 1) / Cfg::BT);
  const int upper = tiles * (tiles + 1) / 2;
  dim3 grid((unsigned)upper, (unsigned)chunks, (unsigned)b);
  const T* xt = static_cast<const T*>(x);
  float* pt = static_cast<float*>(partial);
  if (vec) {
    gram_fwd_kernel<Cfg, T, true><<<grid, Cfg::THREADS, 0, stream>>>(xt, pt, n, (int)c,
                                                                     rows_per_chunk, tiles);
  } else {
    gram_fwd_kernel<Cfg, T, false><<<grid, Cfg::THREADS, 0, stream>>>(xt, pt, n, (int)c,
                                                                      rows_per_chunk, tiles);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int64_t total = b * upper * (int64_t)Cfg::BT * Cfg::BT;
  constexpr int RT = 32;  // reduce threads per block: one warp, to spread few elements wide
  gram_reduce_kernel<<<(unsigned)((total + RT - 1) / RT), RT, 0, stream>>>(
      pt, static_cast<float*>(out), (int)c, tiles, Cfg::BT, upper, (int)chunks, norm, total);
  return (int)cudaGetLastError();
}

template <class Cfg, typename T>
int gram_bwd(const void* x, const void* m, void* dx, int64_t b, int64_t n, int64_t c, bool vec,
             cudaStream_t stream) {
  if (vec && (c % 4 != 0 || !aligned16(x) || !aligned16(m) || !aligned16(dx)))
    return (int)cudaErrorMisalignedAddress;
  dim3 grid((unsigned)((n + Cfg::BT - 1) / Cfg::BT), (unsigned)((c + Cfg::BT - 1) / Cfg::BT),
            (unsigned)b);
  const T* xt = static_cast<const T*>(x);
  const float* mt = static_cast<const float*>(m);
  T* dxt = static_cast<T*>(dx);
  if (vec) {
    gram_bwd_kernel<Cfg, T, true><<<grid, Cfg::THREADS, 0, stream>>>(xt, mt, dxt, n, (int)c);
  } else {
    gram_bwd_kernel<Cfg, T, false><<<grid, Cfg::THREADS, 0, stream>>>(xt, mt, dxt, n, (int)c);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int fwd_tile(int tile, const void* x, void* partial, void* out, int64_t b, int64_t n, int64_t c,
             int64_t rows_per_chunk, int64_t chunks, float norm, bool vec, cudaStream_t s) {
  if (tile == 0) return gram_fwd<Big, T>(x, partial, out, b, n, c, rows_per_chunk, chunks, norm, vec, s);
  if (tile == 1) return gram_fwd<Small, T>(x, partial, out, b, n, c, rows_per_chunk, chunks, norm, vec, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int bwd_tile(int tile, const void* x, const void* m, void* dx, int64_t b, int64_t n, int64_t c,
             bool vec, cudaStream_t s) {
  if (tile == 0) return gram_bwd<Big, T>(x, m, dx, b, n, c, vec, s);
  if (tile == 1) return gram_bwd<Small, T>(x, m, dx, b, n, c, vec, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. tile: 0 = 128x128 (Big), 1 = 64x64
// (Small). vector: 1 takes the 16-byte staging, 0 the scalar branch.
// partial holds b * chunks * upper tiles of tile x tile floats. Each entry
// returns cudaGetLastError().
extern "C" int tbist_gram_fwd(const void* x, void* partial, void* out, int64_t b, int64_t n,
                              int64_t c, int64_t rows_per_chunk, int64_t chunks, float norm,
                              int dtype, int tile, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fwd_tile<float>(tile, x, partial, out, b, n, c, rows_per_chunk, chunks, norm, vector, s);
  if (dtype == 1)
    return fwd_tile<__nv_bfloat16>(tile, x, partial, out, b, n, c, rows_per_chunk, chunks, norm,
                                   vector, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int tbist_gram_bwd(const void* x, const void* m, void* dx, int64_t b, int64_t n,
                              int64_t c, int dtype, int tile, int vector, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return bwd_tile<float>(tile, x, m, dx, b, n, c, vector, s);
  if (dtype == 1) return bwd_tile<__nv_bfloat16>(tile, x, m, dx, b, n, c, vector, s);
  return (int)cudaErrorInvalidValue;
}
