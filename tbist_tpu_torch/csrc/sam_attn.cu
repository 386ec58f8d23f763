// K4: SAM global attention with the decomposed relative-position bias,
// hand-written for Hopper (sm_90a).
//
// Replaces tbist_tpu/ops/pallas_sam_attn.py: attention_with_rel_bias (:57,
// kernel _kernel :34, pl.pallas_call :80).
//
//   out[n, i, :] = softmax_j(q[n, i] . k[n, j] + bias[n, i, j]) v[n, j, :]
//   bias[n, i, j] = bias_h[n, i, j / w] + bias_w[n, i, j % w]
//
// q (pre-scaled), k, v, out: (N, T, d) f32 with T = h*w; bias_h (N, T, h),
// bias_w (N, T, w) f32. Inference only.
//
// What bounds it on an H100. The two products take 4*N*T^2*d operations;
// run on the tensor cores as 3xTF32 (below) they are three times that at
// the dense TF32 peak of 495 TFLOP/s. At the 1024^2 ViT-B encoder (N = 12
// heads, T = 4096, d = 64, h = w = 64) that is 154.6 GFLOP, 0.312 ms, and
// the 201 M exponentials take about 0.05 ms on the SFUs, while the inputs
// and output are 75.5 MB, 0.023 ms: operations bound it. (In f32 on the
// CUDA cores, 67 TFLOP/s, the same products would take 0.769 ms.) The
// T x T logits (805 MB per layer) never reach device memory.
//
// Precision: 3xTF32. Each f32 operand x is split as big = rna_tf32(x) and
// small = rna_tf32(x - big) (round to nearest, ties away, as
// cvt.rna.tf32.f32 does), and each product is formed as small*big +
// big*small + big*big by mma.sync with f32 accumulation. big holds 11
// significant bits and small the next 11, so a product misses only
// small*small and the two roundings, each below 2^-22 of |x*y|: about f32's
// own rounding, where single-pass TF32 (2^-11) would break the kernel's
// tolerance against the full-f32 plain version (rtol 1e-4). The bias, the
// softmax, the row sums and the output scaling stay in f32.
//
// Design: flash-attention-2 in shape, on mma.sync.m16n8k8 (TF32).
// - One block of 4 warps per (n, tile of 64 query rows, key split); each
//   warp owns 16 query rows and keeps its 16 x 64 logits tile and its
//   16 x d output accumulator in registers, in the MMA's C layout. Q's A
//   fragments are loaded once per block and held in registers, raw: split,
//   they would not fit beside the accumulators (255 registers a thread).
// - The MMAs add into their f32 accumulator with truncation, not
//   round-to-nearest, so no accumulator takes many MMAs: the logits'
//   big.big chain (d / 8 MMAs) has its own beside the small terms', summed
//   in f32, and each tile's P.V starts from zero and is added to the
//   running O in f32 (O = O alpha + P.V). With one accumulator over all the
//   keys, the error at the encoder's shape came near the tolerance.
// - K and V tiles of 64 keys arrive by 16-byte cp.async.cg in a 2-stage
//   ring: tile j + 1 loads while tile j is multiplied, one __syncthreads
//   per tile. Keys past T and columns past d are zero-filled by the copy's
//   src-size operand (d is padded to a multiple of 16: k-steps of 8 go in
//   pairs). Row-major [key][d] K is already the .col B operand of Q.K^T,
//   and V the B operand of P.V: nothing is transposed. The reduction over d
//   and P.V's output columns are permuted (Layout below) so that a thread
//   reads its B fragments as float4s, at row strides that keep the reads
//   free of bank conflicts. K and V fragments are split as they are read,
//   by each warp.
// - P needs no trip through shared memory: the C fragment of S holds keys
//   2t and 2t + 1 of each 8-key group, where the A fragment of P.V wants
//   k-columns t and t + 4. P.V permutes the keys inside each 8-key group
//   to match (k-column t is key 2t, t + 4 is key 2t + 1), reading V's rows
//   in the same order, so S's registers are P's A fragment as they stand.
// - The bias: the q tile's rows of bias_h and bias_w sit in shared memory
//   once per block (row strides h + 1 and w + 1: odd at SAM's even grids,
//   so the 8 rows of a fragment hit 8 banks). Each key tile's (key / w,
//   key % w) is tabulated with the tile's copies instead of a division per
//   element. The bias is added in f32 to the f32 logits, which are then
//   scaled by log2(e) for exp2f.
// - Online softmax in f32: row max by quad shuffles, the running sum kept
//   per thread (reduced over the quad once, at the end), the output
//   written once as O / l.
// - Key split. Where N * ceil(T / 64) blocks cannot fill the card, the
//   wrapper (kernels/sam_attn.py: kv_splits) splits the key tiles S ways:
//   each block writes its partial (O, m, l) to scratch and
//   sam_attn_combine_kernel merges the splits in split order with the
//   log-sum-exp rescale. No atomics: two calls are bitwise equal.
// exp2f, not __expf; no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;        // query rows per block, 16 per warp
constexpr int KT = 64;        // keys per tile
constexpr int THREADS = 128;  // 4 warps
constexpr float LOG2E = 1.4426950408889634f;

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- 3xTF32

// x as big + small, each rounded to TF32 to nearest, ties away from zero:
// cvt.rna.tf32.f32 for finite x, by adding half a TF32 ulp to the bits.
// The MMA reads only an operand's top 19 bits, so the low 13 bits need
// clearing only where big's value is used: in x - big.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) + 0x1000u;
  small = __float_as_uint(x - __uint_as_float(big & 0xffffe000u)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a.b in 3xTF32 for A split as (ab, as) and B = (b0, b1): the two small
// terms are added to cs, big.big to cb (cs and cb may be the same)
__device__ __forceinline__ void mma_3xtf32(float (&cb)[4], float (&cs)[4],
                                           const uint32_t (&ab)[4], const uint32_t (&as)[4],
                                           float b0, float b1) {
  uint32_t bb0, bs0, bb1, bs1;
  split_tf32(b0, bb0, bs0);
  split_tf32(b1, bb1, bs1);
  mma_tf32(cs, as, bb0, bb1);
  mma_tf32(cs, ab, bs0, bs1);
  mma_tf32(cb, ab, bb0, bb1);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int G>
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  if constexpr (G == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(p);
    f[0] = x.x; f[1] = x.y;
  }
}
template <int G>
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  if constexpr (G == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(f[0], f[1]);
  }
}

// ---------------------------------------------------------------- layout

// DK: k-steps of 8 along d, so d is padded to DP = 8 * DK columns (DK even).
//
// Q.K^T reduces over d in any order, so k-step 2p + i reads, for thread tq
// of a quad, the d columns 16p + 4tq + 2i (k-column tq) and 16p + 4tq + 2i + 1
// (k-column tq + 4): one float4 of K serves two k-steps, and Q's fragments
// are loaded in the same order.
//
// P.V's output columns are permuted too: n-column n of n-tile nd
// is d column 8G (nd / G) + G n + nd % G, G = min(DK, 4), so a thread's B
// fragments for G n-tiles are one vector of V's row, and its C fragments
// for them are vectors of O's row.
template <int DK>
struct Layout {
  static_assert(DK % 2 == 0, "k-steps come in pairs");
  static constexpr int DP = 8 * DK;
  static constexpr int G = DK < 4 ? DK : 4;
  // row strides (floats): 16 mod 32 for K's float4 reads by 2 rows x 4
  // threads, 4 mod 16 for V's vector reads by 4 row pairs x 2 threads
  static constexpr int LDK = DP % 32 == 0 ? DP + 16 : DP;
  static constexpr int LDV = DP + 4;
  static constexpr int KTILE = KT * LDK, VTILE = KT * LDV;
  static constexpr int MIN_BLOCKS = DK <= 8 ? 2 : 1;
};

// smem: K[2][KT][LDK], V[2][KT][LDV], key rows kh[2][KT], key columns
// kw[2][KT], bias_h rows [QT][h + 1], bias_w rows [QT][w + 1]
template <int DK>
size_t smem_bytes(int64_t h, int64_t w) {
  using L = Layout<DK>;
  return sizeof(float) * (2 * (L::KTILE + L::VTILE) + 4 * KT + QT * (h + 1) + QT * (w + 1));
}

// Starts the copies of key tile `tile` into one ring stage (ks, vs), and
// tabulates its keys' (row, column) in the grid into the stage's kh, kw.
template <int DK>
__device__ __forceinline__ void stage_tile(const float* __restrict__ kn,
                                           const float* __restrict__ vn, float* ks, float* vs,
                                           int* kh, int* kw, int tile, int t, int d, int w) {
  using L = Layout<DK>;
  constexpr int CPR = L::DP / 4;  // 16-byte chunks per padded row
  const int tid = threadIdx.x;
  const int k0 = tile * KT;
#pragma unroll
  for (int i = 0; i < KT * CPR / THREADS; ++i) {
    const int e = tid + THREADS * i;
    const int r = e / CPR, c = 4 * (e % CPR);
    const bool in = k0 + r < t && c < d;
    const int64_t off = in ? (int64_t)(k0 + r) * d + c : 0;
    cp_async16(ks + r * L::LDK + c, kn + off, in ? 16 : 0);
    cp_async16(vs + r * L::LDV + c, vn + off, in ? 16 : 0);
  }
  if (tid < KT) {
    const int key = k0 + tid;
    kh[tid] = key / w;
    kw[tid] = key - (key / w) * w;
  }
}

template <int DK>
__global__ void __launch_bounds__(THREADS, Layout<DK>::MIN_BLOCKS)
sam_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias_h,
                const float* __restrict__ bias_w, float* __restrict__ out,
                float* __restrict__ o_part, float* __restrict__ m_part,
                float* __restrict__ l_part, int t, int d, int h, int w, int tiles_per_split) {
  using L = Layout<DK>;
  constexpr int G = L::G;
  extern __shared__ float smem[];
  float* ks = smem;                                        // [2][KT][LDK]
  float* vs = ks + 2 * L::KTILE;                           // [2][KT][LDV]
  int* khs = reinterpret_cast<int*>(vs + 2 * L::VTILE);  // [2][KT]
  int* kws = khs + 2 * KT;                                 // [2][KT]
  const int hs = h + 1, ws = w + 1;
  float* bhs = reinterpret_cast<float*>(kws + 2 * KT);  // [QT][h + 1]
  float* bws = bhs + QT * hs;                            // [QT][w + 1]

  const int q0 = blockIdx.x * QT;
  const int64_t n = blockIdx.y;
  const int split = blockIdx.z, splits = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;  // the MMA fragments' (group, thread in group)
  const float* qn = q + n * t * d;
  const float* kn = k + n * t * d;
  const float* vn = v + n * t * d;
  const int rows = min(QT, t - q0);

  const int key_tiles = (t + KT - 1) / KT;
  const int j0 = split * tiles_per_split;
  const int j1 = min(j0 + tiles_per_split, key_tiles);
  stage_tile<DK>(kn, vn, ks, vs, khs, kws, j0, t, d, w);
  cp_async_commit();

  // the q tile's bias rows, zero past T
  const float* bhn = bias_h + (n * t + q0) * h;
  const float* bwn = bias_w + (n * t + q0) * w;
  for (int r = warp; r < QT; r += THREADS / 32) {
    for (int c = lane; c < h; c += 32) bhs[r * hs + c] = r < rows ? bhn[(int64_t)r * h + c] : 0.f;
    for (int c = lane; c < w; c += 32) bws[r * ws + c] = r < rows ? bwn[(int64_t)r * w + c] : 0.f;
  }

  // Q's A fragments, raw (split at use): rows r0 = 16 warp + g (i 0, 2) and
  // r1 = r0 + 8 (i 1, 3), k-columns tq (i 0, 1) and tq + 4 (i 2, 3) in the
  // permuted order above; zero past T and past d
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  float qf[DK][4];
#pragma unroll
  for (int kk = 0; kk < DK; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i % 2 ? r1 : r0, c = 16 * (kk / 2) + 4 * tq + 2 * (kk % 2) + i / 2;
      qf[kk][i] = r < rows && c < d ? qn[(int64_t)(q0 + r) * d + c] : 0.f;
    }
  }

  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float o[DK][4];
#pragma unroll
  for (int nd = 0; nd < DK; ++nd)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[nd][i] = 0.f;

  const float* bh0 = bhs + r0 * hs;
  const float* bh1 = bhs + r1 * hs;
  const float* bw0 = bws + r0 * ws;
  const float* bw1 = bws + r1 * ws;

  for (int j = j0; j < j1; ++j) {
    const int st = (j - j0) & 1;
    cp_async_wait_all();  // this thread's copies of tile j
    __syncthreads();      // everyone's copies; everyone is done with tile j - 1's stage
    if (j + 1 < j1)
      stage_tile<DK>(kn, vn, ks + (st ^ 1) * L::KTILE, vs + (st ^ 1) * L::VTILE,
                     khs + (st ^ 1) * KT, kws + (st ^ 1) * KT, j + 1, t, d, w);
    cp_async_commit();
    const float* kt_s = ks + st * L::KTILE;
    const float* vt_s = vs + st * L::VTILE;
    const int* kh = khs + st * KT;
    const int* kw = kws + st * KT;

    // S = Q.K^T: s[nn] holds keys 8 nn + 2 tq (+1) of rows r0 (i 0, 1), r1 (i 2, 3);
    // the big.big chain in s, the small terms in s_small
    float s[8][4], s_small[8][4];
#pragma unroll
    for (int nn = 0; nn < 8; ++nn)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nn][i] = s_small[nn][i] = 0.f;
#pragma unroll
    for (int kp = 0; kp < DK / 2; ++kp) {
      uint32_t ab[2][4], as[2][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        split_tf32(qf[2 * kp][i], ab[0][i], as[0][i]);
        split_tf32(qf[2 * kp + 1][i], ab[1][i], as[1][i]);
      }
#pragma unroll
      for (int nn = 0; nn < 8; ++nn) {
        float b[4];
        load_vec<4>(kt_s + (8 * nn + g) * L::LDK + 16 * kp + 4 * tq, b);
        mma_3xtf32(s[nn], s_small[nn], ab[0], as[0], b[0], b[1]);
        mma_3xtf32(s[nn], s_small[nn], ab[1], as[1], b[2], b[3]);
      }
    }

    // + bias, keys past T to -inf, to log2 units; the tile's row maxima
    const int k0 = j * KT;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kl = 8 * nn + 2 * tq + e;
        if (k0 + kl < t) {
          const int a = kh[kl], b = kw[kl];
          s[nn][e] = (s[nn][e] + s_small[nn][e] + (bh0[a] + bw0[b])) * LOG2E;
          s[nn][2 + e] = (s[nn][2 + e] + s_small[nn][2 + e] + (bh1[a] + bw1[b])) * LOG2E;
        } else {
          s[nn][e] = -INFINITY;
          s[nn][2 + e] = -INFINITY;
        }
        mx0 = fmaxf(mx0, s[nn][e]);
        mx1 = fmaxf(mx1, s[nn][2 + e]);
      }
    }
    // every key tile holds a key below T, so the new maxima are finite
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);  // 0 on the first tile
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int nn = 0; nn < 8; ++nn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nn][e] = exp2f(s[nn][e] - mn0);
        s[nn][2 + e] = exp2f(s[nn][2 + e] - mn1);
        sum0 += s[nn][e];
        sum1 += s[nn][2 + e];
      }
    }
    l0 = l0 * alpha0 + sum0;  // this thread's share of the row sum
    l1 = l1 * alpha1 + sum1;

    // O = O alpha + P.V, with k-column tq of key group jj standing for key
    // 2 tq and k-column tq + 4 for key 2 tq + 1: S's C fragment is P's A
    // fragment. The tile's P.V starts from zero.
    float o_tile[DK][4];
#pragma unroll
    for (int nd = 0; nd < DK; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i) o_tile[nd][i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      uint32_t pb[4], ps[4];
      split_tf32(s[jj][0], pb[0], ps[0]);
      split_tf32(s[jj][2], pb[1], ps[1]);
      split_tf32(s[jj][1], pb[2], ps[2]);
      split_tf32(s[jj][3], pb[3], ps[3]);
      const float* vp = vt_s + (8 * jj + 2 * tq) * L::LDV + G * g;
#pragma unroll
      for (int hg = 0; hg < DK / G; ++hg) {
        float b0[G], b1[G];
        load_vec<G>(vp + 8 * G * hg, b0);
        load_vec<G>(vp + L::LDV + 8 * G * hg, b1);
#pragma unroll
        for (int u = 0; u < G; ++u)
          mma_3xtf32(o_tile[G * hg + u], o_tile[G * hg + u], pb, ps, b0[u], b1[u]);
      }
    }
#pragma unroll
    for (int nd = 0; nd < DK; ++nd) {
      o[nd][0] = fmaf(o[nd][0], alpha0, o_tile[nd][0]);
      o[nd][1] = fmaf(o[nd][1], alpha0, o_tile[nd][1]);
      o[nd][2] = fmaf(o[nd][2], alpha1, o_tile[nd][2]);
      o[nd][3] = fmaf(o[nd][3], alpha1, o_tile[nd][3]);
    }
  }

  // rows r0 (C fragment entries 0, 1) and r1 (2, 3); entry e of n-tile
  // G hg + u is n-column 2 tq + e, d column 8G hg + G (2 tq + e) + u
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r >= rows) continue;
    const int64_t row = n * t + q0 + r;
    // the output, or with splits this split's partial O
    const int64_t prow = splits == 1 ? row : (int64_t)split * gridDim.y * t + row;
    float* on = (splits == 1 ? out : o_part) + prow * d;
#pragma unroll
    for (int hg = 0; hg < DK / G; ++hg) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * G * hg + G * (2 * tq + e);
        float x[G];
#pragma unroll
        for (int u = 0; u < G; ++u) {
          x[u] = o[G * hg + u][2 * half + e];
          if (splits == 1) x[u] /= half ? l1 : l0;
        }
        if (c < d) store_vec<G>(on + c, x);
      }
    }
    if (splits > 1 && tq == 0) {
      m_part[prow] = half ? m1 : m0;
      l_part[prow] = half ? l1 : l0;
    }
  }
}

// Merges the key splits of each row, in split order: with M the largest of
// the splits' maxima (log2 units), out = sum_s 2^(m_s - M) O_s / sum_s
// 2^(m_s - M) l_s. One thread per 4 output columns.
__global__ void __launch_bounds__(256)
sam_attn_combine_kernel(const float* __restrict__ o_part, const float* __restrict__ m_part,
                        const float* __restrict__ l_part, float* __restrict__ out, int splits,
                        int64_t rows, int d) {
  const int c4 = d / 4;
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * c4) return;
  const int64_t row = e / c4;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, m_part[s * rows + row]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < splits; ++s) {
    const float a = exp2f(m_part[s * rows + row] - m);
    l += a * l_part[s * rows + row];
    const float4 x = reinterpret_cast<const float4*>(o_part)[s * rows * c4 + e];
    acc.x += a * x.x;
    acc.y += a * x.y;
    acc.z += a * x.z;
    acc.w += a * x.w;
  }
  reinterpret_cast<float4*>(out)[e] = make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
}

template <int DK>
int launch(const float* q, const float* k, const float* v, const float* bh, const float* bw,
           float* out, float* o_part, float* m_part, float* l_part, int64_t n, int64_t t,
           int64_t d, int64_t h, int64_t w, int64_t splits, int64_t tiles_per_split,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes<DK>(h, w);
  cudaError_t err = cudaFuncSetAttribute(sam_attn_kernel<DK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) {  // a grid whose bias rows overflow a block's shared memory
    cudaGetLastError();  // clear it, so no later launch of the process reports it
    return (int)err;
  }
  dim3 grid((unsigned)((t + QT - 1) / QT), (unsigned)n, (unsigned)splits);
  sam_attn_kernel<DK><<<grid, THREADS, bytes, stream>>>(q, k, v, bh, bw, out, o_part, m_part,
                                                        l_part, (int)t, (int)d, (int)h, (int)w,
                                                        (int)tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int64_t vectors = n * t * (d / 4);
  sam_attn_combine_kernel<<<(unsigned)((vectors + 255) / 256), 256, 0, stream>>>(
      o_part, m_part, l_part, out, (int)splits, n * t, (int)d);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launches; requires d % 4 == 0,
// 0 < d <= 128, 16-byte aligned q, k, v and out, and with splits > 1
// scratch o_part (splits, N, T, d), m_part and l_part (splits, N, T), and
// every split holding at least one key tile.
extern "C" int tbist_sam_attn(const void* q, const void* k, const void* v, const void* bias_h,
                              const void* bias_w, void* out, void* o_part, void* m_part,
                              void* l_part, int64_t n, int64_t t, int64_t d, int64_t h, int64_t w,
                              int64_t splits, int64_t tiles_per_split, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bhf = static_cast<const float*>(bias_h);
  const float* bwf = static_cast<const float*>(bias_w);
  float* of = static_cast<float*>(out);
  float* op = static_cast<float*>(o_part);
  float* mp = static_cast<float*>(m_part);
  float* lp = static_cast<float*>(l_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto fn) {
    return fn(qf, kf, vf, bhf, bwf, of, op, mp, lp, n, t, d, h, w, splits, tiles_per_split, s);
  };
  if (d <= 16) return run(launch<2>);
  if (d <= 32) return run(launch<4>);
  if (d <= 64) return run(launch<8>);
  if (d <= 128) return run(launch<16>);
  return (int)cudaErrorInvalidValue;
}
