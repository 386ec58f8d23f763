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
// What bounds it on an H100 (f32 outside the tensor cores: 67 TFLOP/s,
// 3.35 TB/s). At the 1024^2 ViT-B encoder (N = 12 heads, T = 4096, d = 64,
// h = w = 64) the two products take 4*N*T^2*d = 51.5 GFLOP, 0.769 ms, while
// the inputs and output are 75.5 MB, 0.023 ms: operations bound it, by 33x.
// The T x T logits (805 MB per layer) never reach device memory.
//
// Design. Flash-style online softmax. One block of 256 threads per
// (n, tile of 64 query rows); a loop over tiles of 64 keys stages K
// (transposed) and V in shared memory, forms the 64 x 64 logits tile in
// registers (4 x 4 per thread), adds the bias, updates each row's running
// max and sum, rescales the 64 x d output accumulator held in registers and
// adds P.V with P staged through shared memory. The output is written once.
// The TPU kernel rebuilt the bias with two selector matmuls against 0/1
// matrices because the MXU likes matmuls; here the q tile's rows of bias_h
// and bias_w sit in shared memory once per block and are indexed directly.
// Keys past T (T % 64 != 0) get -inf. Full f32 on the CUDA cores (wgmma has
// no full-f32 mode and TF32 would change the reference's numbers), expf not
// __expf, no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QT = 64;        // query rows per block
constexpr int KT = 64;        // keys per step
constexpr int LD = 65;        // padded row of the transposed tiles and of P
constexpr int THREADS = 256;  // 16 x 16: rows ty + 16u, key columns tx + 16v

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// NV: output columns per thread, tx + 16v for v < NV, so d <= 16 * NV.
template <int NV>
__global__ void __launch_bounds__(THREADS)
sam_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ bias_h,
                const float* __restrict__ bias_w, float* __restrict__ out, int t, int d,
                int h, int w) {
  extern __shared__ float smem[];
  float* qs = smem;             // [d][LD]  the q tile, transposed
  float* ks = qs + d * LD;      // [d][LD]  the k tile, transposed
  float* vs = ks + d * LD;      // [KT][d]
  float* ps = vs + KT * d;      // [QT][LD] exp(logits - running max)
  float* bhs = ps + QT * LD;    // [QT][h]
  float* bws = bhs + QT * h;    // [QT][w]

  const int q0 = blockIdx.x * QT;
  const int64_t n = blockIdx.y;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* qn = q + n * t * d;
  const float* kn = k + n * t * d;
  const float* vn = v + n * t * d;
  const int rows = min(QT, t - q0);

  for (int e = tid; e < QT * d; e += THREADS) {
    const int r = e / d, c = e % d;
    qs[c * LD + r] = r < rows ? qn[(int64_t)(q0 + r) * d + c] : 0.f;
  }
  const float* bhn = bias_h + (n * t + q0) * h;
  for (int e = tid; e < QT * h; e += THREADS) bhs[e] = e < rows * h ? bhn[e] : 0.f;
  const float* bwn = bias_w + (n * t + q0) * w;
  for (int e = tid; e < QT * w; e += THREADS) bws[e] = e < rows * w ? bwn[e] : 0.f;

  float m[4], l[4], o[4][NV];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    m[u] = -INFINITY;
    l[u] = 0.f;
#pragma unroll
    for (int c = 0; c < NV; ++c) o[u][c] = 0.f;
  }

  for (int k0 = 0; k0 < t; k0 += KT) {
    __syncthreads();  // the previous step's reads of ks, vs, ps are done
    const int keys = min(KT, t - k0);
    for (int e = tid; e < KT * d; e += THREADS) {
      const int r = e / d, c = e % d;
      const bool in = r < keys;
      const int64_t g = (int64_t)(k0 + r) * d + c;
      ks[c * LD + r] = in ? kn[g] : 0.f;
      vs[e] = in ? vn[g] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[u][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < d; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = qs[c * LD + ty + 16 * u];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[u][j] = fmaf(a[u], b[j], s[u][j]);
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = k0 + tx + 16 * j;
      if (key < t) {
        const int kh = key / w, kw = key - kh * w;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = ty + 16 * u;
          s[u][j] += bhs[r * h + kh] + bws[r * w + kw];
        }
      } else {
#pragma unroll
        for (int u = 0; u < 4; ++u) s[u][j] = -INFINITY;
      }
    }

    // Every key tile holds at least one key below t, so the new max is finite.
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float tile_max = row_max16(fmaxf(fmaxf(s[u][0], s[u][1]), fmaxf(s[u][2], s[u][3])));
      const float m_new = fmaxf(m[u], tile_max);
      const float alpha = expf(m[u] - m_new);  // 0 on the first step
      m[u] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[u][j] - m_new);
        ps[(ty + 16 * u) * LD + tx + 16 * j] = p;
        sum += p;
      }
      l[u] = l[u] * alpha + row_sum16(sum);
#pragma unroll
      for (int c = 0; c < NV; ++c) o[u][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < KT; ++j) {
      float a[4], b[NV];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u] = ps[(ty + 16 * u) * LD + j];
#pragma unroll
      for (int c = 0; c < NV; ++c) {
        const int col = tx + 16 * c;
        b[c] = col < d ? vs[j * d + col] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int c = 0; c < NV; ++c) o[u][c] = fmaf(a[u], b[c], o[u][c]);
    }
  }

#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int r = ty + 16 * u;
    if (r >= rows) continue;
    float* on = out + (n * t + q0 + r) * d;
#pragma unroll
    for (int c = 0; c < NV; ++c) {
      const int col = tx + 16 * c;
      if (col < d) on[col] = o[u][c] / l[u];
    }
  }
}

size_t smem_bytes(int64_t d, int64_t h, int64_t w) {
  return sizeof(float) * (2 * d * LD + KT * d + QT * LD + QT * (h + w));
}

template <int NV>
int launch(const float* q, const float* k, const float* v, const float* bh, const float* bw,
           float* out, int64_t n, int64_t t, int64_t d, int64_t h, int64_t w,
           cudaStream_t stream) {
  const size_t bytes = smem_bytes(d, h, w);
  cudaError_t err = cudaFuncSetAttribute(sam_attn_kernel<NV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)((t + QT - 1) / QT), (unsigned)n);
  sam_attn_kernel<NV><<<grid, THREADS, bytes, stream>>>(q, k, v, bh, bw, out, (int)t, (int)d,
                                                         (int)h, (int)w);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch; requires 0 < d <= 128.
extern "C" int tbist_sam_attn(const void* q, const void* k, const void* v, const void* bias_h,
                              const void* bias_w, void* out, int64_t n, int64_t t, int64_t d,
                              int64_t h, int64_t w, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bhf = static_cast<const float*>(bias_h);
  const float* bwf = static_cast<const float*>(bias_w);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((d + 15) / 16) {
    case 1: return launch<1>(qf, kf, vf, bhf, bwf, of, n, t, d, h, w, s);
    case 2: return launch<2>(qf, kf, vf, bhf, bwf, of, n, t, d, h, w, s);
    case 3: return launch<3>(qf, kf, vf, bhf, bwf, of, n, t, d, h, w, s);
    case 4: return launch<4>(qf, kf, vf, bhf, bwf, of, n, t, d, h, w, s);
    case 5: return launch<5>(qf, kf, vf, bhf, bwf, of, n, t, d, h, w, s);
    case 6: return launch<6>(qf, kf, vf, bhf, bwf, of, n, t, d, h, w, s);
    case 7: return launch<7>(qf, kf, vf, bhf, bwf, of, n, t, d, h, w, s);
    case 8: return launch<8>(qf, kf, vf, bhf, bwf, of, n, t, d, h, w, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
