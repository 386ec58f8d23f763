// K2 and K3: backward of the 2x2/2 max pool with ties split evenly,
// hand-written for Hopper (sm_90a).
//
// Replaces tbist_tpu/ops/pallas_pool.py _bwd_pallas (:87, kernel _bwd_kernel
// :56; FUSE_RELU off) and tbist_tpu/ops/pallas_relu_pool.py _bwd_pallas (:75,
// kernel _bwd_kernel :46; FUSE_RELU on). For each 2x2 window of x (for K3,
// x = relu(pre), recomputed here) with pooled value out and incoming
// gradient g:
//
//   eq  = (x == out)            cnt = number of maxima in the window
//   gx  = eq * g / cnt          K3 also multiplies by (pre > 0): relu'(0) = 0
//
// which is the VJP JAX's reduce_max gives the reshape-max pool. Ties are
// common after a ReLU (windows of zeros), so the split matters.
//
// What bounds it on an H100: it reads x once and out and g (a quarter of x
// each) and writes gx once: 2.5 bytes of traffic per byte of x. At 512px
// pool1 is (1, 512, 512, 64) f32: 168 MB, 50 us at 3.35 TB/s; all four
// pools of a step move about 315 MB, 94 us. Bytes, not operations.
//
// Design. The TPU kernel pairs rows and columns with rolls because a stride-2
// access is lane-hostile there. Here one thread owns one (b, h2, w2, c)
// window, channel fastest, so a warp's four window loads and its out/g loads
// are each one coalesced run in NHWC. The window is counted in registers and
// each of the four gradients is written once. The quotient is computed in
// f32 and rounded once to the tensor's dtype; IEEE division, no fast math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float load_f(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p, int64_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_f(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, int64_t i, float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T, bool FUSE_RELU>
__global__ void pool_bwd_kernel(const T* __restrict__ x, const T* __restrict__ out,
                                const T* __restrict__ g, T* __restrict__ gx, int64_t total,
                                int64_t h2, int64_t w2, int64_t c) {
  const int64_t e = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int64_t ch = e % c;
  int64_t t = e / c;
  const int64_t col = t % w2;
  t /= w2;
  const int64_t row = t % h2;
  const int64_t b = t / h2;
  const int64_t w = 2 * w2;
  const int64_t base = ((b * 2 * h2 + 2 * row) * w + 2 * col) * c + ch;
  const int64_t idx[4] = {base, base + c, base + w * c, base + w * c + c};

  float pre[4], v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pre[k] = load_f(x, idx[k]);
    v[k] = FUSE_RELU ? fmaxf(pre[k], 0.f) : pre[k];
  }
  const float o = load_f(out, e);
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) cnt += (v[k] == o);
  const float share = load_f(g, e) / (float)(cnt > 1 ? cnt : 1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bool pass = v[k] == o;
    if (FUSE_RELU) pass = pass && pre[k] > 0.f;
    store_f(gx, idx[k], pass ? share : 0.f);
  }
}

template <typename T>
int pool_bwd(const void* x, const void* out, const void* g, void* gx, int64_t b, int64_t h,
             int64_t w, int64_t c, int fuse_relu, cudaStream_t stream) {
  const int64_t h2 = h / 2, w2 = w / 2;
  const int64_t total = b * h2 * w2 * c;
  const unsigned blocks = (unsigned)((total + 255) / 256);
  const T* xp = static_cast<const T*>(x);
  const T* op = static_cast<const T*>(out);
  const T* gp = static_cast<const T*>(g);
  T* gxp = static_cast<T*>(gx);
  if (fuse_relu)
    pool_bwd_kernel<T, true><<<blocks, 256, 0, stream>>>(xp, op, gp, gxp, total, h2, w2, c);
  else
    pool_bwd_kernel<T, false><<<blocks, 256, 0, stream>>>(xp, op, gp, gxp, total, h2, w2, c);
  return (int)cudaGetLastError();
}

}  // namespace

// x is (B, H, W, C) with H and W even (pre-activation for fuse_relu = 1);
// out and g are (B, H/2, W/2, C); gx is (B, H, W, C). All contiguous NHWC,
// one dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError().
extern "C" int tbist_pool_bwd(const void* x, const void* out, const void* g, void* gx,
                              int64_t b, int64_t h, int64_t w, int64_t c, int fuse_relu,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return pool_bwd<float>(x, out, g, gx, b, h, w, c, fuse_relu, s);
  if (dtype == 1) return pool_bwd<__nv_bfloat16>(x, out, g, gx, b, h, w, c, fuse_relu, s);
  return (int)cudaErrorInvalidValue;
}
