// The RG-LRU scan of recurrentgemma's recurrent blocks, for Hopper (sm_90a).
//
// Replaces the reference's `lax.associative_scan` over the diagonal linear
// recurrence in `rglru_sequence` (src/repro/models/recurrent.py:64, the scan
// at :73; the JAX package has no Pallas kernel there). For every batch row
// b and channel c of x (B, S, W) (post-conv inputs, float32 or bfloat16)
// it fuses the coefficients of `_rglru_coeffs` (:54), in float32 with the
// reference's rounding points,
//   i_t = sigmoid(x alpha_i + beta_i),  r_t = sigmoid(x alpha_r + beta_r),
//   log_a = (-8 softplus(a_param)) r_t, softplus(a) = logaddexp(a, 0),
//   a_t = exp(log_a),  b_t = sqrt(max(1 - exp(2 log_a), 1e-8)) (i_t x),
// with the recurrence h_t = a_t h_{t-1} + b_t from h_0 = 0, carried in
// float32 and written in x's type. Products and sums are separately rounded
// (__fmul_rn, __fadd_rn: no contraction into FMAs), as the plain version's
// tensor operations round them; the transcendentals are CUDA's expf,
// log1pf and IEEE division and sqrtf.
//
// Design: one thread a (batch row, channel), sequential over S, a warp
// covering 32 neighbouring channels so every load and store of a step is
// coalesced; a block is one warp, so the B x W / 32 blocks spread over the
// SMs. The coefficients do not depend on h: x of the next CHUNK steps is
// loaded while the current chunk is computed, and only the a h + b chain is
// serial.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory. At (B, S, W) =
// (1, 4096, 4096) bf16, x read once and h written once are 67.1 MB, 20.0 us
// at 3.35 TB/s; the ~30 float32 operations an element are 0.5 GFLOP, 7.5 us
// at 67 TFLOP/s. B x W = 4096 threads are one warp on each of 128 SMs, so
// the kernel is latency-bound far above that bound; a chunked scan (chunk
// aggregates, a carry pass, a fix-up) is the later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;
constexpr int CHUNK = 16;  // steps whose x a thread loads together

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
rglru_scan_kernel(const T* __restrict__ x, const float* __restrict__ a_param,
                  const float* __restrict__ alpha_i,
                  const float* __restrict__ beta_i,
                  const float* __restrict__ alpha_r,
                  const float* __restrict__ beta_r, T* __restrict__ h, int S,
                  int W) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  if (c >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + c;
  const float ai = alpha_i[c], bi = beta_i[c], ar = alpha_r[c],
              br = beta_r[c], a = a_param[c];
  // softplus as logaddexp(a, 0): max(a, 0) + log1p(exp(-|a|))
  const float sp = __fadd_rn(fmaxf(a, 0.f), log1pf(expf(-fabsf(a))));
  const float neg_c_sp = __fmul_rn(-8.0f, sp);
  float hc = 0.f;
  float nxt[CHUNK];
#pragma unroll
  for (int u = 0; u < CHUNK; ++u)
    nxt[u] = u < S ? to_f(x[base + (size_t)u * W]) : 0.f;
  for (int t0 = 0; t0 < S; t0 += CHUNK) {
    float cur[CHUNK];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) cur[u] = nxt[u];
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int t = t0 + CHUNK + u;
      nxt[u] = t < S ? to_f(x[base + (size_t)t * W]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) {
      const int t = t0 + u;
      if (t >= S) break;
      const float xf = cur[u];
      const float i_t = sigmoid(__fadd_rn(__fmul_rn(xf, ai), bi));
      const float r_t = sigmoid(__fadd_rn(__fmul_rn(xf, ar), br));
      const float log_a = __fmul_rn(neg_c_sp, r_t);
      const float a_t = expf(log_a);
      const float b_t = __fmul_rn(
          sqrtf(fmaxf(__fsub_rn(1.f, expf(__fmul_rn(2.f, log_a))), 1e-8f)),
          __fmul_rn(i_t, xf));
      hc = __fadd_rn(__fmul_rn(a_t, hc), b_t);
      store(h + base + (size_t)t * W, hc);
    }
  }
}

template <typename T>
int launch(const void* x, const float* a_param, const float* alpha_i,
           const float* beta_i, const float* alpha_r, const float* beta_r,
           void* h, int B, int S, int W, cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), a_param, alpha_i, beta_i, alpha_r, beta_r,
      static_cast<T*>(h), S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// x and h (B, S, W) contiguous, float32 (is_bf16 = 0) or bfloat16; the five
// parameters (W,) float32. The wrapper checks and allocates h.
extern "C" int rglru_scan_launch(const void* x, const void* a_param,
                                 const void* alpha_i, const void* beta_i,
                                 const void* alpha_r, const void* beta_r,
                                 void* h, int B, int S, int W, int is_bf16,
                                 void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  if (B > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* p[5] = {static_cast<const float*>(a_param),
                       static_cast<const float*>(alpha_i),
                       static_cast<const float*>(beta_i),
                       static_cast<const float*>(alpha_r),
                       static_cast<const float*>(beta_r)};
  if (is_bf16)
    return launch<__nv_bfloat16>(x, p[0], p[1], p[2], p[3], p[4], h, B, S, W,
                                 st);
  return launch<float>(x, p[0], p[1], p[2], p[3], p[4], h, B, S, W, st);
}
