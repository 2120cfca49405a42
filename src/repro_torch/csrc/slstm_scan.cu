// The sLSTM scan of xLSTM's scalar-memory blocks, for Hopper (sm_90a).
//
// Replaces the reference's `lax.scan` over `_slstm_cell` in `slstm_sequence`
// (src/repro/models/recurrent.py:165, the scan at :169, the cell at :148;
// the JAX package has no Pallas kernel there), and the second scan its
// prefill runs only to get the final state (src/repro/models/transformer.py
// :356-363). For every batch row b and channel c of the gate
// pre-activations (B, S, w, 4) (float32 or bfloat16; gate j of channel c is
// column 4c + j: z, i, f, o) it runs the cell from the state c, n, m, h
// (B, w) float32 with the diagonal recurrent weights r (w, 4) float32:
//   pre = g + h r,  z = tanh(pre_z),  o = sigmoid(pre_o),
//   log_f = -softplus(-pre_f),  m' = max(log_f + m, pre_i),
//   i_g = exp(pre_i - m'),  f_g = exp((log_f + m) - m'),
//   c' = f_g c + i_g z,  n' = max(f_g n + i_g, 1e-6),  h' = o (c' / n'),
// writes every step's h' to hs (B, S, w) float32 and leaves the final state
// in c, n, m, h (in place). Every product and sum is rounded on its own
// (__fmul_rn, __fadd_rn: no contraction into FMAs), as the plain version's
// tensor operations round them; the transcendentals are CUDA's tanhf, expf
// and log1pf, and the divisions IEEE (no fast math).
//
// Design: the channels are independent chains, so a thread takes one
// (b, channel) and walks its S steps with the state and r in registers. A
// warp's 32 threads are 32 neighbouring channels: a step's gates are one
// contiguous 256-byte (bfloat16) or 512-byte (float32) load for the warp,
// and its h one 128-byte store. Each thread keeps the gates of the next
// AHEAD steps in flight in a ring of registers (a step's 4 gates are one
// 8- or 16-byte load).
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): bytes, and far above
// that the dependency chain. At (B, S, w) = (1, 4096, 1024) with bfloat16
// gates, the gates read once and hs written once are 50.3 MB, 0.015 ms at
// 3.35 TB/s; the ~34 float32 operations of a channel's step are 0.14 G,
// 0.004 ms. But each step needs the previous step's h: S steps of the
// chain h -> pre -> exp/log1p -> m' -> exp -> c', n' -> division -> h
// (chip_smoke.py, phase 28, states the chain's floor beside the bound).
// Only B x w = 1024 chains exist at B = 1: 32 warps for 528 schedulers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 32;  // a warp a block: the chains spread over SMs
constexpr int AHEAD = 8;     // steps of gates in flight a thread

struct Gates {
  float z, i, f, o;
};

__device__ __forceinline__ Gates load_gates(const float* p) {
  const float4 g = __ldg(reinterpret_cast<const float4*>(p));
  return {g.x, g.y, g.z, g.w};
}
__device__ __forceinline__ Gates load_gates(const __nv_bfloat16* p) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return {__low2float(a), __high2float(a), __low2float(b), __high2float(b)};
}

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), as torch's logaddexp
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
slstm_scan_kernel(const T* __restrict__ gates, const float* __restrict__ r,
                  float* __restrict__ c, float* __restrict__ n,
                  float* __restrict__ m, float* __restrict__ h,
                  float* __restrict__ hs, int B, int S, int W) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * W) return;
  const int b = (int)(idx / W), ch = (int)(idx % W);
  const float rz = r[4 * ch], ri = r[4 * ch + 1], rf = r[4 * ch + 2],
              ro = r[4 * ch + 3];
  float cc = c[idx], nn = n[idx], mm = m[idx], hh = h[idx];
  const T* g = gates + ((size_t)b * S * W + ch) * 4;
  float* out = hs + (size_t)b * S * W + ch;
  const size_t step = (size_t)W * 4;

  Gates ring[AHEAD];
#pragma unroll
  for (int u = 0; u < AHEAD; ++u)
    if (u < S) ring[u] = load_gates(g + u * step);
  for (int t0 = 0; t0 < S; t0 += AHEAD) {
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = t0 + u;
      if (t >= S) break;
      const Gates x = ring[u];
      if (t + AHEAD < S) ring[u] = load_gates(g + (t + AHEAD) * step);
      const float pz = __fadd_rn(x.z, __fmul_rn(hh, rz));
      const float pi = __fadd_rn(x.i, __fmul_rn(hh, ri));
      const float pf = __fadd_rn(x.f, __fmul_rn(hh, rf));
      const float po = __fadd_rn(x.o, __fmul_rn(hh, ro));
      const float z = tanhf(pz);
      const float o = sigmoid(po);
      const float log_f = -softplus(-pf);
      const float lfm = __fadd_rn(log_f, mm);
      mm = fmaxf(lfm, pi);
      const float i_g = expf(__fsub_rn(pi, mm));
      const float f_g = expf(__fsub_rn(lfm, mm));
      cc = __fadd_rn(__fmul_rn(f_g, cc), __fmul_rn(i_g, z));
      nn = fmaxf(__fadd_rn(__fmul_rn(f_g, nn), i_g), 1e-6f);
      hh = __fmul_rn(o, __fdiv_rn(cc, nn));
      out[(size_t)t * W] = hh;
    }
  }
  c[idx] = cc;
  n[idx] = nn;
  m[idx] = mm;
  h[idx] = hh;
}

template <typename T>
int launch(const void* gates, const float* r, float* c, float* n, float* m,
           float* h, float* hs, int B, int S, int W, cudaStream_t stream) {
  const long long blocks = ((long long)B * W + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  slstm_scan_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(gates), r, c, n, m, h, hs, B, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// gates (B, S, w, 4) contiguous, float32 (is_bf16 = 0) or bfloat16, its
// base aligned to a channel's 4 gates; r (w, 4), c, n, m, h (B, w) and
// hs (B, S, w) contiguous float32.
extern "C" int slstm_scan_launch(const void* gates, const void* r, void* c,
                                 void* n, void* m, void* h, void* hs, int B,
                                 int S, int W, int is_bf16, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const auto st = (cudaStream_t)stream;
  const auto* rf = static_cast<const float*>(r);
  auto* cf = static_cast<float*>(c);
  auto* nf = static_cast<float*>(n);
  auto* mf = static_cast<float*>(m);
  auto* hf = static_cast<float*>(h);
  auto* out = static_cast<float*>(hs);
  if (is_bf16)
    return launch<__nv_bfloat16>(gates, rf, cf, nf, mf, hf, out, B, S, W,
                                 st);
  return launch<float>(gates, rf, cf, nf, mf, hf, out, B, S, W, st);
}
