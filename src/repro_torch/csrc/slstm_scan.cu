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
// in c, n, m, h (in place). Its saving launch (for the gradient, given cs,
// ns, ms) also stores the state c, n, m before every step, (B, S, w)
// float32 each, from the registers that hold it: three 128-byte stores a
// warp a step, off the h -> h chain; the launch without them compiles
// without the stores (a template flag), as it did before they existed.
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into FMAs), as the plain version's tensor operations round
// them; the transcendentals are CUDA's tanhf, expf and log1pf, and the
// divisions IEEE (no fast math).
//
// The exact-one gate: m' is one of log_f + m and pre_i, so with
// d = (log_f + m) - pre_i one gate is exactly 1 and the other exp(-|d|)
// (pre_i - (log_f + m) = -d exactly): i_g = 1 where d <= 0, f_g = 1 where
// d >= 0. One exp a step, bit for bit the two of the cell.
//
// Design: the channels are independent chains, so a thread takes one
// (b, channel) and walks its S steps with the state and r in registers; a
// warp (a block) takes 32 neighbouring channels. Each thread copies its
// channel's gates, CHUNK steps at a time, into its own slots of a
// two-stage shared-memory ring with asynchronous copies (cp.async, 8 or 16
// bytes a step, a chunk ahead: no register holds a gate in flight from
// device memory), reads a step's raw gates from there one step ahead and
// converts them where the step uses them, so no step waits for a load.
// A step's h is one 128-byte store for the warp.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): bytes, and far above
// that the dependency chain. At (B, S, w) = (1, 4096, 1024) with bfloat16
// gates, the gates read once and hs written once are 50.3 MB, 0.015 ms at
// 3.35 TB/s; the ~34 float32 operations of a channel's step are 0.14 G,
// 0.004 ms. But each step needs the previous step's h: S steps of the
// chain h -> pre -> exp/log1p -> log_f + m -> exp -> c', n' -> division ->
// h (chip_smoke.py, phase 28, states the chain's floor beside the bound).
// Only B x w = 1024 chains exist at B = 1: 32 warps for 528 schedulers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 32;  // a warp a block: the chains spread over SMs
constexpr int CHUNK = 32;    // steps of gates a stage of the ring
constexpr int STAGES = 2;

struct Gates {
  float z, i, f, o;
};

// a channel's 4 gates of one step as they lie in memory
template <typename T>
struct Raw;
template <>
struct Raw<float> {
  using type = float4;
  __device__ static Gates get(const float4& g) { return {g.x, g.y, g.z, g.w}; }
};
template <>
struct Raw<__nv_bfloat16> {
  using type = uint2;
  __device__ static Gates get(const uint2& raw) {
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    return {__low2float(a), __high2float(a), __low2float(b),
            __high2float(b)};
  }
};

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "n"(BYTES)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest has landed
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), as torch's logaddexp
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ float sigmoid(float x) {
  return __fdiv_rn(1.f, __fadd_rn(1.f, expf(-x)));
}

template <typename T, bool SAVE>
__global__ void __launch_bounds__(THREADS)
slstm_scan_kernel(const T* __restrict__ gates, const float* __restrict__ r,
                  float* __restrict__ c, float* __restrict__ n,
                  float* __restrict__ m, float* __restrict__ h,
                  float* __restrict__ hs, float* __restrict__ cs,
                  float* __restrict__ ns, float* __restrict__ ms, int B,
                  int S, int W) {
  using R = typename Raw<T>::type;
  __shared__ R ring[STAGES][CHUNK][THREADS];
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * W) return;  // no thread waits for another
  const int lane = threadIdx.x;
  const int b = (int)(idx / W), ch = (int)(idx % W);
  const float rz = r[4 * ch], ri = r[4 * ch + 1], rf = r[4 * ch + 2],
              ro = r[4 * ch + 3];
  float cc = c[idx], nn = n[idx], mm = m[idx], hh = h[idx];
  const T* g = gates + ((size_t)b * S * W + ch) * 4;
  const size_t row = (size_t)b * S * W + ch;  // step 0 of hs, cs, ns, ms
  float* out = hs + row;
  const size_t step = (size_t)W * 4;

  // this thread's gates of chunk `k` into stage k % STAGES (an empty group
  // past the end, so that the wait below always leaves the newest pending)
  auto issue = [&](int k) {
    const int t0 = k * CHUNK;
    const int steps = S - t0 < CHUNK ? S - t0 : CHUNK;
#pragma unroll 4
    for (int u = 0; u < steps; ++u)
      cp_async<sizeof(R)>(&ring[k % STAGES][u][lane],
                          g + (size_t)(t0 + u) * step);
    cp_async_commit();
  };
  issue(0);
  issue(1);
  for (int k = 0; k * CHUNK < S; ++k) {
    cp_async_wait_all_but_one();
    const int t0 = k * CHUNK;
    const int steps = S - t0 < CHUNK ? S - t0 : CHUNK;
    const R* slots = &ring[k % STAGES][0][lane];
    R nx = slots[0];  // step u + 1's gates are read while step u computes
#pragma unroll 4
    for (int u = 0; u < steps; ++u) {
      const Gates x = Raw<T>::get(nx);
      if (u + 1 < steps) nx = slots[(u + 1) * THREADS];
      if constexpr (SAVE) {
        const size_t at = row + (size_t)(t0 + u) * W;
        cs[at] = cc;
        ns[at] = nn;
        ms[at] = mm;
      }
      const float pz = __fadd_rn(x.z, __fmul_rn(hh, rz));
      const float pi = __fadd_rn(x.i, __fmul_rn(hh, ri));
      const float pf = __fadd_rn(x.f, __fmul_rn(hh, rf));
      const float po = __fadd_rn(x.o, __fmul_rn(hh, ro));
      const float z = tanhf(pz);
      const float o = sigmoid(po);
      const float log_f = -softplus(-pf);
      const float lfm = __fadd_rn(log_f, mm);
      const float d = __fsub_rn(lfm, pi);
      mm = fmaxf(lfm, pi);
      const float e = expf(-fabsf(d));
      const float i_g = d > 0.f ? e : 1.f;
      const float f_g = d > 0.f ? 1.f : e;
      cc = __fadd_rn(__fmul_rn(f_g, cc), __fmul_rn(i_g, z));
      nn = fmaxf(__fadd_rn(__fmul_rn(f_g, nn), i_g), 1e-6f);
      hh = __fmul_rn(o, __fdiv_rn(cc, nn));
      out[(size_t)(t0 + u) * W] = hh;
    }
    issue(k + STAGES);  // into the stage just read
  }
  c[idx] = cc;
  n[idx] = nn;
  m[idx] = mm;
  h[idx] = hh;
}

template <typename T>
int launch(const void* gates, const float* r, float* c, float* n, float* m,
           float* h, float* hs, float* cs, float* ns, float* ms, int B,
           int S, int W, cudaStream_t stream) {
  const long long blocks = ((long long)B * W + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const auto* g = static_cast<const T*>(gates);
  if (cs)
    slstm_scan_kernel<T, true><<<(unsigned)blocks, THREADS, 0, stream>>>(
        g, r, c, n, m, h, hs, cs, ns, ms, B, S, W);
  else
    slstm_scan_kernel<T, false><<<(unsigned)blocks, THREADS, 0, stream>>>(
        g, r, c, n, m, h, hs, cs, ns, ms, B, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// gates (B, S, w, 4) contiguous, float32 (is_bf16 = 0) or bfloat16, its
// base aligned to a channel's 4 gates; r (w, 4), c, n, m, h (B, w) and
// hs (B, S, w) contiguous float32; cs, ns, ms null (serving) or, for the
// saving launch, all three (B, S, w) contiguous float32.
extern "C" int slstm_scan_launch(const void* gates, const void* r, void* c,
                                 void* n, void* m, void* h, void* hs,
                                 void* cs, void* ns, void* ms, int B, int S,
                                 int W, int is_bf16, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const auto st = (cudaStream_t)stream;
  const auto* rf = static_cast<const float*>(r);
  auto* cf = static_cast<float*>(c);
  auto* nf = static_cast<float*>(n);
  auto* mf = static_cast<float*>(m);
  auto* hf = static_cast<float*>(h);
  auto* out = static_cast<float*>(hs);
  auto* sc = static_cast<float*>(cs);
  auto* sn = static_cast<float*>(ns);
  auto* sm = static_cast<float*>(ms);
  if (is_bf16)
    return launch<__nv_bfloat16>(gates, rf, cf, nf, mf, hf, out, sc, sn, sm,
                                 B, S, W, st);
  return launch<float>(gates, rf, cf, nf, mf, hf, out, sc, sn, sm, B, S, W,
                       st);
}
