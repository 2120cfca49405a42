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
// log1pf and IEEE division and sqrtf (no fast math: denormals are kept).
//
// Design: a chunked scan in one launch. A tile is CW channels x TS steps of
// one batch row; blocks take tiles in order from a counter, time tile
// major, so a tile's predecessor (the same channels, the previous TS steps)
// has always been taken by a running block. A tile
//   1. computes a_t and b_t of its CW x TS elements once, into shared
//      memory (x read once, coalesced: a warp reads 32 neighbouring
//      channels of one step);
//   2. scans SUBS sub-chunks of SUB steps a channel, a thread each, into
//      their aggregates: A = a_1 ... a_n and L, the sub-chunk's h from 0;
//   3. waits for its predecessor's flag, reads its carry h_in, and walks the
//      sub-chunks in order, h_in of the next = A h_in + L, publishing the
//      last as its own carry for its successor (a fence, then the flag);
//   4. re-runs each sub-chunk's recurrence from its h_in and writes h.
// Inside a sub-chunk h is the plain loop's recurrence; only the carry into
// a sub-chunk goes through the aggregate's product, so the kernel is held
// to the plain loop within 1e-5 of max|h|. The order of every combine is
// fixed by the tile, whichever block runs first: two launches are bitwise
// equal. A tile resets the flag it consumed and the last block to finish
// resets the counters, so every launch leaves the workspace zero (a CUDA
// graph can replay it).
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory by bytes, the
// special functions in practice. At (B, S, W) = (1, 4096, 4096) bf16, x
// read once and h written once are 67.1 MB, 20.0 us at 3.35 TB/s; the ~21
// float32 operations an element are 0.35 GFLOP, 5.3 us at 67 TFLOP/s; the
// 4 expf, sqrtf and 2 IEEE divisions an element take at least one MUFU
// operation each, 117 M at 16 an SM a clock, ~28 us, which is why each
// coefficient is computed once.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include "rglru_coeffs.cuh"

namespace {

using namespace rglru;

constexpr int CW = 32;               // channels a tile: a warp's lanes
constexpr int TS = 256;              // steps a tile
constexpr int SUBS = 8;              // sub-chunks a tile's channel
constexpr int SUB = TS / SUBS;       // steps a sub-chunk
constexpr int THREADS = CW * SUBS;   // a thread a (channel, sub-chunk)
constexpr int AHEAD = 8;             // x loads in flight a thread
static_assert(TS % (THREADS / CW) == 0 && (TS / SUBS) % AHEAD == 0,
              "tile shape");

// Workspace (int32, zero before the first launch and after every one):
// work[0] the next tile, work[1] tiles done, then a flag a tile.
template <typename T>
__global__ void __launch_bounds__(THREADS, 3)
rglru_scan_kernel(const T* __restrict__ x, const float* __restrict__ a_param,
                  const float* __restrict__ alpha_i,
                  const float* __restrict__ beta_i,
                  const float* __restrict__ alpha_r,
                  const float* __restrict__ beta_r, T* __restrict__ h,
                  int* __restrict__ work, float* __restrict__ carry, int B,
                  int S, int W, int n_tiles) {
  extern __shared__ float smem[];
  float* sa = smem;                  // a_t [TS][CW]
  float* sb = sa + TS * CW;          // b_t [TS][CW]
  float* agg_a = sb + TS * CW;       // [SUBS][CW]
  float* agg_l = agg_a + SUBS * CW;  // [SUBS][CW]
  float* h_in = agg_l + SUBS * CW;   // [SUBS][CW]
  __shared__ int tile_s;
  int* flags = work + 2;
  if (threadIdx.x == 0) tile_s = atomicAdd(work, 1);
  __syncthreads();
  const int tile = tile_s;
  const int n_ct = (W + CW - 1) / CW;
  const int row_tiles = B * n_ct;  // tiles of one time tile
  const int tt = tile / row_tiles, b = (tile % row_tiles) / n_ct;
  const int c0 = (tile % n_ct) * CW, t0 = tt * TS;
  const int steps = min(TS, S - t0);
  const int c = threadIdx.x % CW, sub = threadIdx.x / CW;
  const int ch = c0 + c;
  const bool on = ch < W;
  // 1. the coefficients, each once: thread (c, sub) takes steps sub,
  // sub + SUBS, ...
  {
    Coef p = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (on) p = coef_of(a_param, alpha_i, beta_i, alpha_r, beta_r, ch);
    const T* xc = x + ((size_t)b * S + t0) * W + ch;
    for (int k0 = 0; k0 < TS / SUBS; k0 += AHEAD) {
      float xv[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int t = sub + SUBS * (k0 + u);
        xv[u] = on && t < steps ? to_f(xc[(size_t)t * W]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int t = sub + SUBS * (k0 + u);
        if (t >= steps) break;
        float a_t = 1.f, b_t = 0.f;
        if (on) {
          const float xf = xv[u];
          const float i_t = sigmoid(__fadd_rn(__fmul_rn(xf, p.ai), p.bi));
          const float r_t = sigmoid(__fadd_rn(__fmul_rn(xf, p.ar), p.br));
          const float log_a = __fmul_rn(p.nc, r_t);
          a_t = expf(log_a);
          b_t = __fmul_rn(
              sqrtf(fmaxf(__fsub_rn(1.f, expf(__fmul_rn(2.f, log_a))),
                          1e-8f)),
              __fmul_rn(i_t, xf));
        }
        sa[t * CW + c] = a_t;
        sb[t * CW + c] = b_t;
      }
    }
  }
  __syncthreads();
  // 2. the sub-chunk's aggregate (A, L): h_end = A h_start + L
  const int s0 = sub * SUB, s1 = min(s0 + SUB, steps);
  {
    float A = 1.f, L = 0.f;
    for (int t = s0; t < s1; ++t) {
      const float a_t = sa[t * CW + c];
      L = __fadd_rn(__fmul_rn(a_t, L), sb[t * CW + c]);
      A = __fmul_rn(a_t, A);
    }
    agg_a[sub * CW + c] = A;
    agg_l[sub * CW + c] = L;
  }
  // 3. the carry from the predecessor, through the sub-chunks in order
  const int pred = tile - row_tiles;
  const bool has_succ = tt + 1 < (S + TS - 1) / TS;
  if (tt > 0 && threadIdx.x == 0) {
    while (load_acquire(flags + pred) == 0) __nanosleep(32);
  }
  __syncthreads();
  if (threadIdx.x < CW) {
    float hc = tt > 0 ? __ldcg(carry + (size_t)pred * CW + c) : 0.f;
#pragma unroll
    for (int k = 0; k < SUBS; ++k) {
      h_in[k * CW + c] = hc;
      hc = __fadd_rn(__fmul_rn(agg_a[k * CW + c], hc), agg_l[k * CW + c]);
    }
    if (has_succ) {
      __stcg(carry + (size_t)tile * CW + c, hc);
      __threadfence();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (has_succ) store_release(flags + tile, 1);
    if (tt > 0) flags[pred] = 0;  // consumed: zero for the next launch
  }
  // 4. h from each sub-chunk's carry
  {
    float hv = h_in[sub * CW + c];
    T* hc = h + ((size_t)b * S + t0) * W + ch;
    for (int t = s0; t < s1; ++t) {
      hv = __fadd_rn(__fmul_rn(sa[t * CW + c], hv), sb[t * CW + c]);
      if (on) store(hc + (size_t)t * W, hv);
    }
  }
  // the last block to finish zeroes the counters
  if (threadIdx.x == 0 && atomicAdd(work + 1, 1) == n_tiles - 1) {
    work[0] = 0;
    work[1] = 0;
  }
}

constexpr size_t SMEM = sizeof(float) * (2 * TS * CW + 3 * SUBS * CW);

template <typename T>
int launch(const void* x, const float* a_param, const float* alpha_i,
           const float* beta_i, const float* alpha_r, const float* beta_r,
           void* h, int* work, float* carry, int B, int S, int W,
           cudaStream_t stream) {
  const long long n_tiles =
      (long long)B * ((W + CW - 1) / CW) * ((S + TS - 1) / TS);
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  rglru_scan_kernel<T><<<(unsigned)n_tiles, THREADS, SMEM, stream>>>(
      static_cast<const T*>(x), a_param, alpha_i, beta_i, alpha_r, beta_r,
      static_cast<T*>(h), work, carry, B, S, W, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// x and h (B, S, W) contiguous, float32 (is_bf16 = 0) or bfloat16; the five
// parameters (W,) float32. Scratch from the wrapper, with tiles = B x
// ceil(W / 32) x ceil(S / 256) (kernels/rglru_scan.py SCAN_CHANNELS,
// SCAN_STEPS): work, int32, 2 + tiles entries, zero before the first launch
// (each launch leaves it zero); carry, float32, tiles x 32 entries.
extern "C" int rglru_scan_launch(const void* x, const void* a_param,
                                 const void* alpha_i, const void* beta_i,
                                 const void* alpha_r, const void* beta_r,
                                 void* h, void* work, void* carry, int B,
                                 int S, int W, int is_bf16, void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* p[5] = {static_cast<const float*>(a_param),
                       static_cast<const float*>(alpha_i),
                       static_cast<const float*>(beta_i),
                       static_cast<const float*>(alpha_r),
                       static_cast<const float*>(beta_r)};
  int* wk = static_cast<int*>(work);
  float* cy = static_cast<float*>(carry);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, p[0], p[1], p[2], p[3], p[4], h, wk, cy,
                                 B, S, W, st);
  return launch<float>(x, p[0], p[1], p[2], p[3], p[4], h, wk, cy, B, S, W,
                       st);
}

