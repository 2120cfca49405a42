// The RG-LRU scan's backward, for Hopper (sm_90a).
//
// Replaces JAX's autodiff of the `lax.associative_scan` in `rglru_sequence`
// (src/repro/models/recurrent.py:64-80) through `_rglru_coeffs` (:54-61);
// the JAX package has no Pallas kernel there. It is the gradient of
// csrc/rglru_scan.cu: for x (B, S, W) (float32 or bfloat16), the five
// float32 (W,) parameters and dh (B, S, W) in x's type, the gradient of
// h_t = a_t h_{t-1} + b_t (h_0 = 0) is the reverse recurrence
//   g_t = dh_t + a_{t+1} g_{t+1},  da_t = g_t h_{t-1},  db_t = g_t,
// then the chain rule through the coefficients, element by element,
//   i = sigmoid(x alpha_i + beta_i), r = sigmoid(x alpha_r + beta_r),
//   nc = -8 softplus(a_param), log_a = nc r, a = exp(log_a),
//   e2 = exp(2 log_a), u = 1 - e2, s = sqrt(max(u, 1e-8)), b = s (i x):
//   ds = g (i x), dix = g s, du = [u >= 1e-8] ds / (2 s),
//   dlog_a = da a - 2 (du e2), dzi = dix x i (1 - i),
//   dzr = dlog_a nc r (1 - r), dx = dix i + dzi alpha_i + dzr alpha_r,
// with d alpha_i = sum dzi x, d beta_i = sum dzi, d alpha_r = sum dzr x,
// d beta_r = sum dzr and d a_param = (sum dlog_a r) (-8) sigmoid(a_param),
// the sums over B and S. The clamp's gradient goes wholly to u at a tie
// (torch.clamp's convention; jnp.maximum halves it there): a tie cannot
// arise, since u = 1 - e2 with e2 in [0, 1] is 0 or at least 2^-24, never
// float32(1e-8). softplus's derivative is the sigmoid, with no threshold.
// Every product and sum is separately rounded (__fmul_rn, __fadd_rn: no
// contraction into FMAs) in the order kernels/rglru_scan.py's
// rglru_scan_backward_plain takes them; the transcendentals are CUDA's
// expf, log1pf, IEEE division and sqrtf (no fast math).
//
// Design: the forward's chunked scan run in reverse, in one launch. A tile
// is CW channels x TS steps of one batch row; blocks take tiles from a
// counter with the last time tile first, so a tile's successor (the same
// channels, the next TS steps) has always been taken by a running block.
// A tile
//   1. recomputes a_t and b_t from x into shared memory exactly as the
//      forward does, and stages dh there (x and dh read once, coalesced);
//   2. scans its SUBS sub-chunks of SUB steps, a thread each, into their
//      forward aggregates (A, L: h_end = A h_start + L, as the forward) and
//      their backward ones (A' = the same a_t multiplied from the last
//      step down, L' = a_first g_first from a zero carry: c_out = A' c_in
//      + L', where c = a_t g_t is what step t hands to step t - 1);
//   3. takes h entering each sub-chunk from the forward's saved carry of
//      its predecessor tile through the forward aggregates, so its float32
//      h is the forward's bit for bit (the returned h is rounded to x's
//      type, and da = g h_{t-1} needs the float32 value); waits for its
//      successor's flag, reads its g carry and walks the sub-chunks down,
//      publishing the carry out of its first sub-chunk for its predecessor
//      (a fence, then the flag);
//   4. re-runs each sub-chunk's h from its carry (over b_t in shared
//      memory) and then its g from its carry, from the top down (over dh);
//   5. applies the chain rule element by element, a thread on every
//      SUBS-th step as in 1 (x read again, its loads in flight together):
//      dx in x's type, accumulated in float32 and rounded once, and each
//      thread's five parameter sums in step order;
//   6. adds its threads' sums in order into float32 partial sums a tile
//      (tiles x 5 x CW, in a workspace); the last tile of a channel group
//      to finish (an arrival counter) sums the group's partials over the
//      tiles in tile order, so the result depends on no block's timing:
//      no atomics on the sums, two launches bitwise equal.
// A tile resets the flag it consumed, a group's last tile its counter and
// the last block the tile counters, so every launch leaves the workspace
// zero (a CUDA graph can replay it).
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory by bytes, the
// special functions in practice. At (B, S, W) = (1, 4096, 4096) bf16, x and
// dh read once and dx written once are 100.7 MB, 30.0 us at 3.35 TB/s.
// Recomputing the coefficients costs the forward's 4 expf, sqrtf and 2
// divisions an element twice (steps 1 and 5) plus one division, at least
// 15 MUFU operations an element, 252 M at 16 an SM a clock, ~60 us; the ~55
// float32 operations an element are 0.92 GFLOP, 14 us at 67 TFLOP/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CW = 32;               // channels a tile: a warp's lanes
constexpr int TS = 256;              // steps a tile
constexpr int SUBS = 8;              // sub-chunks a tile's channel
constexpr int SUB = TS / SUBS;       // steps a sub-chunk
constexpr int THREADS = CW * SUBS;   // a thread a (channel, sub-chunk)
constexpr int AHEAD = 8;             // x and dh loads in flight a thread
constexpr int NP = 5;                // parameter sums: alpha_i, beta_i,
                                     // alpha_r, beta_r, nc
static_assert((TS / SUBS) % AHEAD == 0 && NP * CW <= THREADS, "tile shape");

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

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.b32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.b32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// a channel's parameters: the gates' and -8 softplus(a_param)
struct Coef {
  float ai, bi, ar, br, nc;
};

__device__ __forceinline__ Coef coef_of(const float* a_param,
                                        const float* alpha_i,
                                        const float* beta_i,
                                        const float* alpha_r,
                                        const float* beta_r, int ch) {
  Coef p;
  p.ai = alpha_i[ch];
  p.bi = beta_i[ch];
  p.ar = alpha_r[ch];
  p.br = beta_r[ch];
  const float a = a_param[ch];
  // softplus as logaddexp(a, 0): max(a, 0) + log1p(exp(-|a|))
  const float sp = __fadd_rn(fmaxf(a, 0.f), log1pf(expf(-fabsf(a))));
  p.nc = __fmul_rn(-8.0f, sp);
  return p;
}

// Workspace (int32, zero before the first launch and after every one):
// work[0] the next tile, work[1] tiles done, then a flag a tile, then an
// arrival counter a channel group.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
rglru_scan_bwd_kernel(const T* __restrict__ x,
                      const float* __restrict__ a_param,
                      const float* __restrict__ alpha_i,
                      const float* __restrict__ beta_i,
                      const float* __restrict__ alpha_r,
                      const float* __restrict__ beta_r,
                      const T* __restrict__ dh,
                      const float* __restrict__ hcarry, T* __restrict__ dx,
                      float* __restrict__ grads, int* __restrict__ work,
                      float* __restrict__ gcarry,
                      float* __restrict__ partial, int B, int S, int W,
                      int n_tiles) {
  extern __shared__ float smem[];
  float* sa = smem;                   // a_t [TS][CW]
  float* sh = sa + TS * CW;           // b_t, then h_t [TS][CW]
  float* sg = sh + TS * CW;           // dh_t [TS][CW]
  float* agg_a = sg + TS * CW;        // forward aggregates [SUBS][CW]
  float* agg_l = agg_a + SUBS * CW;
  float* bag_a = agg_l + SUBS * CW;   // backward aggregates [SUBS][CW]
  float* bag_l = bag_a + SUBS * CW;
  float* h_in = bag_l + SUBS * CW;    // h entering a sub-chunk [SUBS][CW]
  float* c_in = h_in + SUBS * CW;     // c entering a sub-chunk from above
  float* psum = c_in + SUBS * CW;     // [SUBS][NP][CW]
  __shared__ int tile_s, last_s;
  int* flags = work + 2;
  const int n_ct = (W + CW - 1) / CW;
  const int n_tt = (S + TS - 1) / TS;
  const int row_tiles = B * n_ct;     // tiles of one time tile
  int* group_done = flags + n_tiles;
  if (threadIdx.x == 0) tile_s = atomicAdd(work, 1);
  __syncthreads();
  const int taken = tile_s;
  const int tt = n_tt - 1 - taken / row_tiles;
  const int rt = taken % row_tiles;
  const int b = rt / n_ct, ct = rt % n_ct;
  const int tile = tt * row_tiles + rt;  // the forward's numbering
  const int c0 = ct * CW, t0 = tt * TS;
  const int steps = min(TS, S - t0);
  const int c = threadIdx.x % CW, sub = threadIdx.x / CW;
  const int ch = c0 + c;
  const bool on = ch < W;
  Coef p = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (on) p = coef_of(a_param, alpha_i, beta_i, alpha_r, beta_r, ch);
  const size_t base = ((size_t)b * S + t0) * W + ch;
  // 1. a_t and b_t as the forward computes them, and dh; thread (c, sub)
  // takes steps sub, sub + SUBS, ...
  for (int k0 = 0; k0 < TS / SUBS; k0 += AHEAD) {
    float xv[AHEAD], dv[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = sub + SUBS * (k0 + u);
      const bool in = on && t < steps;
      xv[u] = in ? to_f(x[base + (size_t)t * W]) : 0.f;
      dv[u] = in ? to_f(dh[base + (size_t)t * W]) : 0.f;
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
      sh[t * CW + c] = b_t;
      sg[t * CW + c] = dv[u];
    }
  }
  __syncthreads();
  // 2. the sub-chunk's aggregates, forward and backward
  const int s0 = sub * SUB, s1 = min(s0 + SUB, steps);
  {
    float A = 1.f, L = 0.f;
    for (int t = s0; t < s1; ++t) {
      const float a_t = sa[t * CW + c];
      L = __fadd_rn(__fmul_rn(a_t, L), sh[t * CW + c]);
      A = __fmul_rn(a_t, A);
    }
    agg_a[sub * CW + c] = A;
    agg_l[sub * CW + c] = L;
    A = 1.f;
    float cc = 0.f;
    for (int t = s1 - 1; t >= s0; --t) {
      const float a_t = sa[t * CW + c];
      cc = __fmul_rn(a_t, __fadd_rn(sg[t * CW + c], cc));
      A = __fmul_rn(a_t, A);
    }
    bag_a[sub * CW + c] = A;
    bag_l[sub * CW + c] = cc;
  }
  __syncthreads();
  // 3. h into each sub-chunk from the forward's carry (written by the
  // forward launch, which has ended), then the g carry from the successor
  const int pred = tile - row_tiles, succ = tile + row_tiles;
  const bool has_succ = tt + 1 < n_tt;
  if (threadIdx.x < CW) {
    float hc = tt > 0 ? hcarry[(size_t)pred * CW + c] : 0.f;
#pragma unroll
    for (int k = 0; k < SUBS; ++k) {
      h_in[k * CW + c] = hc;
      hc = __fadd_rn(__fmul_rn(agg_a[k * CW + c], hc), agg_l[k * CW + c]);
    }
  }
  if (has_succ && threadIdx.x == 0) {
    while (load_acquire(flags + succ) == 0) __nanosleep(32);
  }
  __syncthreads();
  if (threadIdx.x < CW) {
    float cc = has_succ ? __ldcg(gcarry + (size_t)succ * CW + c) : 0.f;
#pragma unroll
    for (int k = SUBS - 1; k >= 0; --k) {
      c_in[k * CW + c] = cc;
      cc = __fadd_rn(__fmul_rn(bag_a[k * CW + c], cc), bag_l[k * CW + c]);
    }
    if (tt > 0) {
      __stcg(gcarry + (size_t)tile * CW + c, cc);
      __threadfence();
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (tt > 0) store_release(flags + tile, 1);
    if (has_succ) flags[succ] = 0;  // consumed: zero for the next launch
  }
  // 4. h from the sub-chunk's carry (over b_t), then g from its carry
  // from the top down (over dh)
  {
    float hv = h_in[sub * CW + c];
    for (int t = s0; t < s1; ++t) {
      hv = __fadd_rn(__fmul_rn(sa[t * CW + c], hv), sh[t * CW + c]);
      sh[t * CW + c] = hv;
    }
    float cc = c_in[sub * CW + c];
    for (int t = s1 - 1; t >= s0; --t) {
      const float g = __fadd_rn(sg[t * CW + c], cc);
      sg[t * CW + c] = g;
      cc = __fmul_rn(sa[t * CW + c], g);
    }
  }
  __syncthreads();
  // 5. the chain rule, element by element, thread (c, sub) on steps sub,
  // sub + SUBS, ... (x read again, AHEAD loads in flight), its five
  // parameter sums in step order
  float acc[NP] = {0.f, 0.f, 0.f, 0.f, 0.f};
  const float h_first = h_in[c];  // h entering the tile
  for (int k0 = 0; k0 < TS / SUBS; k0 += AHEAD) {
    float xv[AHEAD];
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = sub + SUBS * (k0 + u);
      xv[u] = on && t < steps ? to_f(x[base + (size_t)t * W]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < AHEAD; ++u) {
      const int t = sub + SUBS * (k0 + u);
      if (!on || t >= steps) break;
      const float xf = xv[u];
      const float g = sg[t * CW + c];
      const float a_t = sa[t * CW + c];
      const float hp = t > 0 ? sh[(t - 1) * CW + c] : h_first;
      const float i_t = sigmoid(__fadd_rn(__fmul_rn(xf, p.ai), p.bi));
      const float r_t = sigmoid(__fadd_rn(__fmul_rn(xf, p.ar), p.br));
      const float log_a = __fmul_rn(p.nc, r_t);
      const float e2 = expf(__fmul_rn(2.f, log_a));
      const float u2 = __fsub_rn(1.f, e2);
      const float s = sqrtf(fmaxf(u2, 1e-8f));
      const float ix = __fmul_rn(i_t, xf);
      const float da = __fmul_rn(g, hp);
      const float ds = __fmul_rn(g, ix);
      const float dix = __fmul_rn(g, s);
      const float du = u2 >= 1e-8f ? __fdiv_rn(ds, __fmul_rn(2.f, s)) : 0.f;
      const float dlog_a = __fsub_rn(__fmul_rn(da, a_t),
                                     __fmul_rn(2.f, __fmul_rn(du, e2)));
      const float di = __fmul_rn(dix, xf);
      const float dr = __fmul_rn(dlog_a, p.nc);
      const float dzi =
          __fmul_rn(di, __fmul_rn(i_t, __fsub_rn(1.f, i_t)));
      const float dzr =
          __fmul_rn(dr, __fmul_rn(r_t, __fsub_rn(1.f, r_t)));
      const float dxf = __fadd_rn(
          __fadd_rn(__fmul_rn(dix, i_t), __fmul_rn(dzi, p.ai)),
          __fmul_rn(dzr, p.ar));
      store(dx + base + (size_t)t * W, dxf);
      acc[0] = __fadd_rn(acc[0], __fmul_rn(dzi, xf));
      acc[1] = __fadd_rn(acc[1], dzi);
      acc[2] = __fadd_rn(acc[2], __fmul_rn(dzr, xf));
      acc[3] = __fadd_rn(acc[3], dzr);
      acc[4] = __fadd_rn(acc[4], __fmul_rn(dlog_a, r_t));
    }
  }
  // 6. the tile's partial sums: a channel's threads in order
#pragma unroll
  for (int j = 0; j < NP; ++j) psum[(sub * NP + j) * CW + c] = acc[j];
  __syncthreads();
  if (threadIdx.x < NP * CW) {
    const int j = threadIdx.x / CW, cj = threadIdx.x % CW;
    float sum = psum[j * CW + cj];
#pragma unroll
    for (int k = 1; k < SUBS; ++k)
      sum = __fadd_rn(sum, psum[(k * NP + j) * CW + cj]);
    __stcg(partial + ((size_t)tile * NP + j) * CW + cj, sum);
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = atomicAdd(group_done + ct, 1) == B * n_tt - 1;
  __syncthreads();
  if (last_s) {
    // the group's last tile: every tile's partials, in tile order
    __threadfence();
    if (threadIdx.x < NP * CW) {
      const int j = threadIdx.x / CW, cj = threadIdx.x % CW;
      const int chj = c0 + cj;
      if (chj < W) {
        float sum = 0.f;
        for (int t2 = 0; t2 < n_tt; ++t2)
          for (int b2 = 0; b2 < B; ++b2) {
            const size_t tl = (size_t)t2 * row_tiles + b2 * n_ct + ct;
            sum = __fadd_rn(sum, __ldcg(partial + (tl * NP + j) * CW + cj));
          }
        // rows of grads: a_param, alpha_i, beta_i, alpha_r, beta_r
        if (j == NP - 1)
          sum = __fmul_rn(__fmul_rn(sum, -8.0f), sigmoid(a_param[chj]));
        grads[(size_t)((j + 1) % NP) * W + chj] = sum;
      }
    }
    if (threadIdx.x == 0) group_done[ct] = 0;
  }
  // the last block to finish zeroes the tile counters
  if (threadIdx.x == 0 && atomicAdd(work + 1, 1) == n_tiles - 1) {
    work[0] = 0;
    work[1] = 0;
  }
}

constexpr size_t SMEM =
    sizeof(float) * (3 * TS * CW + 6 * SUBS * CW + SUBS * NP * CW);

template <typename T>
int launch(const void* x, const float* const* prm, const void* dh,
           const float* hcarry, void* dx, float* grads, int* work,
           float* gcarry, float* partial, int B, int S, int W,
           cudaStream_t stream) {
  const long long n_tiles =
      (long long)B * ((W + CW - 1) / CW) * ((S + TS - 1) / TS);
  if (n_tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rglru_scan_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  rglru_scan_bwd_kernel<T><<<(unsigned)n_tiles, THREADS, SMEM, stream>>>(
      static_cast<const T*>(x), prm[0], prm[1], prm[2], prm[3], prm[4],
      static_cast<const T*>(dh), hcarry, static_cast<T*>(dx), grads, work,
      gcarry, partial, B, S, W, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// x, dh and dx (B, S, W) contiguous, float32 (is_bf16 = 0) or bfloat16; the
// five parameters (W,) float32; hcarry, the forward launch's carry buffer
// (csrc/rglru_scan.cu: float32, a tile's outgoing h at tile x 32 + c);
// grads (5, W) float32, rows d a_param, d alpha_i, d beta_i, d alpha_r,
// d beta_r. Scratch from the wrapper, with tiles = B x ceil(W / 32) x
// ceil(S / 256) and groups = ceil(W / 32): work, int32, 2 + tiles + groups
// entries, zero before the first launch (each launch leaves it zero);
// gcarry, float32, tiles x 32; partial, float32, tiles x 5 x 32.
extern "C" int rglru_scan_bwd_launch(const void* x, const void* a_param,
                                     const void* alpha_i, const void* beta_i,
                                     const void* alpha_r, const void* beta_r,
                                     const void* dh, const void* hcarry,
                                     void* dx, void* grads, void* work,
                                     void* gcarry, void* partial, int B,
                                     int S, int W, int is_bf16,
                                     void* stream) {
  if (B == 0 || S == 0 || W == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* prm[5] = {static_cast<const float*>(a_param),
                         static_cast<const float*>(alpha_i),
                         static_cast<const float*>(beta_i),
                         static_cast<const float*>(alpha_r),
                         static_cast<const float*>(beta_r)};
  const float* hc = static_cast<const float*>(hcarry);
  float* g = static_cast<float*>(grads);
  int* wk = static_cast<int*>(work);
  float* gc = static_cast<float*>(gcarry);
  float* pt = static_cast<float*>(partial);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, prm, dh, hc, dx, g, wk, gc, pt, B, S, W,
                                 st);
  return launch<float>(x, prm, dh, hc, dx, g, wk, gc, pt, B, S, W, st);
}
