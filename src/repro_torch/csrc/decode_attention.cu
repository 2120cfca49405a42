// GQA decode attention against the KV cache, for Hopper (sm_90a).
//
// Replaces the reference's plain einsum decode step `decode_attention`
// (src/repro/models/attention.py:96; the JAX package has no Pallas kernel
// there), which the port ran as float32 einsums over a float32 copy of the
// whole cache every step. One query row per (batch, query head) against
// the cache k, v (B, T, KV, hd) in float32, bfloat16, or int8 with float32
// per-(slot, KV head) scales; H = KV * G and query heads kv*G .. kv*G+G-1
// read KV head kv. The reference's rounding points, kept in order:
//   s = q . k (float32 sums; int8 k is cast to q's type, exact),
//   s * k_scale (int8), s / sqrt(hd) (an IEEE float32 division),
//   NEG_INF where pos < 0, pos > q_pos or (window > 0) q_pos - pos >= window,
//   p = exp(s - m) / l over all T slots (float32),
//   p * v_scale (int8), p rounded to the value type (the cache's, or q's
//   for the int8 cache), o = p . v (float32 sums), cast to q's type.
//
// Design. p is rounded after it is normalised, so a one-pass online
// softmax (rescaling un-normalised weights) would not give the reference's
// numbers. T is cut into splits of L slots (kernels/decode_attention.py
// `split_len`: B * KV * splits >= 2 x 132 blocks) and the work runs in
// three launches, GQA-native: one block serves all G query heads of a KV
// head, so each K and V row is read once from device memory.
//   1. scores_kernel, a block per (split, batch x KV head): q of the G heads
//      in shared memory; a warp per slot (4 slots in flight a warp), each
//      lane 1/32 of the head dim, a butterfly sum per head. A slot's
//      position is read first: an empty or invisible slot gets NEG_INF
//      and its K row is not loaded. Writes the scores (float32 scratch)
//      and the split's max m_s and sum l_s = sum exp(s - m_s) per head.
//   2. values_kernel, the same grid: the row's m = max m_s and l = sum l_s
//      exp(m_s - m) in split order; p per slot and head, rounded; a slot
//      whose G weights are all exactly 0 (every invisible slot of a row
//      that sees a slot) adds exact zeros, so its V row is not loaded.
//      Warps take slots round robin, 4 in flight, and accumulate 4 heads
//      at a time in registers; the warps' sums are added in warp order.
//      Writes each split's partial o (float32 scratch).
//   3. sum_kernel, a thread per output: the partials added in split
//      order, cast to q's type.
// No atomics and fixed orders everywhere: two launches are bitwise equal.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory. qwen3-4b serving
// (B = 4 slots, T = 4352, KV = 8, G = 4, hd = 128, bf16): every slot read
// is 2 x 4 x 4352 x 8 x 128 x 2 B = 71.3 MB a layer, 21.3 us at 3.35 TB/s;
// the int8 cache with its scales 36.8 MB, 11.0 us. The work on it is 4
// FLOP per slot, query head and head dim (0.07 GFLOP), far below either
// peak. recurrentgemma-9b's local layers (B = 4, a 2048-slot ring, KV = 1,
// G = 16, hd = 256) read 8.4 MB and are launch-bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int UNROLL = 4;    // slots a warp has in flight
constexpr int GC = 4;        // query heads a warp accumulates at a time
constexpr float NEG_INF = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

// p rounded to the type of the second product's operands
__device__ __forceinline__ float round_to(float x, float*) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ bool visible(long long p, long long qp,
                                        int window) {
  return p >= 0 && p <= qp && (window <= 0 || qp - p < window);
}

struct Shape {
  int B, T, KV, G, hd, L, splits, window;
};

// Pass 1. grid (splits, B * KV), THREADS threads; dynamic shared memory:
// q (G x HD floats), the split's scores (G x L floats). EPL = HD / 32 head
// dims a lane holds: d = lane + 32 e.
template <typename QT, typename CT, int EPL>
__global__ void __launch_bounds__(THREADS)
scores_kernel(const QT* __restrict__ q, const CT* __restrict__ k,
              const float* __restrict__ k_scale,
              const long long* __restrict__ pos,
              const long long* __restrict__ qpos, float* __restrict__ scores,
              float* __restrict__ stats, Shape sh, float sqrt_hd) {
  constexpr int HD = EPL * 32;
  constexpr bool QUANT = sizeof(CT) == 1;
  extern __shared__ float smem[];
  float* qs = smem;              // [G][HD]
  float* ss = smem + sh.G * HD;  // [G][L]
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / sh.KV, kv = bk % sh.KV;
  const int t0 = split * sh.L, n = min(sh.L, sh.T - t0);
  const long long qp = qpos[b];
  for (int i = threadIdx.x; i < sh.G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    qs[i] = d < sh.hd
                ? to_f(q[((size_t)bk * sh.G + g) * sh.hd + d])
                : 0.f;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int j0 = warp * UNROLL; j0 < n; j0 += WARPS * UNROLL) {
    float kr[UNROLL][EPL];
    float ksc[UNROLL];
    bool vis[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int j = j0 + u;
      const size_t slot = (size_t)b * sh.T + t0 + j;
      vis[u] = j < n && visible(pos[j < n ? slot : 0], qp, sh.window);
      const CT* row = k + (slot * sh.KV + kv) * sh.hd;
      ksc[u] = QUANT && vis[u] ? k_scale[slot * sh.KV + kv] : 1.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        kr[u][e] = vis[u] && d < sh.hd ? to_f(row[d]) : 0.f;
      }
    }
    for (int g = 0; g < sh.G; ++g) {
      const float* qg = qs + g * HD;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        float acc = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          acc = fmaf(qg[lane + 32 * e], kr[u][e], acc);
        acc = warp_sum(acc);
        if (QUANT) acc = __fmul_rn(acc, ksc[u]);
        const float s = vis[u] ? __fdiv_rn(acc, sqrt_hd) : NEG_INF;
        if (lane == 0 && j0 + u < n) {
          ss[g * sh.L + j0 + u] = s;
          scores[((size_t)bk * sh.G + g) * sh.T + t0 + j0 + u] = s;
        }
      }
    }
  }
  __syncthreads();
  // the split's max and sum of each head, a warp a head
  for (int g = warp; g < sh.G; g += WARPS) {
    const float* sg = ss + g * sh.L;
    float m = NEG_INF;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) l += expf(sg[j] - m);
    l = warp_sum(l);
    if (lane == 0) {
      const size_t at = ((size_t)bk * sh.G + g) * sh.splits + split;
      stats[at] = m;
      stats[(size_t)sh.B * sh.KV * sh.G * sh.splits + at] = l;
    }
  }
}

// Pass 2. grid (splits, B * KV), THREADS threads; dynamic shared memory:
// the split's rounded p (G x L floats), each slot's use flag (L ints), the
// row's m and l (2 G floats), the warps' partial sums (WARPS x GC x HD).
template <typename QT, typename CT, typename RT, int EPL>
__global__ void __launch_bounds__(THREADS)
values_kernel(const CT* __restrict__ v, const float* __restrict__ v_scale,
              const float* __restrict__ scores,
              const float* __restrict__ stats, float* __restrict__ part,
              Shape sh) {
  constexpr int HD = EPL * 32;
  constexpr bool QUANT = sizeof(CT) == 1;
  extern __shared__ float smem[];
  float* ps = smem;                              // [G][L]
  int* use = (int*)(ps + sh.G * sh.L);           // [L]
  float* ml = (float*)(use + sh.L);              // m [G], l [G]
  float* red = ml + 2 * sh.G;                    // [WARPS][GC][HD]
  const int split = blockIdx.x, bk = blockIdx.y;
  const int b = bk / sh.KV, kv = bk % sh.KV;
  const int t0 = split * sh.L, n = min(sh.L, sh.T - t0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = threadIdx.x; g < sh.G; g += THREADS) {
    const float* ms = stats + ((size_t)bk * sh.G + g) * sh.splits;
    const float* ls = ms + (size_t)sh.B * sh.KV * sh.G * sh.splits;
    float m = NEG_INF;
#pragma unroll 8
    for (int s = 0; s < sh.splits; ++s) m = fmaxf(m, ms[s]);
    float l = 0.f;
#pragma unroll 8
    for (int s = 0; s < sh.splits; ++s)
      l = __fadd_rn(l, __fmul_rn(ls[s], expf(ms[s] - m)));
    ml[g] = m;
    ml[sh.G + g] = l;
  }
  for (int j = threadIdx.x; j < n; j += THREADS) use[j] = 0;
  __syncthreads();
  RT* rt = nullptr;
  for (int i = threadIdx.x; i < sh.G * n; i += THREADS) {
    const int g = i / n, j = i % n;
    const size_t slot = (size_t)b * sh.T + t0 + j;
    float p = __fdiv_rn(
        expf(scores[((size_t)bk * sh.G + g) * sh.T + t0 + j] - ml[g]),
        ml[sh.G + g]);
    if (QUANT) p = __fmul_rn(p, v_scale[slot * sh.KV + kv]);
    p = round_to(p, rt);
    ps[g * sh.L + j] = p;
    if (p != 0.f) use[j] = 1;  // every writer stores the same 1
  }
  __syncthreads();
  for (int g0 = 0; g0 < sh.G; g0 += GC) {
    float acc[GC][EPL];
#pragma unroll
    for (int c = 0; c < GC; ++c)
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[c][e] = 0.f;
    for (int j0 = warp * UNROLL; j0 < n; j0 += WARPS * UNROLL) {
      float vr[UNROLL][EPL];
      bool on[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int j = j0 + u;
        on[u] = j < n && use[j < n ? j : 0];
        const CT* row =
            v + (((size_t)b * sh.T + t0 + j) * sh.KV + kv) * sh.hd;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane + 32 * e;
          vr[u][e] = on[u] && d < sh.hd ? to_f(row[d]) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (!on[u]) continue;
#pragma unroll
        for (int c = 0; c < GC; ++c) {
          if (g0 + c >= sh.G) break;
          const float p = ps[(g0 + c) * sh.L + j0 + u];
#pragma unroll
          for (int e = 0; e < EPL; ++e)
            acc[c][e] = __fadd_rn(acc[c][e], __fmul_rn(p, vr[u][e]));
        }
      }
    }
#pragma unroll
    for (int c = 0; c < GC; ++c)
#pragma unroll
      for (int e = 0; e < EPL; ++e)
        red[(warp * GC + c) * HD + lane + 32 * e] = acc[c][e];
    __syncthreads();
    for (int i = threadIdx.x; i < GC * sh.hd; i += THREADS) {
      const int c = i / sh.hd, d = i % sh.hd;
      if (g0 + c >= sh.G) continue;
      float o = 0.f;
      for (int w = 0; w < WARPS; ++w) o = __fadd_rn(o, red[(w * GC + c) * HD + d]);
      part[(((size_t)bk * sh.splits + split) * sh.G + g0 + c) * sh.hd + d] =
          o;
    }
    __syncthreads();
  }
}

// Pass 3. grid (ceil(G hd / THREADS), B * KV), THREADS threads, one output
// a thread: the splits' partials added in split order (SUM_AHEAD loaded
// ahead of the adds); out (B, 1, H, hd) in q's type.
constexpr int SUM_AHEAD = 8;

template <typename QT>
__global__ void __launch_bounds__(THREADS)
sum_kernel(const float* __restrict__ part, QT* __restrict__ out, Shape sh) {
  const int bk = blockIdx.y;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= sh.G * sh.hd) return;
  const size_t stride = (size_t)sh.G * sh.hd;
  const float* p = part + (size_t)bk * sh.splits * stride + i;
  float o = 0.f;
  for (int s0 = 0; s0 < sh.splits; s0 += SUM_AHEAD) {
    float x[SUM_AHEAD];
#pragma unroll
    for (int u = 0; u < SUM_AHEAD; ++u)
      x[u] = s0 + u < sh.splits ? p[(size_t)(s0 + u) * stride] : 0.f;
#pragma unroll
    for (int u = 0; u < SUM_AHEAD; ++u)
      if (s0 + u < sh.splits) o = __fadd_rn(o, x[u]);
  }
  store(out + (size_t)bk * stride + i, o);
}

template <typename QT, typename CT, typename RT, int EPL>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const long long* pos, const long long* qpos,
           void* out, float* scores, float* stats, float* part, Shape sh,
           float sqrt_hd, cudaStream_t stream) {
  constexpr int HD = EPL * 32;
  const size_t smem1 = sizeof(float) * ((size_t)sh.G * HD +
                                        (size_t)sh.G * sh.L);
  const size_t smem2 = sizeof(float) * ((size_t)sh.G * sh.L + sh.L +
                                        2 * sh.G + WARPS * GC * HD);
  cudaError_t err = cudaFuncSetAttribute(
      scores_kernel<QT, CT, EPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(values_kernel<QT, CT, RT, EPL>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.splits, sh.B * sh.KV);
  scores_kernel<QT, CT, EPL><<<grid, THREADS, smem1, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), ks, pos, qpos,
      scores, stats, sh, sqrt_hd);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  values_kernel<QT, CT, RT, EPL><<<grid, THREADS, smem2, stream>>>(
      static_cast<const CT*>(v), vs, scores, stats, part, sh);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 sum_grid((sh.G * sh.hd + THREADS - 1) / THREADS, sh.B * sh.KV);
  sum_kernel<QT><<<sum_grid, THREADS, 0, stream>>>(
      part, static_cast<QT*>(out), sh);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT, typename RT>
int by_head_dim(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, const long long* pos, const long long* qpos,
                void* out, float* scores, float* stats, float* part,
                Shape sh, float sqrt_hd, cudaStream_t st) {
  if (sh.hd <= 32)
    return launch<QT, CT, RT, 1>(q, k, v, ks, vs, pos, qpos, out, scores,
                                 stats, part, sh, sqrt_hd, st);
  if (sh.hd <= 64)
    return launch<QT, CT, RT, 2>(q, k, v, ks, vs, pos, qpos, out, scores,
                                 stats, part, sh, sqrt_hd, st);
  if (sh.hd <= 128)
    return launch<QT, CT, RT, 4>(q, k, v, ks, vs, pos, qpos, out, scores,
                                 stats, part, sh, sqrt_hd, st);
  if (sh.hd <= 256)
    return launch<QT, CT, RT, 8>(q, k, v, ks, vs, pos, qpos, out, scores,
                                 stats, part, sh, sqrt_hd, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the three passes on `stream` (PyTorch's current stream); returns
// the first CUDA error (cudaFuncSetAttribute or a refused launch) so the
// Python wrapper can raise. q (B, 1, H, hd) and out contiguous in q's type
// (float32, is_bf16 = 0, or bfloat16); k, v (B, T, KV, hd) contiguous in
// the route's type (cache_type 0 float32 = q's, 1 bfloat16 = q's, 2 int8
// with k_scale, v_scale (B, T, KV) float32); pos (B, T) and qpos (B) int64.
// Scratch from the wrapper: scores B*KV*G*T, stats 2*B*KV*G*splits, part
// B*KV*splits*G*hd floats, splits = ceil(T / L).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* qpos, void* out,
    void* scores, void* stats, void* part, int B, int T, int KV, int G,
    int hd, int window, int L, float sqrt_hd, int is_bf16, int cache_type,
    void* stream) {
  if (B == 0 || T == 0 || KV == 0 || G == 0) return 0;
  if (L <= 0) return (int)cudaErrorInvalidValue;
  const Shape sh{B, T, KV, G, hd, L, (T + L - 1) / L, window};
  const cudaStream_t st = (cudaStream_t)stream;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const long long* ps = static_cast<const long long*>(pos);
  const long long* qp = static_cast<const long long*>(qpos);
  float* sc = static_cast<float*>(scores);
  float* sa = static_cast<float*>(stats);
  float* pa = static_cast<float*>(part);
  if (cache_type == 2 && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!is_bf16 && cache_type == 0)
    return by_head_dim<float, float, float>(q, k, v, ks, vs, ps, qp, out, sc,
                                            sa, pa, sh, sqrt_hd, st);
  if (is_bf16 && cache_type == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        q, k, v, ks, vs, ps, qp, out, sc, sa, pa, sh, sqrt_hd, st);
  if (!is_bf16 && cache_type == 2)
    return by_head_dim<float, int8_t, float>(q, k, v, ks, vs, ps, qp, out, sc,
                                             sa, pa, sh, sqrt_hd, st);
  if (is_bf16 && cache_type == 2)
    return by_head_dim<__nv_bfloat16, int8_t, __nv_bfloat16>(
        q, k, v, ks, vs, ps, qp, out, sc, sa, pa, sh, sqrt_hd, st);
  return (int)cudaErrorInvalidValue;
}
