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
// The cross route is the reference's cross attention at one query
// (src/repro/models/attention.py:140): every slot visible (no positions),
// s * float32(1 / sqrt(hd)) (XLA compiles the reference's division by that
// constant into this product under jit, as its model functions run), and
// p kept in float32 for p . v (the bf16 cache's instantiation with a
// float32 p, <bf16, bf16, float>).
//
// Design. p is rounded after it is normalised, so a one-pass online
// softmax (rescaling un-normalised weights) would not give the reference's
// numbers: two launches, GQA-native. A block serves GH = 4 query heads of
// one KV head (grid.y: batch x KV head x head group) and one split of the
// slots (grid.x): T is cut into 32-slot chunks dealt round robin to the
// splits (kernels/decode_attention.py `split_len`, so a split's share of a
// filled prefix is even and the blocks fill the 132 SMs in whole waves).
//   1. scores_kernel: the split's positions are read once, coalesced, and
//      the visible slots compacted in order into shared memory by a
//      block-wide prefix sum, so no K load waits on a position and work
//      follows what is read. q of the block's heads sits in registers, a
//      lane holding 16 bytes of the row's head dims (R lanes a row); a warp
//      keeps 8-16 rows in flight with 16-byte loads. Each lane's 4 partial
//      dot products are summed over the row's R lanes by a halving
//      butterfly (2 + 1 + log2(R / 4) shuffles for 4 heads, where a
//      butterfly a head took 4 log2(R)). Writes the visible slots' scores
//      and the split's max m_s and sum l_s = sum exp(s - m_s) per head;
//      the (batch, split) block of KV head 0 and head group 0 also writes
//      the compacted slot list.
//   2. values_kernel: the row's m = max m_s and l = sum l_s exp(m_s - m) in
//      split order; p of the listed slots, rounded; rows of V read as in
//      pass 1 and accumulated for the 4 heads in registers; the lanes' and
//      warps' sums added in a fixed order; the split's partial o written.
//      The last block of each (batch, KV head, head group) to finish (an
//      arrival counter, reset by that block) adds the partials in split
//      order and writes the output: the counter picks who adds, never the
//      order. A row that sees no slot has m = NEG_INF and p = 1 / T on
//      every slot, as the reference's softmax over all NEG_INF gives; pass
//      2 then lists every slot of the split.
// No atomics in any sum and fixed orders everywhere: two launches are
// bitwise equal, and the counters return to 0, so the launch can be
// captured in a CUDA graph and replayed.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory. qwen3-4b serving
// (B = 4 slots, T = 4352, KV = 8, G = 4, hd = 128, bf16): every slot read
// is 2 x 4 x 4352 x 8 x 128 x 2 B = 71.3 MB a layer, 21.3 us at 3.35 TB/s;
// the visible slots of chip_smoke.py phase 25 (9,379 of 17,408) 38.6 MB,
// 11.5 us. The work on it is 4 FLOP per slot, query head and head dim
// (0.07 GFLOP), far below either peak, so the CUDA cores do it (a wgmma
// would also sum in an order and precision of its own).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int GH = 4;          // query heads a block serves
constexpr int CHUNK = 32;      // slots of a chunk (kernels/decode_attention.py)
constexpr int FOLD_AHEAD = 8;  // splits' partials loaded ahead of the adds
constexpr float NEG_INF = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;

// How a row of HD head dims of type CT spreads over a warp: DPL dims a
// lane (16 bytes, or HD / 32 where that would take more than 32 lanes), R
// lanes a row, NS rows a warp at once, U such rounds in flight, W 32-bit
// words a lane loads.
template <typename CT, int HD>
struct Layout {
  static constexpr int DPL16 = 16 / (int)sizeof(CT);
  static constexpr int DPL = HD / DPL16 > 32 ? HD / 32 : DPL16;
  static constexpr int R = HD / DPL;
  static constexpr int NS = 32 / R;
  static constexpr int U = R / 2 < 1 ? 1 : (R / 2 > 8 ? 8 : R / 2);
  static constexpr int W = DPL * (int)sizeof(CT) / 4;
  static_assert(R >= 2 && R <= 32 && W % 4 == 0, "row layout");
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// element e of a lane's packed words, as a float
template <typename CT>
__device__ __forceinline__ float elem(const uint32_t* w, int e);
template <>
__device__ __forceinline__ float elem<float>(const uint32_t* w, int e) {
  return __uint_as_float(w[e]);
}
template <>
__device__ __forceinline__ float elem<__nv_bfloat16>(const uint32_t* w,
                                                     int e) {
  const uint32_t x = w[e / 2];
  return __uint_as_float(e % 2 ? (x & 0xffff0000u) : (x << 16));
}
template <>
__device__ __forceinline__ float elem<int8_t>(const uint32_t* w, int e) {
  return (float)((int32_t)(w[e / 4] << (24 - 8 * (e % 4))) >> 24);
}

// a lane's DPL dims of a row: 16-byte loads where the row is whole and
// aligned (`full`), else element by element with the dims past hd zero
template <typename CT, int DPL, int W>
__device__ __forceinline__ void load_dims(const CT* row, int d0, int hd,
                                          bool full, uint32_t (&w)[W]) {
  if (full) {
    const uint4* p = reinterpret_cast<const uint4*>(row + d0);
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = __ldg(p + i);
      w[4 * i] = x.x;
      w[4 * i + 1] = x.y;
      w[4 * i + 2] = x.z;
      w[4 * i + 3] = x.w;
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < W; ++i) w[i] = 0u;
#pragma unroll
  for (int e = 0; e < DPL; ++e) {
    const int d = d0 + e;
    if (d >= hd) break;
    const CT x = row[d];
    if constexpr (sizeof(CT) == 4) {
      w[e] = __float_as_uint(to_f(x));
    } else if constexpr (sizeof(CT) == 2) {
      w[e / 2] |= (uint32_t)__bfloat16_as_ushort(x) << (16 * (e % 2));
    } else {
      w[e / 4] |= (uint32_t)(uint8_t)x << (8 * (e % 4));
    }
  }
}

// p rounded to the type of the second product's operands (float: kept)
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

// Sums each of the 4 heads' partial dot products over the R lanes of a
// row: the first two steps halve the heads a lane keeps, the rest add.
// Afterwards a lane holds head head_of<R>(r) in v[0] (for R = 2 heads
// head_of and head_of + 1 in v[0], v[1]).
template <int R>
__device__ __forceinline__ void row_sum4(float (&v)[GH], int lane) {
  {
    constexpr int off = R / 2;
    const bool up = lane & off;
    const float s0 = up ? v[0] : v[2], s1 = up ? v[1] : v[3];
    const float k0 = up ? v[2] : v[0], k1 = up ? v[3] : v[1];
    v[0] = k0 + __shfl_xor_sync(FULL, s0, off);
    v[1] = k1 + __shfl_xor_sync(FULL, s1, off);
  }
  if constexpr (R >= 4) {
    constexpr int off = R / 4;
    const bool up = lane & off;
    const float s0 = up ? v[0] : v[1], k0 = up ? v[1] : v[0];
    v[0] = k0 + __shfl_xor_sync(FULL, s0, off);
#pragma unroll
    for (int o = R / 8; o >= 1; o >>= 1)
      v[0] += __shfl_xor_sync(FULL, v[0], o);
  }
}
template <int R>
__device__ __forceinline__ int head_of(int r) {
  return ((r & (R / 2)) ? 2 : 0) + (R >= 4 && (r & (R / 4)) ? 1 : 0);
}
// whether lane r of a row writes what it holds (one lane a head)
template <int R>
__device__ __forceinline__ bool head_writer(int r) {
  return R < 4 || (r & (R / 4 - 1)) == 0;
}

__device__ __forceinline__ bool visible(long long p, long long qp,
                                        int window) {
  return p >= 0 && p <= qp && (window <= 0 || qp - p < window);
}

struct Shape {
  int B, T, KV, G, hd, L, splits, window, NHG;
};

// slot of a split's i-th candidate: the split takes chunks split,
// split + splits, ...; -1 past T
__device__ __forceinline__ int slot_of(const Shape& sh, int split, int i) {
  const int t = (split + (i / CHUNK) * sh.splits) * CHUNK + i % CHUNK;
  return t < sh.T ? t : -1;
}

// The split's candidates that are inside T and, unless `every`, visible,
// written in order to idx by a block-wide prefix sum; returns their count
// and sets *inside to the count inside T. Every thread of the block calls
// it; it ends with a barrier.
__device__ int compact(const Shape& sh, int split, const long long* pos_b,
                       long long qp, bool every, int* idx, int* warp_n,
                       int* inside) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int total = 0, in_t = 0;
  for (int base = 0; base < sh.L; base += THREADS) {
    const int i = base + threadIdx.x;
    const int t = i < sh.L ? slot_of(sh, split, i) : -1;
    const bool take =
        t >= 0 && (every || visible(pos_b[t], qp, sh.window));
    const unsigned m = __ballot_sync(FULL, take);
    const unsigned mi = __ballot_sync(FULL, t >= 0);
    if (lane == 0) {
      warp_n[warp] = __popc(m);
      warp_n[WARPS + warp] = __popc(mi);
    }
    __syncthreads();
    int at = total;
    for (int w = 0; w < warp; ++w) at += warp_n[w];
    if (take) idx[at + __popc(m & ((1u << lane) - 1u))] = t;
    for (int w = 0; w < WARPS; ++w) {
      total += warp_n[w];
      in_t += warp_n[WARPS + w];
    }
    __syncthreads();
  }
  *inside = in_t;
  return total;
}

// Pass 1. grid (splits, B * KV * NHG), THREADS threads; dynamic shared
// memory: the compacted slots (L ints), the scores (GH x L floats).
template <typename QT, typename CT, int HD>
__global__ void __launch_bounds__(THREADS, 2)
scores_kernel(const QT* __restrict__ q, const CT* __restrict__ k,
              const float* __restrict__ k_scale,
              const long long* __restrict__ pos,
              const long long* __restrict__ qpos, int* __restrict__ vidx,
              float* __restrict__ scores, float* __restrict__ stats,
              Shape sh, float scale, int cross, int full) {
  using Lo = Layout<CT, HD>;
  constexpr int DPL = Lo::DPL, R = Lo::R, NS = Lo::NS, U = Lo::U,
                W = Lo::W;
  constexpr bool QUANT = sizeof(CT) == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_n[2 * WARPS];
  int* idx = reinterpret_cast<int*>(smem_raw);       // [L]
  float* ss = reinterpret_cast<float*>(idx + sh.L);  // [GH][L]
  const int split = blockIdx.x, unit = blockIdx.y;
  const int bk = unit / sh.NHG, g0 = (unit % sh.NHG) * GH;
  const int b = bk / sh.KV, kv = bk % sh.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane % R, d0 = r * DPL;
  int n_in;
  // no positions (the cross route): every slot inside T is visible
  const bool every = pos == nullptr;
  const int nv = compact(sh, split, every ? nullptr : pos + (size_t)b * sh.T,
                         every ? 0 : qpos[b], every, idx, warp_n, &n_in);
  if (kv == 0 && g0 == 0) {
    int* list = vidx + ((size_t)b * sh.splits + split) * sh.L;
    for (int j = threadIdx.x; j < nv; j += THREADS) list[j] = idx[j];
    if (threadIdx.x == 0)
      vidx[(size_t)sh.B * sh.splits * sh.L + (size_t)b * sh.splits + split] =
          nv;
  }
  float qr[GH][DPL];
#pragma unroll
  for (int gi = 0; gi < GH; ++gi)
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int g = g0 + gi, d = d0 + e;
      qr[gi][e] = g < sh.G && d < sh.hd
                      ? to_f(q[((size_t)bk * sh.G + g) * sh.hd + d])
                      : 0.f;
    }
  const bool whole = full != 0;
  const int stream = warp * NS + lane / R;
  constexpr int NSTR = WARPS * NS;
  const size_t slot_stride = (size_t)sh.KV * sh.hd;
  const CT* kb = k + ((size_t)b * sh.T * sh.KV + kv) * sh.hd;
  float* sc = scores + ((size_t)unit * sh.splits + split) * GH * sh.L;
  const int hw = head_of<R>(r);
  for (int base = 0; base < nv; base += NSTR * U) {
    uint32_t raw[U][W];
    float ksc[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jc = base + u * NSTR + stream;
      ksc[u] = 1.f;
      if (jc < nv) {
        const int t = idx[jc];
        load_dims<CT, DPL, W>(kb + (size_t)t * slot_stride, d0, sh.hd,
                              whole, raw[u]);
        if (QUANT) ksc[u] = k_scale[((size_t)b * sh.T + t) * sh.KV + kv];
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) raw[u][i] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float acc[GH];
#pragma unroll
      for (int gi = 0; gi < GH; ++gi) {
        acc[gi] = 0.f;
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[gi] = fmaf(qr[gi][e], elem<CT>(raw[u], e), acc[gi]);
      }
      row_sum4<R>(acc, lane);
      const int jc = base + u * NSTR + stream;
      if (jc < nv && head_writer<R>(r)) {
#pragma unroll
        for (int c = 0; c < (R < 4 ? 2 : 1); ++c) {
          const int gi = hw + c;
          if (g0 + gi >= sh.G) continue;
          float s = acc[c];
          if (QUANT) s = __fmul_rn(s, ksc[u]);
          s = cross ? __fmul_rn(s, scale) : __fdiv_rn(s, scale);
          ss[gi * sh.L + jc] = s;
          sc[gi * sh.L + jc] = s;
        }
      }
    }
  }
  __syncthreads();
  // the split's max and sum of each head, a warp a head
  if (warp < GH && g0 + warp < sh.G) {
    const float* sg = ss + warp * sh.L;
    float m = NEG_INF;
    for (int j = lane; j < nv; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nv; j += 32) l += expf(sg[j] - m);
    l = warp_sum(l);
    // no slot visible: every candidate's exp(NEG_INF - NEG_INF) is 1
    if (nv == 0) l = (float)n_in;
    if (lane == 0) {
      const size_t at = ((size_t)unit * GH + warp) * sh.splits + split;
      stats[at] = m;
      stats[(size_t)sh.B * sh.KV * sh.NHG * GH * sh.splits + at] = l;
    }
  }
}

// Pass 2. grid (splits, B * KV * NHG), THREADS threads; dynamic shared
// memory: the listed slots (L ints), their rounded p (GH x L floats), the
// warps' partial sums (WARPS x GH x HD floats).
template <typename QT, typename CT, typename RT, int HD>
__global__ void __launch_bounds__(THREADS, 2)
values_kernel(const CT* __restrict__ v, const float* __restrict__ v_scale,
              const long long* __restrict__ pos,
              const long long* __restrict__ qpos,
              const int* __restrict__ vidx, const float* __restrict__ scores,
              const float* __restrict__ stats, float* __restrict__ part,
              unsigned* __restrict__ arrivals, QT* __restrict__ out,
              Shape sh, int full) {
  using Lo = Layout<CT, HD>;
  constexpr int DPL = Lo::DPL, R = Lo::R, NS = Lo::NS, U = Lo::U,
                W = Lo::W;
  constexpr bool QUANT = sizeof(CT) == 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_n[2 * WARPS];
  __shared__ float ml[2 * GH];
  __shared__ int last;
  int* idx = reinterpret_cast<int*>(smem_raw);          // [L]
  float* ps = reinterpret_cast<float*>(idx + sh.L);     // [GH][L]
  float* red = ps + GH * sh.L;                          // [WARPS][GH][HD]
  const int split = blockIdx.x, unit = blockIdx.y;
  const int bk = unit / sh.NHG, g0 = (unit % sh.NHG) * GH;
  const int b = bk / sh.KV, kv = bk % sh.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane % R, d0 = r * DPL;
  const size_t n_stats = (size_t)sh.B * sh.KV * sh.NHG * GH * sh.splits;
  // the row's m and l of each head (a group's head 0 always exists; the
  // unused heads' p is 0)
  if (threadIdx.x < GH && g0 + threadIdx.x < sh.G) {
    const int gi = threadIdx.x;
    const float* ms = stats + ((size_t)unit * GH + gi) * sh.splits;
    const float* ls = ms + n_stats;
    float m = NEG_INF, l = 0.f;
#pragma unroll 8
    for (int s = 0; s < sh.splits; ++s) m = fmaxf(m, ms[s]);
#pragma unroll 8
    for (int s = 0; s < sh.splits; ++s)
      l = __fadd_rn(l, __fmul_rn(ls[s], expf(ms[s] - m)));
    ml[gi] = m;
    ml[GH + gi] = l;
  }
  __syncthreads();
  // no slot of row b visible: p = 1 / l on every slot of the row
  const bool dead = ml[0] == NEG_INF;
  int nv;
  if (dead) {
    int n_in;
    nv = compact(sh, split, pos == nullptr ? nullptr : pos + (size_t)b * sh.T,
                 pos == nullptr ? 0 : qpos[b], true, idx, warp_n, &n_in);
  } else {
    nv = vidx[(size_t)sh.B * sh.splits * sh.L + (size_t)b * sh.splits +
              split];
    const int* list = vidx + ((size_t)b * sh.splits + split) * sh.L;
    for (int j = threadIdx.x; j < nv; j += THREADS) idx[j] = list[j];
  }
  const float* sc = scores + ((size_t)unit * sh.splits + split) * GH * sh.L;
  RT* rt = nullptr;
  __syncthreads();
  for (int i = threadIdx.x; i < GH * nv; i += THREADS) {
    const int gi = i / nv, jc = i % nv;
    float p = 0.f;
    if (g0 + gi < sh.G) {
      const float s = dead ? NEG_INF : sc[gi * sh.L + jc];
      p = __fdiv_rn(expf(s - ml[gi]), ml[GH + gi]);
      if (QUANT)
        p = __fmul_rn(p, v_scale[((size_t)b * sh.T + idx[jc]) * sh.KV + kv]);
      p = round_to(p, rt);
    }
    ps[gi * sh.L + jc] = p;
  }
  __syncthreads();
  const bool whole = full != 0;
  const int stream = warp * NS + lane / R;
  constexpr int NSTR = WARPS * NS;
  const size_t slot_stride = (size_t)sh.KV * sh.hd;
  const CT* vb = v + ((size_t)b * sh.T * sh.KV + kv) * sh.hd;
  float acc[GH][DPL];
#pragma unroll
  for (int gi = 0; gi < GH; ++gi)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[gi][e] = 0.f;
  for (int base = 0; base < nv; base += NSTR * U) {
    uint32_t raw[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jc = base + u * NSTR + stream;
      if (jc < nv) {
        load_dims<CT, DPL, W>(vb + (size_t)idx[jc] * slot_stride, d0, sh.hd,
                              whole, raw[u]);
      } else {
#pragma unroll
        for (int i = 0; i < W; ++i) raw[u][i] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jc = base + u * NSTR + stream;
      if (jc >= nv) continue;
#pragma unroll
      for (int gi = 0; gi < GH; ++gi) {
        const float p = ps[gi * sh.L + jc];
#pragma unroll
        for (int e = 0; e < DPL; ++e)
          acc[gi][e] = fmaf(p, elem<CT>(raw[u], e), acc[gi][e]);
      }
    }
  }
  // the warp's row streams added (lanes r, r + R, ...), then the warps in
  // warp order
#pragma unroll
  for (int o = R; o < 32; o <<= 1)
#pragma unroll
    for (int gi = 0; gi < GH; ++gi)
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        acc[gi][e] += __shfl_xor_sync(FULL, acc[gi][e], o);
  if (lane < R) {
#pragma unroll
    for (int gi = 0; gi < GH; ++gi)
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        red[(warp * GH + gi) * HD + d0 + e] = acc[gi][e];
  }
  __syncthreads();
  float* pp = part + (size_t)unit * sh.splits * GH * sh.hd;
  for (int i = threadIdx.x; i < GH * sh.hd; i += THREADS) {
    const int gi = i / sh.hd, d = i % sh.hd;
    float o = 0.f;
    for (int w = 0; w < WARPS; ++w)
      o = __fadd_rn(o, red[(w * GH + gi) * HD + d]);
    pp[((size_t)split * GH + gi) * sh.hd + d] = o;
  }
  // the last block of the unit to arrive adds the partials in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(arrivals + unit, 1u);
    last = ticket == (unsigned)sh.splits - 1u;
    if (last) arrivals[unit] = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  const size_t stride = (size_t)GH * sh.hd;
  for (int i = threadIdx.x; i < GH * sh.hd; i += THREADS) {
    const int gi = i / sh.hd, d = i % sh.hd;
    if (g0 + gi >= sh.G) continue;
    const float* p = pp + i;
    float o = 0.f;
    for (int s0 = 0; s0 < sh.splits; s0 += FOLD_AHEAD) {
      float x[FOLD_AHEAD];
#pragma unroll
      for (int u = 0; u < FOLD_AHEAD; ++u)
        x[u] = s0 + u < sh.splits ? __ldcg(p + (size_t)(s0 + u) * stride)
                                  : 0.f;
#pragma unroll
      for (int u = 0; u < FOLD_AHEAD; ++u)
        if (s0 + u < sh.splits) o = __fadd_rn(o, x[u]);
    }
    store(out + ((size_t)bk * sh.G + g0 + gi) * sh.hd + d, o);
  }
}

template <typename QT, typename CT, typename RT, int HD>
int launch(const void* q, const void* k, const void* v, const float* ks,
           const float* vs, const long long* pos, const long long* qpos,
           void* out, float* scores, float* stats, float* part, int* vidx,
           unsigned* arrivals, Shape sh, float scale, int cross,
           cudaStream_t stream) {
  const int full = sh.hd == HD && (uintptr_t)k % 16 == 0 &&
                   (uintptr_t)v % 16 == 0;
  const size_t smem1 = sizeof(int) * sh.L + sizeof(float) * GH * sh.L;
  const size_t smem2 = smem1 + sizeof(float) * WARPS * GH * HD;
  cudaError_t err = cudaFuncSetAttribute(
      scores_kernel<QT, CT, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(values_kernel<QT, CT, RT, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.splits, sh.B * sh.KV * sh.NHG);
  scores_kernel<QT, CT, HD><<<grid, THREADS, smem1, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), ks, pos, qpos,
      vidx, scores, stats, sh, scale, cross, full);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  values_kernel<QT, CT, RT, HD><<<grid, THREADS, smem2, stream>>>(
      static_cast<const CT*>(v), vs, pos, qpos, vidx, scores, stats, part,
      arrivals, static_cast<QT*>(out), sh, full);
  return (int)cudaGetLastError();
}

template <typename QT, typename CT, typename RT>
int by_head_dim(const void* q, const void* k, const void* v, const float* ks,
                const float* vs, const long long* pos, const long long* qpos,
                void* out, float* scores, float* stats, float* part,
                int* vidx, unsigned* arrivals, Shape sh, float scale,
                int cross, cudaStream_t st) {
  if (sh.hd <= 32)
    return launch<QT, CT, RT, 32>(q, k, v, ks, vs, pos, qpos, out, scores,
                                  stats, part, vidx, arrivals, sh, scale,
                                  cross, st);
  if (sh.hd <= 64)
    return launch<QT, CT, RT, 64>(q, k, v, ks, vs, pos, qpos, out, scores,
                                  stats, part, vidx, arrivals, sh, scale,
                                  cross, st);
  if (sh.hd <= 128)
    return launch<QT, CT, RT, 128>(q, k, v, ks, vs, pos, qpos, out, scores,
                                   stats, part, vidx, arrivals, sh, scale,
                                   cross, st);
  if (sh.hd <= 256)
    return launch<QT, CT, RT, 256>(q, k, v, ks, vs, pos, qpos, out, scores,
                                   stats, part, vidx, arrivals, sh, scale,
                                   cross, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches the two passes on `stream` (PyTorch's current stream); returns
// the first CUDA error (cudaFuncSetAttribute or a refused launch) so the
// Python wrapper can raise. q (B, 1, H, hd) and out contiguous in q's type
// (float32, is_bf16 = 0, or bfloat16); k, v (B, T, KV, hd) contiguous in
// the route's type (cache_type 0 float32 = q's, 1 bfloat16 = q's, 2 int8
// with k_scale, v_scale (B, T, KV) float32); pos (B, T) and qpos (B) int64,
// and the scores divided by `scale` (sqrt(hd) in float32). With cross = 1
// (float32 and bfloat16 caches only) pos and qpos are null, every slot is
// visible, the scores are multiplied by `scale` (float32(1 / sqrt(hd)))
// and p is not rounded.
// splits splits of L candidate slots (kernels/decode_attention.py
// `split_len`); NHG = ceil(G / 4) head groups. Scratch from the wrapper,
// U = B * KV * NHG blocks a split: scores U*splits*4*L, stats
// 2*U*4*splits, part U*splits*4*hd floats; vidx B*splits*(L + 1) ints;
// arrivals U unsigned ints, zero before the first launch (each launch
// leaves them zero).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* qpos, void* out,
    void* scores, void* stats, void* part, void* vidx, void* arrivals, int B,
    int T, int KV, int G, int hd, int window, int splits, int L,
    float scale, int is_bf16, int cache_type, int cross, void* stream) {
  if (B == 0 || T == 0 || KV == 0 || G == 0) return 0;
  if (L <= 0 || L % CHUNK || splits <= 0 ||
      (long long)splits * (L / CHUNK) * CHUNK < T)
    return (int)cudaErrorInvalidValue;
  const Shape sh{B, T, KV, G, hd, L, splits, window, (G + GH - 1) / GH};
  const cudaStream_t st = (cudaStream_t)stream;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const long long* ps = static_cast<const long long*>(pos);
  const long long* qp = static_cast<const long long*>(qpos);
  float* sc = static_cast<float*>(scores);
  float* sa = static_cast<float*>(stats);
  float* pa = static_cast<float*>(part);
  int* vi = static_cast<int*>(vidx);
  unsigned* ar = static_cast<unsigned*>(arrivals);
  if (cache_type == 2 && (ks == nullptr || vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((ps == nullptr) != (qp == nullptr) || (ps == nullptr) != (cross != 0) ||
      (cross && cache_type == 2))
    return (int)cudaErrorInvalidValue;
  if (!is_bf16 && cache_type == 0)
    return by_head_dim<float, float, float>(q, k, v, ks, vs, ps, qp, out, sc,
                                            sa, pa, vi, ar, sh, scale, cross,
                                            st);
  if (is_bf16 && cache_type == 1 && cross)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16, float>(
        q, k, v, ks, vs, ps, qp, out, sc, sa, pa, vi, ar, sh, scale, cross,
        st);
  if (is_bf16 && cache_type == 1)
    return by_head_dim<__nv_bfloat16, __nv_bfloat16, __nv_bfloat16>(
        q, k, v, ks, vs, ps, qp, out, sc, sa, pa, vi, ar, sh, scale, cross,
        st);
  if (!is_bf16 && cache_type == 2)
    return by_head_dim<float, int8_t, float>(q, k, v, ks, vs, ps, qp, out, sc,
                                             sa, pa, vi, ar, sh, scale, cross,
                                             st);
  if (is_bf16 && cache_type == 2)
    return by_head_dim<__nv_bfloat16, int8_t, __nv_bfloat16>(
        q, k, v, ks, vs, ps, qp, out, sc, sa, pa, vi, ar, sh, scale, cross,
        st);
  return (int)cudaErrorInvalidValue;
}
