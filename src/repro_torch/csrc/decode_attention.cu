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
// p kept in float32 for p . v.
//
// T is cut into 32-slot chunks dealt round robin to the splits
// (kernels/decode_attention.py `split_len`: a split's share of a filled
// prefix is even, and the blocks of a launch come near one wave). A block
// serves one split of one (batch, KV head, head group). Three routes:
//
// Split route (float32 caches, G <= 4, and an int8 cache under a float32
// q): GH = 4 query heads a block on the CUDA cores. p is rounded after it
// is normalised, so a one-pass online softmax (rescaling un-normalised
// weights) would not give the reference's numbers: two launches.
//   1. scores_kernel: the split's positions are read once, coalesced, and
//      the visible slots compacted in order into shared memory by a
//      block-wide prefix sum, so no K load waits on a position. q of the
//      block's heads sits in registers, a lane holding 16 bytes of the
//      row's head dims (R lanes a row); a warp keeps 8-16 rows in flight
//      with 16-byte loads. Each lane's 4 partial dot products are summed
//      over the row's R lanes by a halving butterfly. Writes the visible
//      slots' scores and the split's max m_s and sum l_s = sum exp(s - m_s)
//      per head; the (batch, split) block of KV head 0 and head group 0
//      also writes the compacted slot list.
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
//
// Grouped route (G > 4, a bf16 q on the bf16 or int8 cache): GG = 16 query
// heads of one KV head a block (ceil(G / 16) blocks where G > 16), so each
// visible slot's K and V rows are read once a pass, where 4-head groups
// read them ceil(G / 4) times. The heads are the M = 16 rows of
// `mma.sync.m16n8k16` bf16 products with float32 sums (wgmma needs 64
// rows; rows past G are zero, kept in registers, not in shared memory).
// At most 16 splits while they hold T at 1024 slots each (kernels/
// decode_attention.py `GROUPED_MAX_SPLITS`: each split adds a partial to
// every fold). The same two launches and rounding points:
//   1. grouped_scores_kernel: the split's visible slots compacted as
//      above; their K rows gathered by the list into a 3-stage ring in
//      shared memory with cp.async (64 slots a stage, an 8-slot tile a
//      warp), the cache's own bytes; S = Q K^T a tile, q's A fragments in
//      registers. The head dims run through the product in a permuted
//      order (lane t of a row group reads 8 consecutive dims, 16 bytes of
//      bf16 or 8 of int8, and feeds them to two k-steps), the same for Q
//      and K, so a fragment is one shared load; int8 becomes bf16 there,
//      exact for |x| <= 127. Then s * k_scale, / sqrt(hd), the split's m_s
//      and l_s as the split route.
//   2. grouped_values_kernel: a block owns DS = 64 head dims of its unit
//      (a warp 8), so hd / 64 blocks share a split and fold their own
//      dims in parallel. The split's scores (by cp.async), the heads'
//      split statistics and the slot list are read at once; V's first
//      stages (a 4-stage ring of 32 slots of the block's dims, gathered
//      by the list with cp.async) are issued before m, l (in split order)
//      and P = exp(s - m) / l (* v_scale), rounded to bf16, 16 x slots in
//      shared memory; O = P V with B fragments by `ldmatrix.trans` (bf16)
//      or byte loads (int8); the split's partial o written, and the last
//      block of the (unit, dims) adds the partials in split order.
// Each k-step's 16 products are summed by the tensor core from a zero
// accumulator and the k-steps added in IEEE float32, as an accumulator
// kept inside the tensor core truncates the small products' low bits.
// bf16 products are exact in float32, but the sums run in an order of
// their own, so the route is held to the split route's limit (two bf16
// steps + 1e-4 of the plain version), not bit for bit.
//
// Cross route (the cross cache, float32 or bf16): one launch, GH = 4 heads
// a block. p stays in float32 and is never rounded, so the normalisation
// can move after the product: cross_kernel issues the split's V rows into
// shared memory with cp.async first (no V address depends on a score),
// computes the scores of its slots (every slot visible: they come straight
// from the chunk schedule, with no compaction and no position read) into
// shared memory only, m_s, p = exp(s - m_s) and l_s, then o_s = sum p v
// from shared memory, and writes (m_s, l_s, o_s). The last block of the
// unit folds the splits in split order: m = max m_s, l = sum l_s exp(m_s -
// m), o = (sum exp(m_s - m) o_s) / l, cast to q's type.
//
// No float atomics and fixed orders everywhere: two launches are bitwise
// equal, and the counters return to 0, so the launch can be captured in a
// CUDA graph and replayed.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory. qwen3-4b serving
// (B = 4 slots, T = 4352, KV = 8, G = 4, hd = 128, bf16): every slot read
// is 2 x 4 x 4352 x 8 x 128 x 2 B = 71.3 MB a layer, 21.3 us at 3.35 TB/s;
// the visible slots of chip_smoke.py phase 25 (9,379 of 17,408) 38.6 MB,
// 11.5 us. At G = 16 on KV = 2 the visible K and V are 4x fewer bytes for
// the same FLOP, and the int8 cache's bound is then set by operations at
// the CUDA cores' float32 rate: the grouped route gives the products to
// the tensor cores.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The last block's fold: for each i < n (n = heads x hd, hd = the row
// length), sum over the splits s in split order of weight(s, i) *
// part[s * stride + i], handed to emit(i, sum). Columns of 4 floats where
// hd % 4 == 0 (weight is then read once a column), FOLD_COLS columns of a
// thread and FOLD_LOADS splits of each loaded before their adds, so a
// thread keeps up to FOLD_COLS x FOLD_LOADS loads in flight.
constexpr int FOLD_COLS = 1, FOLD_LOADS = 16;
template <typename Weight, typename Emit>
__device__ __forceinline__ void fold_splits(const float* __restrict__ part,
                                            size_t stride, int n, int hd,
                                            int splits, int threads,
                                            Weight weight, Emit emit) {
  const int vec = hd % 4 == 0 ? 4 : 1, cols = n / vec;
  for (int c0 = threadIdx.x; c0 < cols; c0 += threads * FOLD_COLS) {
    float o[FOLD_COLS][4] = {};
    for (int s0 = 0; s0 < splits; s0 += FOLD_LOADS) {
      float4 x[FOLD_COLS][FOLD_LOADS];
#pragma unroll
      for (int f = 0; f < FOLD_COLS; ++f)
#pragma unroll
        for (int u = 0; u < FOLD_LOADS; ++u) {
          const int c = c0 + f * threads, s = s0 + u;
          x[f][u] = make_float4(0.f, 0.f, 0.f, 0.f);
          if (c >= cols || s >= splits) continue;
          const float* at = part + (size_t)s * stride + (size_t)c * vec;
          if (vec == 4)
            x[f][u] = __ldcg(reinterpret_cast<const float4*>(at));
          else
            x[f][u].x = __ldcg(at);
        }
#pragma unroll
      for (int f = 0; f < FOLD_COLS; ++f)
#pragma unroll
        for (int u = 0; u < FOLD_LOADS; ++u) {
          const int c = c0 + f * threads, s = s0 + u;
          if (c >= cols || s >= splits) continue;
          const float w = weight(s, c * vec);
          o[f][0] = __fadd_rn(o[f][0], __fmul_rn(w, x[f][u].x));
          o[f][1] = __fadd_rn(o[f][1], __fmul_rn(w, x[f][u].y));
          o[f][2] = __fadd_rn(o[f][2], __fmul_rn(w, x[f][u].z));
          o[f][3] = __fadd_rn(o[f][3], __fmul_rn(w, x[f][u].w));
        }
    }
#pragma unroll
    for (int f = 0; f < FOLD_COLS; ++f) {
      const int c = c0 + f * threads;
      if (c >= cols) continue;
      for (int e = 0; e < vec; ++e) emit(c * vec + e, o[f][e]);
    }
  }
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
              Shape sh, float scale, int full) {
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
  const int nv = compact(sh, split, pos + (size_t)b * sh.T, qpos[b], false,
                         idx, warp_n, &n_in);
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
          s = __fdiv_rn(s, scale);
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
template <typename QT, typename CT, int HD>
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
    nv = compact(sh, split, pos + (size_t)b * sh.T, qpos[b], true, idx,
                 warp_n, &n_in);
  } else {
    nv = vidx[(size_t)sh.B * sh.splits * sh.L + (size_t)b * sh.splits +
              split];
    const int* list = vidx + ((size_t)b * sh.splits + split) * sh.L;
    for (int j = threadIdx.x; j < nv; j += THREADS) idx[j] = list[j];
  }
  const float* sc = scores + ((size_t)unit * sh.splits + split) * GH * sh.L;
  QT* rt = nullptr;   // p rounds to q's type: the cache's, or q's for int8
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

// ---------------------------------------------------------------------------
// The grouped route and the cross route's staging: cp.async, mma, ldmatrix.

constexpr int GG = 16;           // query heads a grouped block serves
constexpr int KSTAGES = 3;       // K ring stages (grouped pass 1)
constexpr int KSL = WARPS * 8;   // slots a K stage holds: an 8-slot tile a warp
constexpr int VSTAGES = 4;       // V ring stages (grouped pass 2)
constexpr int VSL = 32;          // slots a V stage holds: two 16-slot k-steps
constexpr int DS = 64;           // head dims a grouped pass-2 block owns

// rows of scores and P a grouped block keeps in shared memory: the heads
// a unit can have, min(G, GG)
__host__ __device__ __forceinline__ int grouped_rows(int G) {
  return G < GG ? G : GG;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 bytes global -> shared, bypassing L1; zeros where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// D += A B for one m16n8k16 tile: bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// the B fragment of a k16 x n8 tile stored row-major (k rows) in shared
// memory: lanes 0-15 give the addresses of rows 0-15
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_u32(p)));
}
// two values as a bf16 pair, the first in the low half (exact for int8)
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}
// byte e of a word, as the int8 value it holds
__device__ __forceinline__ float sbyte(uint32_t w, int e) {
  return (float)((int32_t)(w << (24 - 8 * e)) >> 24);
}

// Rows j0 .. j0 + SL - 1 of the slot list `idx` (zeros past nv) copied
// into shared rows of ROW bytes, HD values of type CT each. `full`: the
// rows are 16-byte aligned multiples of 16 bytes, copied by cp.async; the
// row's 16-byte pieces past hd are not written (the caller zeroes them
// once where it reads them). Otherwise value by value, zeros past hd.
template <typename CT, int HD, int SL, int ROW>
__device__ __forceinline__ void gather_rows(unsigned char* dst,
                                            const CT* base, const int* idx,
                                            int j0, int nv,
                                            size_t slot_stride, int hd,
                                            bool full) {
  if (full) {
    constexpr int CPR = HD * (int)sizeof(CT) / 16;
    const int cpr = hd * (int)sizeof(CT) / 16;
    for (int c = threadIdx.x; c < SL * CPR; c += THREADS) {
      const int r = c / CPR, ch = c % CPR, jc = j0 + r;
      if (ch >= cpr) continue;
      const bool ok = jc < nv;
      const CT* src =
          base + (ok ? (size_t)idx[jc] * slot_stride : 0) + ch * (16 / sizeof(CT));
      cp_async16(dst + r * ROW + ch * 16, src, ok);
    }
    return;
  }
  using Raw =
      typename std::conditional<sizeof(CT) == 2, uint16_t, uint8_t>::type;
  const Raw* rb = reinterpret_cast<const Raw*>(base);
  for (int e = threadIdx.x; e < SL * HD; e += THREADS) {
    const int r = e / HD, d = e % HD, jc = j0 + r;
    Raw x = 0;
    if (jc < nv && d < hd) x = rb[(size_t)idx[jc] * slot_stride + d];
    reinterpret_cast<Raw*>(dst + r * ROW)[d] = x;
  }
}

// Bytes of a K row of HD dims (pass 1) and a V row of DS dims (pass 2) in
// the grouped route's rings: padded so that a warp's fragment loads meet
// no bank conflict.
template <typename CT, int HD>
constexpr int k_row_bytes = HD * (int)sizeof(CT) + (sizeof(CT) == 2 ? 64 : 32);
template <typename CT>
constexpr int v_row_bytes = DS * (int)sizeof(CT) + 16;

// Row `row` of the block's heads (q row row0 + row; zeros from row `rows`
// on, past G) as A-fragment words in the permuted order: for each 32-dim
// pair of k-steps p, lane t's 8 dims 32p + 8t .. 32p + 8t + 7 (zeros past
// hd).
template <int HD>
__device__ __forceinline__ void load_q_frag(const __nv_bfloat16* q,
                                            size_t row0, int row, int rows,
                                            const Shape& sh, int t,
                                            uint32_t (&w)[HD / 32][4]) {
  const bool in = row < rows;
  const __nv_bfloat16* qr = q + (row0 + row) * sh.hd;
  const bool vec = sh.hd % 8 == 0 && (uintptr_t)q % 16 == 0;
#pragma unroll
  for (int p = 0; p < HD / 32; ++p) {
    const int d0 = 32 * p + 8 * t;
    if (vec) {
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (in && d0 < sh.hd) x = __ldg(reinterpret_cast<const uint4*>(qr + d0));
      w[p][0] = x.x;
      w[p][1] = x.y;
      w[p][2] = x.z;
      w[p][3] = x.w;
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        uint32_t lo = 0u, hi = 0u;
        if (in && d0 + 2 * i < sh.hd)
          lo = __bfloat16_as_ushort(qr[d0 + 2 * i]);
        if (in && d0 + 2 * i + 1 < sh.hd)
          hi = __bfloat16_as_ushort(qr[d0 + 2 * i + 1]);
        w[p][i] = lo | (hi << 16);
      }
    }
  }
}

// Grouped pass 1. grid (splits, B * KV * NHG) with NHG = ceil(G / 16),
// THREADS threads; dynamic shared memory: the K ring (KSTAGES x KSL rows),
// the compacted slots (L ints), the scores (grouped_rows(G) x L floats),
// the listed slots' k_scale (L floats, int8).
template <typename CT, int HD>
__global__ void __launch_bounds__(THREADS)
grouped_scores_kernel(const __nv_bfloat16* __restrict__ q,
                      const CT* __restrict__ k,
                      const float* __restrict__ k_scale,
                      const long long* __restrict__ pos,
                      const long long* __restrict__ qpos,
                      int* __restrict__ vidx, float* __restrict__ scores,
                      float* __restrict__ stats, Shape sh, float scale,
                      int full) {
  constexpr bool QUANT = sizeof(CT) == 1;
  constexpr int KROW = k_row_bytes<CT, HD>, NP = HD / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_n[2 * WARPS];
  unsigned char* ring = smem_raw;
  int* idx = reinterpret_cast<int*>(ring + KSTAGES * KSL * KROW);  // [L]
  float* ss = reinterpret_cast<float*>(idx + sh.L);           // [rows][L]
  float* kss = ss + grouped_rows(sh.G) * sh.L;                 // [L]
  const int split = blockIdx.x, unit = blockIdx.y;
  const int bk = unit / sh.NHG, g0 = (unit % sh.NHG) * GG;
  const int b = bk / sh.KV, kv = bk % sh.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // rows g and g + 8 of Q (the block's heads g0 + g, g0 + g + 8)
  uint32_t qa[NP][4], qb[NP][4];
  load_q_frag<HD>(q, (size_t)bk * sh.G + g0, g, sh.G - g0, sh, t, qa);
  load_q_frag<HD>(q, (size_t)bk * sh.G + g0, g + 8, sh.G - g0, sh, t, qb);
  int n_in;
  const int nv = compact(sh, split, pos + (size_t)b * sh.T, qpos[b], false,
                         idx, warp_n, &n_in);
  if (kv == 0 && g0 == 0) {
    int* list = vidx + ((size_t)b * sh.splits + split) * sh.L;
    for (int j = threadIdx.x; j < nv; j += THREADS) list[j] = idx[j];
    if (threadIdx.x == 0)
      vidx[(size_t)sh.B * sh.splits * sh.L + (size_t)b * sh.splits + split] =
          nv;
  }
  // the ring's bytes past hd take no copy: zero them (they meet q's zeros)
  const bool whole = full != 0;
  if (whole && sh.hd < HD) {
    for (int i = threadIdx.x; i < KSTAGES * KSL * KROW / 16; i += THREADS)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();   // before any copy lands there
  }
  const size_t slot_stride = (size_t)sh.KV * sh.hd;
  const CT* kb = k + ((size_t)b * sh.T * sh.KV + kv) * sh.hd;
  float* sc = scores + ((size_t)unit * sh.splits + split) * GG * sh.L;
  const int nst = (nv + KSL - 1) / KSL;
#pragma unroll
  for (int s = 0; s < KSTAGES - 1; ++s) {
    if (s < nst)
      gather_rows<CT, HD, KSL, KROW>(ring + s * KSL * KROW, kb, idx, s * KSL,
                                     nv, slot_stride, sh.hd, whole);
    cp_async_commit();
  }
  // the listed slots' k_scale, loaded while the first K stages are in
  // flight (the loop's first barrier publishes them)
  if (QUANT)
    for (int j = threadIdx.x; j < nv; j += THREADS)
      kss[j] = k_scale[((size_t)b * sh.T + idx[j]) * sh.KV + kv];
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<KSTAGES - 2>();
    __syncthreads();
    const int nx = s + KSTAGES - 1;
    if (nx < nst)
      gather_rows<CT, HD, KSL, KROW>(ring + (nx % KSTAGES) * KSL * KROW, kb,
                                     idx, nx * KSL, nv, slot_stride, sh.hd,
                                     whole);
    cp_async_commit();
    const int j0 = s * KSL + warp * 8;
    if (j0 >= nv) continue;
    const unsigned char* row =
        ring + (s % KSTAGES) * KSL * KROW + (warp * 8 + g) * KROW;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      uint32_t w[4];
      if (QUANT) {
        const uint2 x = *reinterpret_cast<const uint2*>(row + 32 * p + 8 * t);
        w[0] = bf16x2(sbyte(x.x, 0), sbyte(x.x, 1));
        w[1] = bf16x2(sbyte(x.x, 2), sbyte(x.x, 3));
        w[2] = bf16x2(sbyte(x.y, 0), sbyte(x.y, 1));
        w[3] = bf16x2(sbyte(x.y, 2), sbyte(x.y, 3));
      } else {
        const uint4 x =
            *reinterpret_cast<const uint4*>(row + 2 * (32 * p + 8 * t));
        w[0] = x.x;
        w[1] = x.y;
        w[2] = x.z;
        w[3] = x.w;
      }
      // each k-step's 16 products summed by the tensor core from zero, the
      // k-steps added in IEEE float32 (summing into a running accumulator
      // inside the tensor core truncates the small products' low bits)
      float d0[4] = {0.f, 0.f, 0.f, 0.f}, d1[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d0, qa[p][0], qb[p][0], qa[p][1], qb[p][1], w[0], w[1]);
      mma_bf16(d1, qa[p][2], qb[p][2], qa[p][3], qb[p][3], w[2], w[3]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[c] = __fadd_rn(__fadd_rn(acc[c], d0[c]), d1[c]);
    }
    // acc: heads g, g + 8 x slots j0 + 2t, j0 + 2t + 1
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int gi = g + (c >= 2 ? 8 : 0), jc = j0 + 2 * t + (c & 1);
      if (jc >= nv || g0 + gi >= sh.G) continue;
      float sv = acc[c];
      if (QUANT) sv = __fmul_rn(sv, kss[jc]);
      sv = __fdiv_rn(sv, scale);
      ss[gi * sh.L + jc] = sv;
      sc[gi * sh.L + jc] = sv;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // the split's max and sum of each head, a warp a head
  for (int h = warp; h < GG; h += WARPS) {
    if (g0 + h >= sh.G) break;
    const float* sg = ss + h * sh.L;
    float m = NEG_INF;
    for (int j = lane; j < nv; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < nv; j += 32) l += expf(sg[j] - m);
    l = warp_sum(l);
    // no slot visible: every candidate's exp(NEG_INF - NEG_INF) is 1
    if (nv == 0) l = (float)n_in;
    if (lane == 0) {
      const size_t at = ((size_t)unit * GG + h) * sh.splits + split;
      stats[at] = m;
      stats[(size_t)sh.B * sh.KV * sh.NHG * GG * sh.splits + at] = l;
    }
  }
}

// Grouped pass 2. grid (splits, B * KV * NHG * HD / DS): a block owns DS
// head dims of its unit's heads (a warp 8 of them), so the blocks of a
// unit fold their partials in parallel, DS dims each. THREADS threads;
// dynamic shared memory: the V ring (VSTAGES x VSL rows of the DS dims),
// the listed slots (L ints), the split's scores (R x L floats, R =
// grouped_rows(G): no row for a head past G), P (R x (L + 8) bf16; the
// mma's rows from R on are zeros in registers), the heads' split
// statistics (2 x GG x splits floats), the listed slots' v_scale (L
// floats, int8). The scores, the statistics and the slot list are read at
// once, the first V stages issued before the v_scale loads and P.
template <typename CT, int HD>
__global__ void __launch_bounds__(THREADS)
grouped_values_kernel(const CT* __restrict__ v,
                      const float* __restrict__ v_scale,
                      const long long* __restrict__ pos,
                      const long long* __restrict__ qpos,
                      const int* __restrict__ vidx,
                      const float* __restrict__ scores,
                      const float* __restrict__ stats,
                      float* __restrict__ part,
                      unsigned* __restrict__ arrivals,
                      __nv_bfloat16* __restrict__ out, Shape sh, int full) {
  constexpr bool QUANT = sizeof(CT) == 1;
  constexpr int VROW = v_row_bytes<CT>, NDB = HD / DS;
  static_assert(DS == 8 * WARPS, "a warp owns 8 of the block's dims");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int warp_n[2 * WARPS];
  __shared__ float ml[2 * GG];
  __shared__ int last;
  unsigned char* ring = smem_raw;
  int* idx = reinterpret_cast<int*>(ring + VSTAGES * VSL * VROW);   // [L]
  const int R = grouped_rows(sh.G);
  float* ssc = reinterpret_cast<float*>(idx + sh.L);              // [R][L]
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(ssc + R * sh.L);
  const int prow = sh.L + 8;                                      // [R][prow]
  float* sts = reinterpret_cast<float*>(P + R * prow);   // [2][GG][splits]
  float* vss = sts + 2 * GG * sh.splits;                          // [L]
  const int split = blockIdx.x, unit = blockIdx.y / NDB;
  const int db = blockIdx.y % NDB, slice = blockIdx.y;
  // the block's dims db * DS .. db * DS + width - 1
  const int width = sh.hd - db * DS < DS ? sh.hd - db * DS : DS;
  if (width <= 0) return;
  const int bk = unit / sh.NHG, g0 = (unit % sh.NHG) * GG;
  const int b = bk / sh.KV, kv = bk % sh.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t n_stats = (size_t)sh.B * sh.KV * sh.NHG * GG * sh.splits;
  // the unit's heads (fewer than R only in the last of ceil(G / GG) units)
  const int rows = sh.G - g0 < GG ? sh.G - g0 : GG;
  // 1. the split's scores of those heads (cp.async, a group of its own),
  // the heads' split statistics and the slot list, all in flight together
  const float* sc = scores + ((size_t)unit * sh.splits + split) * GG * sh.L;
  for (int c = threadIdx.x; c < rows * sh.L / 4; c += THREADS)
    cp_async16(ssc + 4 * c, sc + 4 * c, true);
  cp_async_commit();
  const int n_st = GG * sh.splits;
  const float* st = stats + (size_t)unit * n_st;
  for (int i = threadIdx.x; i < n_st; i += THREADS) {
    sts[i] = st[i];
    sts[n_st + i] = st[n_stats + i];
  }
  int nv = vidx[(size_t)sh.B * sh.splits * sh.L + (size_t)b * sh.splits +
                split];
  const int* list = vidx + ((size_t)b * sh.splits + split) * sh.L;
  for (int j = threadIdx.x; j < nv; j += THREADS) idx[j] = list[j];
  __syncthreads();
  // 2. the first V stages (a row that sees no slot restarts them below)
  const bool whole = full != 0;
  const size_t slot_stride = (size_t)sh.KV * sh.hd;
  const CT* vb = v + ((size_t)b * sh.T * sh.KV + kv) * sh.hd + db * DS;
  auto prologue = [&](int n) {
    const int nst = (n + VSL - 1) / VSL;
#pragma unroll
    for (int s = 0; s < VSTAGES - 1; ++s) {
      if (s < nst)
        gather_rows<CT, DS, VSL, VROW>(ring + s * VSL * VROW, vb, idx,
                                       s * VSL, n, slot_stride, width, whole);
      cp_async_commit();
    }
  };
  // the listed slots' v_scale, loaded while the V stages are in flight
  auto scales = [&](int n) {
    if (QUANT)
      for (int j = threadIdx.x; j < n; j += THREADS)
        vss[j] = v_scale[((size_t)b * sh.T + idx[j]) * sh.KV + kv];
  };
  prologue(nv);
  scales(nv);
  // 3. the row's m = max m_s and l = sum l_s exp(m_s - m), in split order
  if (threadIdx.x < GG) {
    const int gi = threadIdx.x;
    float m = NEG_INF, l = 1.f;
    if (g0 + gi < sh.G) {
      const float* ms = sts + gi * sh.splits;
      const float* ls = ms + n_st;
      l = 0.f;
      for (int s = 0; s < sh.splits; ++s) m = fmaxf(m, ms[s]);
      for (int s = 0; s < sh.splits; ++s)
        l = __fadd_rn(l, __fmul_rn(ls[s], expf(ms[s] - m)));
    }
    ml[gi] = m;
    ml[GG + gi] = l;
  }
  __syncthreads();
  // no slot of row b visible: p = 1 / l on every slot of the row, which
  // lists every slot of the split
  const bool dead = ml[0] == NEG_INF;
  if (dead) {
    cp_async_wait<0>();
    __syncthreads();
    int n_in;
    nv = compact(sh, split, pos + (size_t)b * sh.T, qpos[b], true, idx,
                 warp_n, &n_in);
    prologue(nv);
    scales(nv);
  }
  // 4. P, rounded to bf16, from the scores (their group done: the V stages
  // were committed after it)
  cp_async_wait<VSTAGES - 1>();
  __syncthreads();
  const int nvp = (nv + 15) & ~15;
  for (int i = threadIdx.x; i < R * nvp; i += THREADS) {
    const int gi = i / nvp, jc = i % nvp;
    float p = 0.f;
    if (jc < nv && gi < rows) {
      const float s = dead ? NEG_INF : ssc[gi * sh.L + jc];
      p = __fdiv_rn(expf(s - ml[gi]), ml[GG + gi]);
      if (QUANT) p = __fmul_rn(p, vss[jc]);
    }
    P[gi * prow + jc] = __float2bfloat16_rn(p);
  }
  // 5. O = P V over the ring: each k-step's 16 products summed by the
  // tensor core from zero, the k-steps added in IEEE float32
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  const int n0 = warp * 8;
  const int nst = (nv + VSL - 1) / VSL;
  for (int s = 0; s < nst; ++s) {
    cp_async_wait<VSTAGES - 2>();
    __syncthreads();
    const int nx = s + VSTAGES - 1;
    if (nx < nst)
      gather_rows<CT, DS, VSL, VROW>(ring + (nx % VSTAGES) * VSL * VROW, vb,
                                     idx, nx * VSL, nv, slot_stride, width,
                                     whole);
    cp_async_commit();
    const unsigned char* buf = ring + (s % VSTAGES) * VSL * VROW;
#pragma unroll
    for (int kk = 0; kk < VSL / 16; ++kk) {
      const int k0 = s * VSL + kk * 16;
      if (k0 >= nv) break;
      const __nv_bfloat16* pa = P + g * prow + k0 + 2 * t;
      const __nv_bfloat16* pb = pa + 8 * prow;
      const uint32_t a0 = g < R ? *reinterpret_cast<const uint32_t*>(pa) : 0u;
      const uint32_t a1 =
          g + 8 < R ? *reinterpret_cast<const uint32_t*>(pb) : 0u;
      const uint32_t a2 =
          g < R ? *reinterpret_cast<const uint32_t*>(pa + 8) : 0u;
      const uint32_t a3 =
          g + 8 < R ? *reinterpret_cast<const uint32_t*>(pb + 8) : 0u;
      const unsigned char* rows = buf + kk * 16 * VROW;
      uint32_t b0, b1;
      if (QUANT) {
        const int8_t* r = reinterpret_cast<const int8_t*>(rows) + n0 + g;
        b0 = bf16x2((float)r[(2 * t) * VROW], (float)r[(2 * t + 1) * VROW]);
        b1 = bf16x2((float)r[(2 * t + 8) * VROW],
                    (float)r[(2 * t + 9) * VROW]);
      } else {
        ldsm_x2_trans(b0, b1, rows + (lane & 15) * VROW + 2 * n0);
      }
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(d, a0, a1, a2, a3, b0, b1);
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = __fadd_rn(acc[c], d[c]);
    }
  }
  cp_async_wait<0>();
  // the split's partial o of the block's dims: heads g, g + 8 x dims n0 +
  // 2t, n0 + 2t + 1 (those past hd hold what the rows' unwritten bytes
  // gave, and are dropped)
  float* pp = part + (size_t)slice * sh.splits * GG * DS;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int gi = g + (c >= 2 ? 8 : 0), d = n0 + 2 * t + (c & 1);
    pp[((size_t)split * GG + gi) * DS + d] = acc[c];
  }
  // the last block of the slice to arrive adds the partials in split order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ticket = atomicAdd(arrivals + slice, 1u);
    last = ticket == (unsigned)sh.splits - 1u;
    if (last) arrivals[slice] = 0u;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // heads past G carry P's zero rows: folded and dropped
  fold_splits(
      pp, (size_t)GG * DS, rows * DS, DS, sh.splits, THREADS,
      [](int, int) { return 1.f; },
      [&](int i, float o) {
        const int d = db * DS + i % DS;
        if (d < sh.hd)
          out[((size_t)bk * sh.G + g0 + i / DS) * sh.hd + d] =
              __float2bfloat16_rn(o);
      });
}

// The cross route, one launch. grid (splits, B * KV * NHG) with NHG =
// ceil(G / 4), THREADS threads; dynamic shared memory: the split's V rows
// (L x HD values of CT; the warps' partial sums, WARPS x GH x HD floats,
// reuse it after the product), p (GH x L floats), then the folding
// block's split statistics and weights (2 x GH x splits floats).
template <typename CT, int HD>
__global__ void __launch_bounds__(THREADS, 2)
cross_kernel(const CT* __restrict__ q, const CT* __restrict__ k,
             const CT* __restrict__ v, float* __restrict__ stats,
             float* __restrict__ part, unsigned* __restrict__ arrivals,
             CT* __restrict__ out, Shape sh, float scale, int full_k,
             int full_v) {
  using Lo = Layout<CT, HD>;
  constexpr int DPL = Lo::DPL, R = Lo::R, NS = Lo::NS, U = Lo::U,
                W = Lo::W;
  constexpr int VB = HD * (int)sizeof(CT);       // bytes a staged V row
  constexpr int RED = WARPS * GH * HD * 4;        // bytes of the warps' sums
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float l_row[GH];
  __shared__ int last;
  unsigned char* vs = smem_raw;                   // [L][HD] CT, then red
  float* red = reinterpret_cast<float*>(smem_raw);
  const int vbytes = sh.L * VB > RED ? sh.L * VB : RED;
  float* ss = reinterpret_cast<float*>(smem_raw + vbytes);   // [GH][L]
  float* wts = ss + GH * sh.L;             // [GH][splits]: m_s, then w_s
  float* lsm = wts + GH * sh.splits;       // [GH][splits]: l_s
  const int split = blockIdx.x, unit = blockIdx.y;
  const int bk = unit / sh.NHG, g0 = (unit % sh.NHG) * GH;
  const int b = bk / sh.KV, kv = bk % sh.KV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r = lane % R, d0 = r * DPL;
  // the split's slots inside T: a prefix of its candidates
  int n_in = 0;
  for (int c = 0; c < sh.L / CHUNK; ++c) {
    const int left = sh.T - (split + c * sh.splits) * CHUNK;
    n_in += left <= 0 ? 0 : (left < CHUNK ? left : CHUNK);
  }
  const size_t slot_stride = (size_t)sh.KV * sh.hd;
  const CT* kb = k + ((size_t)b * sh.T * sh.KV + kv) * sh.hd;
  const CT* vb = v + ((size_t)b * sh.T * sh.KV + kv) * sh.hd;
  // 1. V into shared memory, in flight while the scores are formed
  if (full_v) {
    constexpr int CPR = VB / 16;
    const int cpr = sh.hd * (int)sizeof(CT) / 16;
    for (int c = threadIdx.x; c < n_in * CPR; c += THREADS) {
      const int j = c / CPR, ch = c % CPR;
      if (ch < cpr)
        cp_async16(vs + j * VB + ch * 16,
                   vb + (size_t)slot_of(sh, split, j) * slot_stride +
                       ch * (16 / sizeof(CT)),
                   true);
    }
  } else {
    for (int e = threadIdx.x; e < n_in * HD; e += THREADS) {
      const int j = e / HD, d = e % HD;
      reinterpret_cast<CT*>(vs + j * VB)[d] =
          d < sh.hd ? vb[(size_t)slot_of(sh, split, j) * slot_stride + d]
                    : CT(0.f);
    }
  }
  cp_async_commit();
  // 2. the scores of the block's heads, in shared memory only
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
  const bool whole = full_k != 0;
  const int stream = warp * NS + lane / R;
  constexpr int NSTR = WARPS * NS;
  const int hw = head_of<R>(r);
  for (int base = 0; base < n_in; base += NSTR * U) {
    uint32_t raw[U][W];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int jc = base + u * NSTR + stream;
      if (jc < n_in) {
        load_dims<CT, DPL, W>(kb + (size_t)slot_of(sh, split, jc) * slot_stride,
                              d0, sh.hd, whole, raw[u]);
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
      if (jc < n_in && head_writer<R>(r)) {
#pragma unroll
        for (int c = 0; c < (R < 4 ? 2 : 1); ++c) {
          const int gi = hw + c;
          if (g0 + gi < sh.G) ss[gi * sh.L + jc] = __fmul_rn(acc[c], scale);
        }
      }
    }
  }
  __syncthreads();
  // 3. m_s, p = exp(s - m_s) in place, l_s = sum p; a warp a head
  if (warp < GH && g0 + warp < sh.G) {
    float* sg = ss + warp * sh.L;
    float m = NEG_INF;
    for (int j = lane; j < n_in; j += 32) m = fmaxf(m, sg[j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n_in; j += 32) {
      const float e = expf(sg[j] - m);
      sg[j] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      const size_t at = ((size_t)unit * GH + warp) * sh.splits + split;
      stats[at] = m;
      stats[(size_t)sh.B * sh.KV * sh.NHG * GH * sh.splits + at] = l;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  // 4. o_s = sum p v from shared memory, unnormalised
  float acc[GH][DPL];
#pragma unroll
  for (int gi = 0; gi < GH; ++gi)
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[gi][e] = 0.f;
#pragma unroll 4
  for (int jc = stream; jc < n_in; jc += NSTR) {
    uint32_t raw[W];
    const uint4* src = reinterpret_cast<const uint4*>(vs + jc * VB +
                                                      d0 * (int)sizeof(CT));
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 x = src[i];
      raw[4 * i] = x.x;
      raw[4 * i + 1] = x.y;
      raw[4 * i + 2] = x.z;
      raw[4 * i + 3] = x.w;
    }
#pragma unroll
    for (int gi = 0; gi < GH; ++gi) {
      const float p = ss[gi * sh.L + jc];
#pragma unroll
      for (int e = 0; e < DPL; ++e)
        acc[gi][e] = fmaf(p, elem<CT>(raw, e), acc[gi][e]);
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
  __syncthreads();   // every warp is done with the staged V
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
  // 5. the last block of the unit to arrive folds the splits in order
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
  // the heads' (m_s, l_s) into shared memory at once; then m = max m_s,
  // w_s = exp(m_s - m) and l = sum l_s w_s in split order
  const size_t n_stats = (size_t)sh.B * sh.KV * sh.NHG * GH * sh.splits;
  const int n_st = GH * sh.splits;
  const float* st = stats + (size_t)unit * n_st;
  for (int i = threadIdx.x; i < n_st; i += THREADS) {
    wts[i] = __ldcg(st + i);
    lsm[i] = __ldcg(st + n_stats + i);
  }
  __syncthreads();
  if (threadIdx.x < GH) {
    float* w = wts + threadIdx.x * sh.splits;
    const float* ls = lsm + threadIdx.x * sh.splits;
    float m = NEG_INF, l = 0.f;
    for (int s = 0; s < sh.splits; ++s) m = fmaxf(m, w[s]);
    for (int s = 0; s < sh.splits; ++s) {
      w[s] = expf(w[s] - m);
      l = __fadd_rn(l, __fmul_rn(ls[s], w[s]));
    }
    l_row[threadIdx.x] = l;
  }
  __syncthreads();
  // o = (sum w_s o_s) / l; heads past G are folded and dropped
  const int rows = sh.G - g0 < GH ? sh.G - g0 : GH;
  const int hd = sh.hd, splits = sh.splits;
  fold_splits(
      pp, (size_t)GH * hd, rows * hd, hd, splits, THREADS,
      [&](int s, int i) { return wts[(i / hd) * splits + s]; },
      [&](int i, float o) {
        store(out + ((size_t)bk * sh.G + g0) * hd + i,
              __fdiv_rn(o, l_row[i / hd]));
      });
}

// ---------------------------------------------------------------------------
// Launchers

template <typename QT, typename CT, int HD>
int launch_split(const void* q, const void* k, const void* v,
                 const float* ks, const float* vs, const long long* pos,
                 const long long* qpos, void* out, float* scores,
                 float* stats, float* part, int* vidx, unsigned* arrivals,
                 Shape sh, float scale, cudaStream_t stream) {
  const int full = sh.hd == HD && (uintptr_t)k % 16 == 0 &&
                   (uintptr_t)v % 16 == 0;
  const size_t smem1 = sizeof(int) * sh.L + sizeof(float) * GH * sh.L;
  const size_t smem2 = smem1 + sizeof(float) * WARPS * GH * HD;
  cudaError_t err = cudaFuncSetAttribute(
      scores_kernel<QT, CT, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(values_kernel<QT, CT, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.splits, sh.B * sh.KV * sh.NHG);
  scores_kernel<QT, CT, HD><<<grid, THREADS, smem1, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), ks, pos, qpos,
      vidx, scores, stats, sh, scale, full);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  values_kernel<QT, CT, HD><<<grid, THREADS, smem2, stream>>>(
      static_cast<const CT*>(v), vs, pos, qpos, vidx, scores, stats, part,
      arrivals, static_cast<QT*>(out), sh, full);
  return (int)cudaGetLastError();
}

template <typename CT, int HD>
int launch_grouped(const void* q, const void* k, const void* v,
                   const float* ks, const float* vs, const long long* pos,
                   const long long* qpos, void* out, float* scores,
                   float* stats, float* part, int* vidx, unsigned* arrivals,
                   Shape sh, float scale, cudaStream_t stream) {
  const int full = sh.hd * (int)sizeof(CT) % 16 == 0 &&
                   (uintptr_t)k % 16 == 0 && (uintptr_t)v % 16 == 0;
  const size_t R = grouped_rows(sh.G);
  const size_t scale_bytes = sizeof(CT) == 1 ? sizeof(float) * sh.L : 0;
  const size_t smem1 = (size_t)KSTAGES * KSL * k_row_bytes<CT, HD> +
                       sizeof(int) * sh.L + sizeof(float) * R * sh.L +
                       scale_bytes;
  const size_t smem2 = (size_t)VSTAGES * VSL * v_row_bytes<CT> +
                       sizeof(int) * sh.L + sizeof(float) * R * sh.L +
                       2 * R * (sh.L + 8) +
                       2 * sizeof(float) * GG * sh.splits + scale_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_scores_kernel<CT, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(grouped_values_kernel<CT, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.splits, sh.B * sh.KV * sh.NHG);
  grouped_scores_kernel<CT, HD><<<grid, THREADS, smem1, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const CT*>(k), ks,
      pos, qpos, vidx, scores, stats, sh, scale, full);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid2(sh.splits, sh.B * sh.KV * sh.NHG * (HD / DS));
  grouped_values_kernel<CT, HD><<<grid2, THREADS, smem2, stream>>>(
      static_cast<const CT*>(v), vs, pos, qpos, vidx, scores, stats, part,
      arrivals, static_cast<__nv_bfloat16*>(out), sh, full);
  return (int)cudaGetLastError();
}

template <typename CT, int HD>
int launch_cross(const void* q, const void* k, const void* v, void* out,
                 float* stats, float* part, unsigned* arrivals, Shape sh,
                 float scale, cudaStream_t stream) {
  const int full_k = sh.hd == HD && (uintptr_t)k % 16 == 0;
  const int full_v = sh.hd * (int)sizeof(CT) % 16 == 0 &&
                     (uintptr_t)v % 16 == 0;
  const size_t vb = (size_t)sh.L * HD * sizeof(CT);
  const size_t red = sizeof(float) * WARPS * GH * HD;
  const size_t smem = (vb > red ? vb : red) + sizeof(float) * GH * sh.L +
                      2 * sizeof(float) * GH * sh.splits;
  cudaError_t err = cudaFuncSetAttribute(
      cross_kernel<CT, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(sh.splits, sh.B * sh.KV * sh.NHG);
  cross_kernel<CT, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const CT*>(q), static_cast<const CT*>(k),
      static_cast<const CT*>(v), stats, part, arrivals, static_cast<CT*>(out),
      sh, scale, full_k, full_v);
  return (int)cudaGetLastError();
}

struct Args {
  const void *q, *k, *v;
  const float *ks, *vs;
  const long long *pos, *qpos;
  void* out;
  float *scores, *stats, *part;
  int* vidx;
  unsigned* arrivals;
  float scale;
  cudaStream_t st;
};

template <int HD>
int by_route(int route, int is_bf16, int cache_type, const Args& a,
             const Shape& sh) {
  if (route == 2) {   // cross
    if (is_bf16)
      return launch_cross<__nv_bfloat16, HD>(a.q, a.k, a.v, a.out, a.stats,
                                             a.part, a.arrivals, sh, a.scale,
                                             a.st);
    return launch_cross<float, HD>(a.q, a.k, a.v, a.out, a.stats, a.part,
                                   a.arrivals, sh, a.scale, a.st);
  }
  if (route == 1) {   // grouped: a bf16 q on the bf16 or int8 cache
    if (cache_type == 1)
      return launch_grouped<__nv_bfloat16, (HD < 64 ? 64 : HD)>(
          a.q, a.k, a.v, a.ks, a.vs, a.pos, a.qpos, a.out, a.scores, a.stats,
          a.part, a.vidx, a.arrivals, sh, a.scale, a.st);
    return launch_grouped<int8_t, (HD < 64 ? 64 : HD)>(
        a.q, a.k, a.v, a.ks, a.vs, a.pos, a.qpos, a.out, a.scores, a.stats,
        a.part, a.vidx, a.arrivals, sh, a.scale, a.st);
  }
#define SPLIT(QT, CT)                                                        \
  launch_split<QT, CT, HD>(a.q, a.k, a.v, a.ks, a.vs, a.pos, a.qpos, a.out,  \
                           a.scores, a.stats, a.part, a.vidx, a.arrivals, sh, \
                           a.scale, a.st)
  if (!is_bf16 && cache_type == 0) return SPLIT(float, float);
  if (is_bf16 && cache_type == 1) return SPLIT(__nv_bfloat16, __nv_bfloat16);
  if (!is_bf16 && cache_type == 2) return SPLIT(float, int8_t);
  return SPLIT(__nv_bfloat16, int8_t);
#undef SPLIT
}

}  // namespace

// Launches the route's kernels on `stream` (PyTorch's current stream);
// returns the first CUDA error (cudaFuncSetAttribute or a refused launch)
// so the Python wrapper can raise. q (B, 1, H, hd) and out contiguous in
// q's type (float32, is_bf16 = 0, or bfloat16); k, v (B, T, KV, hd)
// contiguous in the cache's type (cache_type 0 float32 = q's, 1 bfloat16 =
// q's, 2 int8 with k_scale, v_scale (B, T, KV) float32); pos (B, T) and
// qpos (B) int64; the scores divided by `scale` (sqrt(hd) in float32).
// route 0: the split route, 1: the grouped route (a bf16 q on the bf16 or
// int8 cache), 2: the cross route (float32 or bfloat16 caches of q's type;
// pos and qpos null, every slot visible, the scores multiplied by `scale`,
// float32(1 / sqrt(hd)), p not rounded). `heads` query heads a block (4,
// or 16 on the grouped route): NHG = ceil(G / heads). splits splits of L
// candidate slots (kernels/decode_attention.py `split_len`). Scratch from
// the wrapper, U = B * KV * NHG blocks a split: scores U*splits*heads*L
// and stats 2*U*heads*splits floats, vidx B*splits*(L + 1) ints (neither
// read on the cross route), part U*splits*heads*hd floats; arrivals U
// unsigned ints, zero before the first launch (each launch leaves them
// zero).
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* k_scale,
    const void* v_scale, const void* pos, const void* qpos, void* out,
    void* scores, void* stats, void* part, void* vidx, void* arrivals, int B,
    int T, int KV, int G, int hd, int window, int splits, int L,
    float scale, int is_bf16, int cache_type, int route, void* stream) {
  if (B == 0 || T == 0 || KV == 0 || G == 0) return 0;
  if (L <= 0 || L % CHUNK || splits <= 0 ||
      (long long)splits * (L / CHUNK) * CHUNK < T || hd <= 0 ||
      hd > 256 || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  const int heads = route == 1 ? GG : GH;
  const Shape sh{B, T, KV, G, hd, L, splits, window, (G + heads - 1) / heads};
  const Args a{q, k, v,
               static_cast<const float*>(k_scale),
               static_cast<const float*>(v_scale),
               static_cast<const long long*>(pos),
               static_cast<const long long*>(qpos), out,
               static_cast<float*>(scores), static_cast<float*>(stats),
               static_cast<float*>(part), static_cast<int*>(vidx),
               static_cast<unsigned*>(arrivals), scale,
               (cudaStream_t)stream};
  if (cache_type < 0 || cache_type > 2 || (is_bf16 && cache_type == 0) ||
      (!is_bf16 && cache_type == 1))
    return (int)cudaErrorInvalidValue;
  if (cache_type == 2 && (a.ks == nullptr || a.vs == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((a.pos == nullptr) != (a.qpos == nullptr) ||
      (a.pos == nullptr) != (route == 2) || (route == 2 && cache_type == 2) ||
      (route == 1 && !is_bf16))
    return (int)cudaErrorInvalidValue;
  if (hd <= 32) return by_route<32>(route, is_bf16, cache_type, a, sh);
  if (hd <= 64) return by_route<64>(route, is_bf16, cache_type, a, sh);
  if (hd <= 128) return by_route<128>(route, is_bf16, cache_type, a, sh);
  return by_route<256>(route, is_bf16, cache_type, a, sh);
}
