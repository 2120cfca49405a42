// The mLSTM scan's gradient, for Hopper (sm_90a).
//
// Replaces JAX's autodiff of the reference's `lax.scan` over `_mlstm_cell`
// in `mlstm_sequence` (src/repro/models/recurrent.py:101-125; the JAX
// package has no Pallas kernel there). The forward is csrc/mlstm_scan.cu:
// for every batch row b and head, from the state C (HD x HD), n (HD), m,
//   log_f = -softplus(-f),  m' = max(log_f + m, i),
//   i_g = exp(i - m'),  f_g = exp((log_f + m) - m'),
//   C' = f_g C + i_g (v k^T),  n' = f_g n + i_g k,
//   s = n' . q,  h = (C' q) / max(|s|, 1).
// Given the output gradient dh (B, S, H, HD), this computes dq, dk, dv
// (B, S, H, HD) and d i_pre, d f_pre (B, S, H), float32, in the steps of
// `mlstm_scan_backward_plain` (kernels/mlstm_scan.py), with
// dnum_t = dh_t (1 / den_t), G_t = dL/dC_t = dnum_t q_t^T + f_{t+1} G_{t+1},
// dN_t = dL/dn_t = ds_t q_t + f_{t+1} dN_{t+1}:
//   dq = C_t^T dnum + ds n_t,  dk = i_g (G^T v + dN),  dv = i_g G k,
//   DI = i_g (v^T G k + dN . k),  DF = Q_t + f_g dN . n_{t-1},
// where Q_t = f_g <G_t, C_{t-1}> comes from the scalar recurrence
// Q_t = hh_t + Q_{t+1} - i_g v^T G_t k_t (<G_t, C_t> taken two ways;
// hh_t = q_t . C_t^T dnum_t), so no launch needs C in reverse (Q_t = 0
// where f_g is exactly 0, as at the first step from the zero state); then the
// gates' reverse chain through the stabiliser (a tie of log_f + m and i
// splits its gradient half and half, as jnp.maximum's; so does
// max(|s|, 1) at |s| == 1).
//
// Design: five launches, no atomics (two launches are bitwise equal).
// 1. prep, a block a (b, head): warp 0 walks the stabiliser's chain 32
//    steps at a time (as the forward's producer) and writes each step's
//    (i_g, f_g, tie weight, sigmoid(-f)); then a thread a column walks
//    n_t (stored, B x S x H x HD) and the block sums s_t = n_t . q_t (its
//    16 warps' partial sums in order), writing (1 / den_t, d den/ds).
// 2-4. one rank-1 scan, three ways. A block owns ROWS = 16 rows of an
//    HD x HD matrix X of one (b, head), 4 rows a warp, lane l its columns
//    l, l + 32, ... in registers (the forward's split); each step
//    X = a X + b u w^T and each lane's share of out = X y, summed after a
//    chunk of CHUNK steps (a tree a lane: row r at step u on lane
//    RW u + r, as the forward's), optionally with the block's sum of
//    z . out a step. The step inputs come through a two-stage
//    shared-memory ring of CHUNK steps by cp.async.
//      mode 0, forward: X = C^T from the state (C's bits: the forward's
//        rounding), u = k, w = v, y = dnum: out = C^T dnum, z = q (hh);
//      mode 1, reverse: X = G, a = f_{t+1}, u = dnum, w = q, y = k:
//        out = G k, z = v (v^T G k);
//      mode 2, reverse: X = G^T, u = q, w = dnum, y = v: out = G^T v.
// 5. combine, a block a (b, head): the per-block sums added in block
//    order; dN in reverse a thread a column, dq, dk, dv in place of the
//    scans' outputs and the block's sums of dN . k and dN . n_{t-1}; then
//    warp 0 walks Q and the gates' chain in reverse, 32 steps at a time.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): operations. At
// (B, S, H, HD) = (1, 4096, 4, 512) the function needs ~8 FP32
// instructions an element of C a step (C again 2, G's update 2, dq, dk, dv
// and <G, C> one FMA each): 8.6 G, 0.26 ms a G at one instruction a lane
// and clock (33.4 T/s), ~1.0 ms; q, k, v, dh in and dq, dk, dv out are
// 235 MB, 0.07 ms at 3.35 TB/s. This design issues ~11 (C again in the
// forward's unfused rounding 4, G twice 2 each, three row-sum FMAs) plus
// the ring, the shuffles and launches 1 and 5, which walk S steps with
// B x H blocks.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;          // warps a scan block
constexpr int RW = 4;             // rows of X a warp
constexpr int ROWS = WARPS * RW;  // rows of X a block
constexpr int CHUNK = 8;          // steps a stage of the scan's ring
constexpr int STAGES = 2;
constexpr int VT = 512;           // threads of prep and combine: a column
constexpr int VW = VT / 32;       // their warps
constexpr int U = 8;              // steps prep loads at once
constexpr int UC = 4;             // steps combine loads at once
constexpr int MAX_DEVICES = 64;

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), as torch's logaddexp
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// the share of a max's gradient that goes to its first operand, for
// d = first - second: 1, one half at a tie, 0
__device__ __forceinline__ float tie_weight(float d) {
  return d > 0.f ? 1.f : (d == 0.f ? 0.5f : 0.f);
}

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
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// 1. prep: the gates, n_t, 1 / den_t and d den / ds
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(VT)
mlstm_bwd_prep_kernel(const float* __restrict__ q,
                      const float* __restrict__ k,
                      const float* __restrict__ ip,
                      const float* __restrict__ fp,
                      const float* __restrict__ n0,
                      const float* __restrict__ m0,
                      float4* __restrict__ gate, float2* __restrict__ sc,
                      float* __restrict__ nall, int S, int H) {
  const int bh = blockIdx.x, b = bh / H, head = bh % H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  if (warp == 0) {
    // lane s of a batch takes step t0 + s; only the m chain runs in order
    float m_reg = m0[bh];
    for (int t0 = 0; t0 < S; t0 += 32) {
      const int t = t0 + lane;
      const size_t g = ((size_t)b * S + t) * H + head;
      const float xi = t < S ? ip[g] : 0.f, xf = t < S ? fp[g] : 0.f;
      const float log_f = -softplus(-xf);
      const int valid = S - t0 < 32 ? S - t0 : 32;
      float my_lfm = 0.f;
      for (int s = 0; s < valid; ++s) {
        const float lfm = __fadd_rn(__shfl_sync(FULL, log_f, s), m_reg);
        m_reg = fmaxf(lfm, __shfl_sync(FULL, xi, s));
        if (lane == s) my_lfm = lfm;
      }
      if (t < S) {
        const float d = __fsub_rn(my_lfm, xi);
        const float e = expf(-fabsf(d));
        gate[g] = make_float4(d > 0.f ? e : 1.f, d > 0.f ? 1.f : e,
                              tie_weight(d),
                              __fdiv_rn(1.f, __fadd_rn(1.f, expf(xf))));
      }
    }
  }
  __syncthreads();  // the gates are visible to the block
  __shared__ float red[2][U][VW];
  const int j = threadIdx.x;
  const bool on = j < HD;
  const int jc = on ? j : 0;  // a valid column for the loads of idle threads
  float n = on ? n0[(size_t)bh * HD + j] : 0.f;
  // every load of a batch is unconditional (steps past S read step S - 1)
  // and issued before its arithmetic; k and q a batch ahead
  float kc[U], qc[U], kn[U], qn[U];
  auto load = [&](int t0, float (&kk)[U], float (&qq)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u < S ? t0 + u : S - 1;
      const size_t at = (((size_t)b * S + t) * H + head) * HD + jc;
      kk[u] = k[at];
      qq[u] = q[at];
    }
  };
  load(0, kc, qc);
  int par = 0;
  for (int t0 = 0; t0 < S; t0 += U) {
    const int steps = S - t0 < U ? S - t0 : U;
    float gi[U], gf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u < S ? t0 + u : S - 1;
      const float4 gt = gate[((size_t)b * S + t) * H + head];
      gi[u] = gt.x;
      gf[u] = gt.y;
    }
    load(t0 + U < S ? t0 + U : t0, kn, qn);
    float ps[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ps[u] = 0.f;
      if (u < steps) {
        n = __fadd_rn(__fmul_rn(gf[u], n), __fmul_rn(gi[u], kc[u]));
        if (on) nall[(((size_t)b * S + t0 + u) * H + head) * HD + j] = n;
        ps[u] = on ? n * qc[u] : 0.f;
      }
    }
#pragma unroll
    for (int w = 16; w > 0; w /= 2)
#pragma unroll
      for (int u = 0; u < U; ++u) ps[u] += __shfl_xor_sync(FULL, ps[u], w);
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < U; ++u) red[par][u][warp] = ps[u];
    __syncthreads();
    if (threadIdx.x < steps) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < VW; ++w) s += red[par][threadIdx.x][w];
      const float as = fabsf(s);
      const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
      const float sel = as > 1.f ? sg : (as == 1.f ? 0.5f * sg : 0.f);
      sc[((size_t)b * S + t0 + threadIdx.x) * H + head] =
          make_float2(__fdiv_rn(1.f, fmaxf(as, 1.f)), sel);
    }
    par ^= 1;  // red[par] is written again after the next barrier
#pragma unroll
    for (int u = 0; u < U; ++u) {
      kc[u] = kn[u];
      qc[u] = qn[u];
    }
  }
}

// ---------------------------------------------------------------------------
// 2-4. the rank-1 scan: X = a X + b u w^T, out = X y, zsum = z . out
// ---------------------------------------------------------------------------

// entry `l` of row `row` (32 entries) of a partial-sum buffer, its 16-byte
// groups rotated by the row (as csrc/mlstm_scan.cu's) so that lanes
// reading a row each, 16 bytes at a time, and lanes writing one row meet
// no bank twice
__device__ __forceinline__ int swz(int row, int l) {
  return row * 32 + ((((l >> 2) ^ row) & 7) << 2) + (l & 3);
}

// a[i] += a[i + W] for i < W, then at W / 2, ..., 1 (a stays in registers)
template <int W, int N>
__device__ __forceinline__ void tree(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] += a[i + W];
  if constexpr (W > 1) tree<W / 2>(a);
}

// floats of one step in a stage: w and y (HD each), u and z (ROWS each),
// the gate (4) and (1 / den, sel) padded to 4
template <int HD>
struct Ring {
  static constexpr int STEP = 2 * HD + 2 * ROWS + 8;
  static constexpr int STAGE = CHUNK * STEP;
  static constexpr size_t BYTES = sizeof(float) * STAGES * STAGE;
};

// MODE 0: forward, X = C^T from C0, (a, b) = (f_t, i_g t), y scaled by
// 1 / den; MODE 1: reverse, X = G, (a, b) = (f_{t+1}, 1), u scaled; MODE 2:
// reverse, X = G^T, (a, b) = (f_{t+1}, 1), w scaled
template <int HD, int MODE>
__global__ void __launch_bounds__(WARPS * 32)
mlstm_bwd_scan_kernel(const float* __restrict__ wv,
                      const float* __restrict__ yv,
                      const float* __restrict__ uv,
                      const float* __restrict__ zv,
                      const float4* __restrict__ gate,
                      const float2* __restrict__ sc,
                      const float* __restrict__ C0, float* __restrict__ out,
                      float* __restrict__ zsum, int B, int S, int H) {
  constexpr int CPL = HD >= 32 ? HD / 32 : 1;  // columns a lane
  constexpr int TILES = HD / ROWS;             // blocks a (b, head)
  constexpr bool REV = MODE != 0;
  static_assert(HD % ROWS == 0 && (HD < 32 || HD % 32 == 0), "head width");
  static_assert(CHUNK * RW == 32, "a chunk's row sums are one a lane");
  using L = Ring<HD>;
  extern __shared__ __align__(16) float ring[];
  __shared__ float zred[2][CHUNK][WARPS];
  // each warp's partial row sums of a chunk: CHUNK x RW rows of 32 lanes
  __shared__ __align__(16) float parts[WARPS][CHUNK * RW * 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  float* part = parts[warp];
  const int bh = blockIdx.x / TILES, b = bh / H, head = bh % H;
  const int tile = blockIdx.x % TILES;
  const int row0 = tile * ROWS;           // the block's first row of X
  const int wrow = row0 + warp * RW;      // the warp's
  const bool on = HD >= 32 || lane < HD;
  const int chunks = (S + CHUNK - 1) / CHUNK;

  float x[RW][CPL];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      x[r][c] = MODE == 0 && on
                    ? C0[((size_t)bh * HD + lane + 32 * c) * HD + wrow + r]
                    : 0.f;

  // chunk `kk` (in processing order) into stage kk % STAGES; an empty group
  // past the end keeps the wait below uniform
  auto issue = [&](int kk) {
    if (kk < chunks) {
      const int cc = REV ? chunks - 1 - kk : kk;
      const int t0 = cc * CHUNK;
      const int steps = S - t0 < CHUNK ? S - t0 : CHUNK;
      float* st = ring + (kk % STAGES) * L::STAGE;
      constexpr int V4 = HD / 4, R4 = ROWS / 4;
      constexpr int ITEMS = 2 * V4 + 2 * R4 + 2;
      for (int it = threadIdx.x; it < steps * ITEMS; it += WARPS * 32) {
        const int u = it / ITEMS, e = it % ITEMS;
        const int t = t0 + u;
        const size_t g = ((size_t)b * S + t) * H + head;
        float* dst = st + u * L::STEP;
        if (e < V4) {
          cp_async<16>(dst + 4 * e, wv + g * HD + 4 * e);
        } else if (e < 2 * V4) {
          cp_async<16>(dst + HD + 4 * (e - V4), yv + g * HD + 4 * (e - V4));
        } else if (e < 2 * V4 + R4) {
          const int o = 4 * (e - 2 * V4);
          cp_async<16>(dst + 2 * HD + o, uv + g * HD + row0 + o);
        } else if (e < 2 * V4 + 2 * R4) {
          const int o = 4 * (e - 2 * V4 - R4);
          if (zv != nullptr)
            cp_async<16>(dst + 2 * HD + ROWS + o, zv + g * HD + row0 + o);
        } else if (e == 2 * V4 + 2 * R4) {
          const int tg = REV ? (t + 1 < S ? t + 1 : t) : t;
          cp_async<16>(dst + 2 * HD + 2 * ROWS,
                       gate + ((size_t)b * S + tg) * H + head);
        } else {
          cp_async<8>(dst + 2 * HD + 2 * ROWS + 4, sc + g);
        }
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);
  for (int kk = 0; kk < chunks; ++kk) {
    const int cc = REV ? chunks - 1 - kk : kk;
    const int t0 = cc * CHUNK;
    const int steps = S - t0 < CHUNK ? S - t0 : CHUNK;
    const float* st = ring + (kk % STAGES) * L::STAGE;
    const int par = kk & 1;
    cp_async_wait_all_but_one();
    __syncthreads();
#pragma unroll 1
    for (int i = 0; i < steps; ++i) {
      const int u = REV ? steps - 1 - i : i;
      const int t = t0 + u;
      const float* p = st + u * L::STEP;
      const float4 g = *reinterpret_cast<const float4*>(p + 2 * HD + 2 * ROWS);
      const float rden = p[2 * HD + 2 * ROWS + 4];
      const float a = REV ? (t + 1 < S ? g.y : 0.f) : g.y;
      const float bb = REV ? 1.f : g.x;
      float uu[RW], acc[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        uu[r] = p[2 * HD + warp * RW + r];
        if (MODE == 1) uu[r] = uu[r] * rden;
        acc[r] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = lane + 32 * c;
        float w = on ? p[col] : 0.f;
        float y = on ? p[HD + col] : 0.f;
        if (MODE == 2) w = w * rden;
        if (MODE == 0) y = y * rden;
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          if (MODE == 0)
            x[r][c] = __fadd_rn(__fmul_rn(a, x[r][c]),
                                __fmul_rn(bb, __fmul_rn(w, uu[r])));
          else
            x[r][c] = fmaf(a, x[r][c], uu[r] * w);
          acc[r] = fmaf(x[r][c], y, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) part[swz(u * RW + r, lane)] = acc[r];
    }
    // the chunk's row sums: lane RW u + r adds the 32 partials of row r
    // at step u in a tree, writes out and its share of z . out
    __syncwarp();
    {
      const int u = lane / RW, r = lane % RW;
      float a[32];
      const float* pr = part + lane * 32;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const float4 x4 =
            *reinterpret_cast<const float4*>(pr + (((g ^ lane) & 7) << 2));
        a[4 * g] = x4.x;
        a[4 * g + 1] = x4.y;
        a[4 * g + 2] = x4.z;
        a[4 * g + 3] = x4.w;
      }
      tree<16>(a);
      const int t = t0 + u;
      if (u < steps)
        out[(((size_t)b * S + t) * H + head) * HD + wrow + r] = a[0];
      if (MODE != 2) {
        float zs = u < steps
                       ? st[u * L::STEP + 2 * HD + ROWS + warp * RW + r] * a[0]
                       : 0.f;
#pragma unroll
        for (int w = RW / 2; w > 0; w /= 2)
          zs += __shfl_xor_sync(FULL, zs, w);
        if (r == 0 && u < steps) zred[par][u][warp] = zs;
      }
    }
    __syncthreads();  // the stage is read; zred[par] is complete
    if (MODE != 2 && threadIdx.x < steps) {
      float zs = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) zs += zred[par][threadIdx.x][w];
      zsum[(size_t)tile * B * S * H +
           ((size_t)b * S + t0 + threadIdx.x) * H + head] = zs;
    }
    issue(kk + STAGES);
  }
}

// ---------------------------------------------------------------------------
// 5. combine: dq, dk, dv in place, then the gates' gradients
// ---------------------------------------------------------------------------

template <int HD>
__global__ void __launch_bounds__(VT)
mlstm_bwd_combine_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ nall,
                         const float* __restrict__ n0,
                         const float4* __restrict__ gate,
                         const float2* __restrict__ sc,
                         const float* __restrict__ hhs,
                         const float* __restrict__ vgks,
                         float* __restrict__ dq, float* __restrict__ dk,
                         float* __restrict__ dv, float4* __restrict__ sa,
                         float2* __restrict__ sb, float* __restrict__ di,
                         float* __restrict__ df, int B, int S, int H) {
  constexpr int TILES = HD / ROWS;
  const int bh = blockIdx.x, b = bh / H, head = bh % H;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t plane = (size_t)B * S * H;  // one tile's sums
  // (a) each step's hh and v^T G k (the scans' block sums in block order)
  // and ds
  for (int t = threadIdx.x; t < S; t += VT) {
    const size_t g = ((size_t)b * S + t) * H + head;
    float hh = 0.f, vgk = 0.f;
    for (int p = 0; p < TILES; ++p) {
      hh += hhs[p * plane + g];
      vgk += vgks[p * plane + g];
    }
    const float2 s = sc[g];
    sa[g] = make_float4(-(hh * s.x) * s.y, hh, vgk, 0.f);
  }
  __syncthreads();
  // (b) dN in reverse, a thread a column; dq, dk, dv; dN . k, dN . n_{t-1}
  __shared__ float red[2][UC][VW][2];
  const int j = threadIdx.x;
  const bool on = j < HD;
  const int jc = on ? j : 0;
  // a step's inputs, loaded unconditionally (steps past the sequence read
  // a valid step) a batch of UC steps ahead of their arithmetic
  struct In {
    float q, k, nt, np, dqc, gk, gtv, ig, ds, fgn;
  };
  auto load = [&](int t0, In (&in)[UC]) {
#pragma unroll
    for (int u = 0; u < UC; ++u) {
      const int t = t0 + u < S ? (t0 + u >= 0 ? t0 + u : 0) : S - 1;
      const size_t g = ((size_t)b * S + t) * H + head;
      const size_t at = g * HD + jc;
      in[u].q = q[at];
      in[u].k = k[at];
      in[u].nt = nall[at];
      in[u].np = t > 0 ? nall[at - (size_t)H * HD] : n0[(size_t)bh * HD + jc];
      in[u].dqc = dq[at];
      in[u].gk = dv[at];
      in[u].gtv = dk[at];
      in[u].ig = gate[g].x;
      in[u].ds = sa[g].x;
      in[u].fgn = t + 1 < S ? gate[g + H].y : 0.f;
    }
  };
  In cur[UC], nxt[UC];
  float dN = 0.f;
  int par = 0;
  const int last = ((S - 1) / UC) * UC;
  load(last, cur);
  for (int t0 = last; t0 >= 0; t0 -= UC) {
    const int steps = S - t0 < UC ? S - t0 : UC;
    load(t0 - UC, nxt);
    float p2[UC], p3[UC];
#pragma unroll
    for (int u = UC - 1; u >= 0; --u) {
      p2[u] = 0.f;
      p3[u] = 0.f;
      if (u < steps && on) {
        const In& x = cur[u];
        dN = __fadd_rn(__fmul_rn(x.ds, x.q), __fmul_rn(x.fgn, dN));
        const size_t at = (((size_t)b * S + t0 + u) * H + head) * HD + j;
        dq[at] = x.dqc + x.ds * x.nt;
        dk[at] = x.ig * (x.gtv + dN);
        dv[at] = x.ig * x.gk;
        p2[u] = dN * x.k;
        p3[u] = dN * x.np;
      }
    }
#pragma unroll
    for (int w = 16; w > 0; w /= 2)
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        p2[u] += __shfl_xor_sync(FULL, p2[u], w);
        p3[u] += __shfl_xor_sync(FULL, p3[u], w);
      }
    if (lane == 0)
#pragma unroll
      for (int u = 0; u < UC; ++u) {
        red[par][u][warp][0] = p2[u];
        red[par][u][warp][1] = p3[u];
      }
    __syncthreads();
    if (threadIdx.x < steps) {
      float s2 = 0.f, s3 = 0.f;
#pragma unroll
      for (int w = 0; w < VW; ++w) {
        s2 += red[par][threadIdx.x][w][0];
        s3 += red[par][threadIdx.x][w][1];
      }
      sb[((size_t)b * S + t0 + threadIdx.x) * H + head] = make_float2(s2, s3);
    }
    par ^= 1;
#pragma unroll
    for (int u = 0; u < UC; ++u) cur[u] = nxt[u];
  }
  __syncthreads();
  // (c) Q and the gates' chain in reverse, warp 0, 32 steps at a time
  if (warp != 0) return;
  float Q = 0.f, carry = 0.f;
  for (int t0 = ((S - 1) / 32) * 32; t0 >= 0; t0 -= 32) {
    const int valid = S - t0 < 32 ? S - t0 : 32;
    const int t = t0 + lane;
    const size_t g = ((size_t)b * S + (t < S ? t : t0)) * H + head;
    const float4 gt = gate[g];
    const float4 a4 = sa[g];
    const float2 b2 = sb[g];
    const float hh = a4.y;
    const float igv = gt.x * a4.z;
    const float DI = gt.x * (a4.z + b2.x);
    const float FP = gt.y * b2.y;
    float my_di = 0.f, my_df = 0.f;
    for (int s = valid - 1; s >= 0; --s) {
      Q = (__shfl_sync(FULL, hh, s) + Q) - __shfl_sync(FULL, igv, s);
      if (__shfl_sync(FULL, gt.y, s) == 0.f) Q = 0.f;  // f_g C_{t-1} = 0
      const float DF = Q + __shfl_sync(FULL, FP, s);
      const float DIs = __shfl_sync(FULL, DI, s);
      const float w = __shfl_sync(FULL, gt.z, s);
      const float a = carry - (DIs + DF);
      const float dlfm = DF + w * a;
      const float d_i = DIs + (1.f - w) * a;
      carry = dlfm;
      if (lane == s) {
        my_di = d_i;
        my_df = dlfm * gt.w;
      }
    }
    if (lane < valid) {
      di[g] = my_di;
      df[g] = my_df;
    }
  }
}

template <int HD, int MODE>
int scan(const float* wv, const float* yv, const float* uv, const float* zv,
         const float4* gate, const float2* sc, const float* C0, float* out,
         float* zsum, int B, int S, int H, cudaStream_t stream) {
  // the ring's shared memory is allowed once a device
  static std::atomic<bool> allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !allowed[dev].load()) {
    err = cudaFuncSetAttribute(mlstm_bwd_scan_kernel<HD, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)Ring<HD>::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) allowed[dev].store(true);
  }
  const long long blocks = (long long)B * H * (HD / ROWS);
  mlstm_bwd_scan_kernel<HD, MODE>
      <<<(unsigned)blocks, WARPS * 32, Ring<HD>::BYTES, stream>>>(
          wv, yv, uv, zv, gate, sc, C0, out, zsum, B, S, H);
  return (int)cudaGetLastError();
}

struct Args {
  const float *q, *k, *v, *ip, *fp, *C0, *n0, *m0, *dh;
  float *dq, *dk, *dv, *di, *df;
  float4* gate;
  float2* sc;
  float *nall, *hhs, *vgks;
  float4* sa;
  float2* sb;
};

template <int HD>
int launch(const Args& a, int B, int S, int H, cudaStream_t stream) {
  if ((long long)B * H * (HD / ROWS) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned heads = (unsigned)(B * H);
  mlstm_bwd_prep_kernel<HD><<<heads, VT, 0, stream>>>(
      a.q, a.k, a.ip, a.fp, a.n0, a.m0, a.gate, a.sc, a.nall, S, H);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // C^T dnum (into dq), G k (into dv), G^T v (into dk)
  err = scan<HD, 0>(a.v, a.dh, a.k, a.q, a.gate, a.sc, a.C0, a.dq, a.hhs, B,
                    S, H, stream);
  if (err) return err;
  err = scan<HD, 1>(a.q, a.k, a.dh, a.v, a.gate, a.sc, nullptr, a.dv,
                    a.vgks, B, S, H, stream);
  if (err) return err;
  err = scan<HD, 2>(a.dh, a.v, a.q, nullptr, a.gate, a.sc, nullptr, a.dk,
                    nullptr, B, S, H, stream);
  if (err) return err;
  mlstm_bwd_combine_kernel<HD><<<heads, VT, 0, stream>>>(
      a.q, a.k, a.nall, a.n0, a.gate, a.sc, a.hhs, a.vgks, a.dq, a.dk, a.dv,
      a.sa, a.sb, a.di, a.df, B, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the five kernels on `stream` (PyTorch's current stream) and
// returns the first cudaGetLastError() (or cudaFuncSetAttribute's error)
// that is not zero. q, k, v, dh, dq, dk, dv, nall (B, S, H, hd); i_pre,
// f_pre, di, df (B, S, H); the state before the scan C0 (B, H, hd, hd), n0
// (B, H, hd), m0 (B, H): contiguous float32, q, k, v and dh 16-byte aligned
// (copied by cp.async). Scratch: gate (B, S, H) float4, sc (B, S, H) float2,
// sa (B, S, H) float4, sb (B, S, H) float2, hhs and vgks (hd / 16, B, S, H)
// float32. hd one of 16, 32, 64, 128, 256, 512; S >= 1.
extern "C" int mlstm_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* i_pre,
    const void* f_pre, const void* C0, const void* n0, const void* m0,
    const void* dh, void* dq, void* dk, void* dv, void* di, void* df,
    void* gate, void* sc, void* nall, void* sa, void* sb, void* hhs,
    void* vgks, int B, int S, int H, int hd, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto c = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  const Args a{c(q),  c(k),  c(v),  c(i_pre), c(f_pre),
               c(C0), c(n0), c(m0), c(dh),    o(dq),
               o(dk), o(dv), o(di), o(df),    static_cast<float4*>(gate),
               static_cast<float2*>(sc),      o(nall),
               o(hhs), o(vgks), static_cast<float4*>(sa),
               static_cast<float2*>(sb)};
  const auto st = (cudaStream_t)stream;
  switch (hd) {
    case 16: return launch<16>(a, B, S, H, st);
    case 32: return launch<32>(a, B, S, H, st);
    case 64: return launch<64>(a, B, S, H, st);
    case 128: return launch<128>(a, B, S, H, st);
    case 256: return launch<256>(a, B, S, H, st);
    case 512: return launch<512>(a, B, S, H, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
