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
// Design: seven launches, no atomics (two launches are bitwise equal).
// The serial per-(b, head) chains run in launches of their own, a warp a
// (b, head); everything over the HD columns runs in the scans, which fill
// the card; every sum across rows is written as partial sums of RW = 4
// rows (a row group) and added in row-group order by the launch after.
// 1. gates, a warp a (b, head): the stabiliser's chain 32 steps at a time
//    (as the forward's producer), each step's (i_g, f_g, tie weight,
//    sigmoid(-f)), the next 32 steps' pre-activations loaded meanwhile.
// 2, 4, 5. one rank-1 scan, three ways: X = a X + (b u) w^T and out = X y
//    a step, X of one (b, head) in registers over B x H x HD / ROWS
//    blocks. A block is a producer warp and NW = 8 consumer warps (two a
//    scheduler; 4 at HD 16); a row group is RW rows of X and all HD
//    columns, on one warp (HD <= 256) or on a pair of warps that split
//    the columns (HD 512), 32 entries of X a lane at HD 256-512. The
//    producer copies each step's w and y (HD each) and the block's rows
//    of u by TMA bulk copies into a two-stage ring of CHUNK = 8 steps on
//    mbarriers (as csrc/mlstm_scan.cu's), and writes each step's scalars
//    beside them, loaded a chunk ahead. A consumer step: one FMUL and two
//    FMAs an entry (the update fused: C need not be the forward's bits),
//    its 4 rows' partial sums into shared memory. After a chunk lane
//    RW u + r adds the 32 partials of row r at step u in a tree (at HD
//    512 the pair's second warp hands its sums to the first through
//    shared memory at a named barrier) and writes that row's outputs; a
//    row's walk along the chunk's steps (n or dN, the plain loop's
//    rounding) runs across the 8 lanes that hold it, one shuffle a step;
//    the other inputs of the outputs are loaded before the chunk.
//      mode 0, forward: X = C^T from the state, u = i_g k, w = v, y = dh:
//        out = C^T dh (unscaled: 1 / den is not known yet) into dq, n_t
//        into nall, a row group's n_t . q_t and q_t . out partials;
//      scalars (3): s, 1 / den, ds and hh from the partials;
//      mode 1, reverse: X = G, a = f_{t+1}, u = dh / den, w = q, y = k:
//        dv = i_g G k and a row group's v . G k partial;
//      mode 2, reverse: X = G^T, u = q / den, w = dh, y = v: dk = i_g
//        (G^T v + dN), dq = C^T dh / den + ds n_t, and a row group's
//        dN . k and dN . n_{t-1} partials.
// 6. sums: each step's v^T G k, dN . k and dN . n_{t-1} from the partials.
// 7. chain, a warp a (b, head): Q and the gates' chain in reverse, 32
//    steps at a time, the next 32 loaded meanwhile.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): operations. At
// (B, S, H, HD) = (1, 4096, 4, 512) the function needs ~7 FP32
// instructions an element of C a step (C again 2, G's update 2, C^T dnum,
// G^T v and G k one FMA each; <G, C> is the scalar recurrence Q, not a
// sum over C), and 8 a row: 30.1 G in all, ~0.90 ms at one instruction a
// lane and clock (33.4 T/s); q, k, v, dh in and dq, dk, dv out are 235 MB,
// 0.07 ms at 3.35 TB/s. This design issues 9 an element a step
// (G twice, 3 each pass), and a step's w and y come from shared memory,
// 2 KB for every 4 rows (a lane reads 16 floats for its 32 entries): a
// pass issues ~115 instructions a warp a step and moves ~28 KB of shared
// memory an SM a step, and takes about the sum of the two (~0.23 us a
// step on an H100 80GB HBM3 at 700 W; tools/bench_xlstm_scan.py's
// diagnostic builds).
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RW = 4;       // rows of X a row group (a partial sum's rows)
constexpr int CHUNK = 8;    // steps a stage of the scans' ring
constexpr int STAGES = 2;   // stages of the ring
constexpr int ET = 256;     // threads a block of the elementwise launches
constexpr int MAX_DEVICES = 64;
static_assert(CHUNK * RW == 32, "a chunk's row sums are one a lane");

// the scans' split of an HD x HD matrix
template <int HD>
struct Cfg {
  static constexpr int WPR = HD >= 512 ? 2 : 1;  // warps a row group
  static constexpr int NW = HD >= 32 ? 8 : 4;    // consumer warps a block
  static constexpr int GROUPS = NW / WPR;        // row groups a block
  static constexpr int ROWS = GROUPS * RW;       // rows a block
  static constexpr int SPAN = HD / WPR;          // columns a warp
  static constexpr int CPL = SPAN >= 32 ? SPAN / 32 : 1;  // columns a lane
  static constexpr int VEC = CPL < 4 ? CPL : 4;  // adjacent columns a load
  static constexpr int NV = CPL / VEC;           // loads a vector a step
  static constexpr int TILES = HD / ROWS;        // blocks a (b, head)
  static_assert(HD % ROWS == 0 && (SPAN < 32 || SPAN % (32 * VEC) == 0),
                "head width");
};

// shared memory of a scan block, in floats: the barriers (full[s],
// empty[s]), each consumer warp's partial sums of a chunk, the pair
// exchange (two chunks), the ring (a step: w, y, the block's rows of u,
// the scalars)
template <int HD>
struct Layout {
  using C = Cfg<HD>;
  static constexpr int STEP = 2 * HD + C::ROWS + 4;
  static constexpr int STAGE = CHUNK * STEP;
  static constexpr int PART = 16;
  static constexpr int XCH = PART + C::NW * CHUNK * RW * 32;
  static constexpr int RING = XCH + 2 * C::GROUPS * 32;
  static constexpr size_t BYTES = sizeof(float) * (RING + STAGES * STAGE);
  static_assert(STEP % 4 == 0 && RING % 4 == 0, "16-byte copies");
};

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), as torch's logaddexp
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

// the share of a max's gradient that goes to its first operand, for
// d = first - second: 1, one half at a tie, 0
__device__ __forceinline__ float tie_weight(float d) {
  return d > 0.f ? 1.f : (d == 0.f ? 0.5f : 0.f);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// waits until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// `bytes` contiguous bytes into shared memory (16-byte aligned, a multiple
// of 16); completes that much of the barrier's transaction count
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}
// named barrier `id` of `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

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
  for (int i = 0; i < W; ++i) a[i] = __fadd_rn(a[i], a[i + W]);
  if constexpr (W > 1) tree<W / 2>(a);
}

// ---------------------------------------------------------------------------
// 1. gates: (i_g, f_g, tie weight, sigmoid(-f)) a step
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
mlstm_bwd_gates_kernel(const float* __restrict__ ip,
                       const float* __restrict__ fp,
                       const float* __restrict__ m0,
                       float4* __restrict__ gate, int S, int H) {
  const int bh = blockIdx.x, b = bh / H, head = bh % H;
  const int lane = threadIdx.x;
  // lane s of a batch takes step t0 + s; only the m chain runs in order
  auto at = [&](int t) { return ((size_t)b * S + t) * H + head; };
  // steps past S take log_f = 0 and i = -inf, which leave m as it is
  float m_reg = m0[bh];
  const float ninf = -__int_as_float(0x7f800000);
  float xi = lane < S ? ip[at(lane)] : ninf;
  float xf = lane < S ? fp[at(lane)] : 0.f;
  for (int t0 = 0; t0 < S; t0 += 32) {
    const int t = t0 + lane;
    const float ci = xi, cf = xf;
    // the next batch, while this one's chain runs
    xi = t + 32 < S ? ip[at(t + 32)] : ninf;
    xf = t + 32 < S ? fp[at(t + 32)] : 0.f;
    const float log_f = t < S ? -softplus(-cf) : 0.f;
    float my_lfm = 0.f;
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const float lfm = __fadd_rn(__shfl_sync(FULL, log_f, s), m_reg);
      m_reg = fmaxf(lfm, __shfl_sync(FULL, ci, s));
      if (lane == s) my_lfm = lfm;
    }
    if (t < S) {
      const float d = __fsub_rn(my_lfm, ci);
      const float e = expf(-fabsf(d));
      gate[at(t)] = make_float4(d > 0.f ? e : 1.f, d > 0.f ? 1.f : e,
                                tie_weight(d),
                                __fdiv_rn(1.f, __fadd_rn(1.f, expf(cf))));
    }
  }
}

// ---------------------------------------------------------------------------
// 2, 4, 5. the rank-1 scan: X = a X + (b u) w^T, out = X y
// ---------------------------------------------------------------------------

struct ScanArgs {
  const float* w;       // the update's column vector, (B, S, H, HD)
  const float* y;       // the product's vector
  const float* u;       // the update's row vector
  const float* z[4];    // the rows' inputs of the chunk's outputs: mode 0
                        // q; 1 v; 2 k, nall (n_{t-1}), C^T dh, nall (n_t)
  const float4* gate;   // (i_g, f_g, tie weight, sigmoid(-f)) (B, S, H)
  const float4* sc;     // (1 / den, ds, hh, 0) (B, S, H)
  const float* C0;      // mode 0: the state C (B, H, HD, HD)
  const float* n0;      // modes 0, 2: the state n (B, H, HD)
  float* out;           // mode 0: C^T dh; 1: dv; 2: dk
  float* out2;          // mode 0: nall; 2: dq
  float* part0;         // partials (HD / RW, B, S, H): 0 n . q, 1 v . G k,
                        // 2 dN . k
  float* part1;         // 0 q . C^T dh, 2 dN . n_{t-1}
};

// a row group's sum of z_r o_r over its 4 rows, on the lanes RW u .. RW u
// + 3 that hold them: the rounded products added pairwise
__device__ __forceinline__ float group_dot(float z, float o) {
  float s = __fmul_rn(z, o);
  s = __fadd_rn(s, __shfl_xor_sync(FULL, s, 1));
  return __fadd_rn(s, __shfl_xor_sync(FULL, s, 2));
}

template <int HD, int MODE>
__global__ void __launch_bounds__((Cfg<HD>::NW + 1) * 32, 2)
mlstm_bwd_scan_kernel(const ScanArgs args, int B, int S, int H) {
  using C = Cfg<HD>;
  using L = Layout<HD>;
  constexpr int ROWS = C::ROWS, CPL = C::CPL, VEC = C::VEC;
  constexpr bool REV = MODE != 0;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bh = blockIdx.x / C::TILES, b = bh / H, head = bh % H;
  const int blk_row0 = (blockIdx.x % C::TILES) * ROWS;
  const int chunks = (S + CHUNK - 1) / CHUNK;
  // full[s] at bars + 8 s: the producer's arrival and the copies' bytes;
  // empty[s] at bars + 8 (STAGES + s): one arrival a consumer warp
  const uint32_t bars = smem_addr(smem);
  float* ring = smem + L::RING;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), C::NW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == C::NW) {
    // the producer: lane s < CHUNK copies step s of each chunk (steps past
    // S copy step S - 1: finite values that the scalars make no-ops) and
    // writes its scalars, loaded a chunk ahead: mode 0 (f_g, i_g); modes
    // 1, 2 (f_{t+1}, i_g, 1 / den, ds), zero past S - 1
    auto scalars = [&](int kk) {
      float4 v = make_float4(MODE == 0 ? 1.f : 0.f, 0.f, 0.f, 0.f);
      const int cc = REV ? chunks - 1 - kk : kk;
      const int t = cc * CHUNK + lane;
      if (kk < chunks && lane < CHUNK && t < S) {
        const size_t g = ((size_t)b * S + t) * H + head;
        const float4 gt = args.gate[g];
        if (MODE == 0) {
          v = make_float4(gt.y, gt.x, 0.f, 0.f);
        } else {
          const float4 s4 = args.sc[g];
          v = make_float4(t + 1 < S ? args.gate[g + H].y : 0.f, gt.x, s4.x,
                          s4.y);
        }
      }
      return v;
    };
    float4 next = scalars(0);
    for (int kk = 0; kk < chunks; ++kk) {
      const int stage = kk % STAGES;
      const int cc = REV ? chunks - 1 - kk : kk;
      const uint32_t full = bars + 8 * stage;
      if (kk >= STAGES)
        mbar_wait(bars + 8 * (STAGES + stage),
                  (uint32_t)((kk / STAGES - 1) & 1));
      if (lane == 0)
        mbar_expect_tx(full, (uint32_t)(CHUNK * (2 * HD + ROWS) * 4));
      __syncwarp();
      if (lane < CHUNK) {
        const int tu = cc * CHUNK + lane;
        const int t = tu < S ? tu : S - 1;
        const size_t g = ((size_t)b * S + t) * H + head;
        float* dst = ring + stage * L::STAGE + lane * L::STEP;
        const uint32_t d = smem_addr(dst);
        bulk_load(d, args.w + g * HD, HD * 4, full);
        bulk_load(d + HD * 4, args.y + g * HD, HD * 4, full);
        bulk_load(d + 2 * HD * 4, args.u + g * HD + blk_row0, ROWS * 4,
                  full);
        *reinterpret_cast<float4*>(dst + 2 * HD + ROWS) = next;
      }
      next = scalars(kk + 1);
      __syncwarp();
      if (lane == 0) mbar_arrive(full);  // releases the scalars' stores
    }
    return;
  }

  // a consumer warp: RW rows of X (its row group's), its share of the
  // columns: lane l holds columns half * SPAN + 32 VEC g + VEC l + e; the
  // first halves of the pairs are warps 0 .. GROUPS - 1 (one a scheduler)
  const int grp = warp % C::GROUPS, half = warp / C::GROUPS;
  const int grow = grp * RW;             // the group's first row in the block
  const int row0 = blk_row0 + grow;      // ... in the head
  const bool lead = half == 0;
  const bool on = C::SPAN >= 32 || lane < C::SPAN;
  float* part = smem + L::PART + warp * (CHUNK * RW * 32);
  float* xch = smem + L::XCH;
  auto col = [&](int g, int e) {
    return half * C::SPAN + 32 * VEC * g + VEC * (on ? lane : 0) + e;
  };
  float x[RW][CPL];
#pragma unroll
  for (int g = 0; g < C::NV; ++g)
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float4 c4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (MODE == 0 && on)  // X = C^T: row j, column i is C[i][j]
        c4 = *reinterpret_cast<const float4*>(
            args.C0 + ((size_t)bh * HD + col(g, e)) * HD + row0);
      x[0][g * VEC + e] = c4.x;
      x[1][g * VEC + e] = c4.y;
      x[2][g * VEC + e] = c4.z;
      x[3][g * VEC + e] = c4.w;
    }
  // after a chunk lane RW u + r holds row r at step u of the chunk; the
  // rows' walk (mode 0 n, mode 2 dN) runs across those lanes, its carry
  // into the next chunk on every lane of its row
  const int me_u = lane / RW, me_r = lane % RW;
  float carry = MODE == 0 ? args.n0[(size_t)bh * HD + row0 + me_r] : 0.f;
  const size_t plane = (size_t)B * S * H;  // one row group's partials
  const size_t pgrp = (size_t)(row0 / RW) * plane;

  for (int kk = 0; kk < chunks; ++kk) {
    const int stage = kk % STAGES;
    const int cc = REV ? chunks - 1 - kk : kk;
    const int t0 = cc * CHUNK;
    // this lane's inputs of the chunk's outputs, loaded now for after it
    const int t = t0 + me_u;
    const bool live = t < S;
    const size_t g = ((size_t)b * S + (live ? t : S - 1)) * H + head;
    const size_t at = g * HD + row0 + me_r;
    float z[MODE == 2 ? 4 : 1];
    if (lead) {
      z[0] = args.z[0][at];
      if (MODE == 2) {
        const int tp = live ? t : S - 1;
        z[1] = tp > 0 ? args.z[1][at - (size_t)H * HD]
                      : args.n0[(size_t)bh * HD + row0 + me_r];
        z[2] = args.z[2][at];
        z[3] = args.z[3][at];
      }
    }
    mbar_wait(bars + 8 * stage, (uint32_t)((kk / STAGES) & 1));
    const float* st = ring + stage * L::STAGE;
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      const int u = REV ? CHUNK - 1 - i : i;
      const float* p = st + u * L::STEP;
      const float4 s4 =
          *reinterpret_cast<const float4*>(p + 2 * HD + ROWS);
      const float4 r4 = *reinterpret_cast<const float4*>(p + 2 * HD + grow);
      const float a = s4.x;
      const float scale = MODE == 0 ? s4.y : s4.z;  // i_g, or 1 / den
      const float ur[RW] = {__fmul_rn(r4.x, scale), __fmul_rn(r4.y, scale),
                            __fmul_rn(r4.z, scale), __fmul_rn(r4.w, scale)};
      float wv[CPL], yv[CPL];
#pragma unroll
      for (int g2 = 0; g2 < C::NV; ++g2) {
        const float* pw = p + col(g2, 0);
        if constexpr (VEC == 4) {
          const float4 w4 = *reinterpret_cast<const float4*>(pw);
          const float4 y4 = *reinterpret_cast<const float4*>(pw + HD);
          wv[4 * g2] = w4.x, wv[4 * g2 + 1] = w4.y;
          wv[4 * g2 + 2] = w4.z, wv[4 * g2 + 3] = w4.w;
          yv[4 * g2] = y4.x, yv[4 * g2 + 1] = y4.y;
          yv[4 * g2 + 2] = y4.z, yv[4 * g2 + 3] = y4.w;
        } else if constexpr (VEC == 2) {
          const float2 w2 = *reinterpret_cast<const float2*>(pw);
          const float2 y2 = *reinterpret_cast<const float2*>(pw + HD);
          wv[2 * g2] = w2.x, wv[2 * g2 + 1] = w2.y;
          yv[2 * g2] = y2.x, yv[2 * g2 + 1] = y2.y;
        } else {
          wv[g2] = on ? pw[0] : 0.f;
          yv[g2] = on ? pw[HD] : 0.f;
        }
      }
      // X = a X + u w^T and the rows' partial sums of X y over the lane's
      // columns, in column order
      float acc[RW] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < CPL; ++c)
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          x[r][c] = fmaf(a, x[r][c], __fmul_rn(ur[r], wv[c]));
          acc[r] = fmaf(x[r][c], yv[c], acc[r]);
        }
#pragma unroll
      for (int r = 0; r < RW; ++r) part[swz(u * RW + r, lane)] = acc[r];
    }
    __syncwarp();
    // the chunk's row sums: lane RW u + r adds the 32 partials of row r at
    // step u in a tree; at HD 512 the pair's second warp hands its sums to
    // the first, which adds them after its own (both wait at the pair's
    // barrier, so neither is a chunk ahead: the exchange's two buffers
    // alternate by chunk)
    float s[32];
    const float* pr = part + lane * 32;
#pragma unroll
    for (int q4 = 0; q4 < 8; ++q4) {
      const float4 x4 =
          *reinterpret_cast<const float4*>(pr + (((q4 ^ lane) & 7) << 2));
      s[4 * q4] = x4.x;
      s[4 * q4 + 1] = x4.y;
      s[4 * q4 + 2] = x4.z;
      s[4 * q4 + 3] = x4.w;
    }
    tree<16>(s);
    float o = s[0];
    if constexpr (C::WPR == 2) {
      float* xb = xch + ((kk & 1) * C::GROUPS + grp) * 32;
      if (!lead) xb[lane] = o;
      bar_sync(1 + grp, 64);
      if (lead) o = __fadd_rn(o, xb[lane]);
    }
    if (lead) {
      const float* p = st + me_u * L::STEP;
      const float4 s4 =
          *reinterpret_cast<const float4*>(p + 2 * HD + ROWS);
      const float ur = p[2 * HD + grow + me_r];  // k, dh or q of the row
      if (MODE == 0) {
        // n_t = f_g n_{t-1} + i_g k (the plain loop's rounding) along the
        // chunk's steps, then n_t . q and q . C^T dh
        const float ik = __fmul_rn(ur, s4.y);
        float n = 0.f;
#pragma unroll
        for (int u = 0; u < CHUNK; ++u) {
          const float prev = __shfl_up_sync(FULL, n, RW);
          if (me_u == u)
            n = __fadd_rn(__fmul_rn(s4.x, u == 0 ? carry : prev), ik);
        }
        carry = __shfl_sync(FULL, n, (CHUNK - 1) * RW + me_r);
        const float sp = group_dot(z[0], n);
        const float hp = group_dot(z[0], o);
        if (live) {
          args.out[at] = o;
          args.out2[at] = n;
          if (me_r == 0) {
            args.part0[pgrp + g] = sp;
            args.part1[pgrp + g] = hp;
          }
        }
      } else if (MODE == 1) {
        const float vp = group_dot(z[0], o);
        if (live) {
          args.out[at] = __fmul_rn(s4.y, o);
          if (me_r == 0) args.part0[pgrp + g] = vp;
        }
      } else {
        // dN_t = ds_t q_t + f_{t+1} dN_{t+1} (the plain loop's rounding)
        // along the chunk's steps in reverse, then dk, dq, dN . k and
        // dN . n_{t-1}
        const float dsq = __fmul_rn(s4.w, ur);
        float dn = 0.f;
#pragma unroll
        for (int u = CHUNK - 1; u >= 0; --u) {
          const float next = __shfl_down_sync(FULL, dn, RW);
          if (me_u == u)
            dn = __fadd_rn(dsq, __fmul_rn(s4.x, u == CHUNK - 1 ? carry
                                                               : next));
        }
        carry = __shfl_sync(FULL, dn, me_r);
        const float kp = group_dot(z[0], dn);
        const float np = group_dot(z[1], dn);
        if (live) {
          args.out[at] = __fmul_rn(s4.y, __fadd_rn(o, dn));
          args.out2[at] = fmaf(s4.w, z[3], __fmul_rn(z[2], s4.z));
          if (me_r == 0) {
            args.part0[pgrp + g] = kp;
            args.part1[pgrp + g] = np;
          }
        }
      }
    }
    __syncwarp();  // the stage and the partials are read
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + stage));
  }
}

// ---------------------------------------------------------------------------
// 3. scalars: s, 1 / den, ds and hh a step from mode 0's partials
// ---------------------------------------------------------------------------

// entry i of N planes of partials (`groups` row groups of n each), each
// plane's added in row-group order: the one order every sum across rows
// is taken in
template <int N>
__device__ __forceinline__ void row_group_sums(
    const float* const (&planes)[N], int n, int i, int groups,
    float (&sum)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) sum[j] = 0.f;
#pragma unroll 16
  for (int p = 0; p < groups; ++p) {  // the row groups in order
#pragma unroll
    for (int j = 0; j < N; ++j)
      sum[j] = __fadd_rn(sum[j], planes[j][(size_t)p * n + i]);
  }
}

__global__ void __launch_bounds__(ET)
mlstm_bwd_scalars_kernel(const float* __restrict__ sp,
                         const float* __restrict__ hp,
                         float4* __restrict__ sc, int n, int groups) {
  const int i = blockIdx.x * ET + threadIdx.x;
  if (i >= n) return;
  const float* const planes[2] = {sp, hp};
  float sum[2];
  row_group_sums(planes, n, i, groups, sum);
  const float s = sum[0], h = sum[1];
  const float as = fabsf(s);
  const float sg = s > 0.f ? 1.f : (s < 0.f ? -1.f : 0.f);
  const float sel = as > 1.f ? sg : (as == 1.f ? 0.5f * sg : 0.f);
  const float rden = __fdiv_rn(1.f, fmaxf(as, 1.f));
  const float hh = __fmul_rn(h, rden);  // q . C^T dnum
  sc[i] = make_float4(rden, -__fmul_rn(__fmul_rn(hh, rden), sel), hh, 0.f);
}

// ---------------------------------------------------------------------------
// 6. sums: v^T G k, dN . k, dN . n_{t-1} a step, as the chain takes them
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(ET)
mlstm_bwd_sums_kernel(const float* __restrict__ vp,
                      const float* __restrict__ kp,
                      const float* __restrict__ np,
                      const float4* __restrict__ gate,
                      const float4* __restrict__ sc, float4* __restrict__ ch,
                      int n, int groups) {
  const int i = blockIdx.x * ET + threadIdx.x;
  if (i >= n) return;
  const float* const planes[3] = {vp, kp, np};
  float sum[3];
  row_group_sums(planes, n, i, groups, sum);
  const float vgk = sum[0], dnk = sum[1], dnn = sum[2];
  const float4 gt = gate[i];
  // (hh, i_g v^T G k, DI, f_g dN . n_{t-1})
  ch[i] = make_float4(sc[i].z, __fmul_rn(gt.x, vgk),
                      __fmul_rn(gt.x, __fadd_rn(vgk, dnk)),
                      __fmul_rn(gt.y, dnn));
}

// ---------------------------------------------------------------------------
// 7. chain: Q and the gates' chain in reverse, a warp a (b, head)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(32)
mlstm_bwd_chain_kernel(const float4* __restrict__ gate,
                       const float4* __restrict__ ch, float* __restrict__ di,
                       float* __restrict__ df, int S, int H) {
  const int bh = blockIdx.x, b = bh / H, head = bh % H;
  const int lane = threadIdx.x;
  auto at = [&](int t) { return ((size_t)b * S + t) * H + head; };
  // steps past S read zeros (and f_g = 1), which leave Q and the carry at
  // their start, 0: the last batch is the first walked
  const float4 none = make_float4(0.f, 1.f, 0.f, 0.f);
  int t0 = ((S - 1) / 32) * 32;
  float4 gt = t0 + lane < S ? gate[at(t0 + lane)] : none;
  float4 c4 = t0 + lane < S ? ch[at(t0 + lane)]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
  float Q = 0.f, carry = 0.f;
  for (; t0 >= 0; t0 -= 32) {
    const float4 g = gt, c = c4;
    if (t0 >= 32) {  // the batch before, while this one's chain runs
      gt = gate[at(t0 - 32 + lane)];
      c4 = ch[at(t0 - 32 + lane)];
    }
    float my_di = 0.f, my_df = 0.f;
#pragma unroll
    for (int s = 31; s >= 0; --s) {
      const float hh = __shfl_sync(FULL, c.x, s);
      const float igv = __shfl_sync(FULL, c.y, s);
      const float DI = __shfl_sync(FULL, c.z, s);
      const float FP = __shfl_sync(FULL, c.w, s);
      const float fg = __shfl_sync(FULL, g.y, s);
      const float w = __shfl_sync(FULL, g.z, s);
      Q = __fsub_rn(__fadd_rn(hh, Q), igv);
      if (fg == 0.f) Q = 0.f;  // f_g C_{t-1} = 0
      const float DF = __fadd_rn(Q, FP);
      const float a = __fsub_rn(carry, __fadd_rn(DI, DF));
      const float dlfm = __fadd_rn(DF, __fmul_rn(w, a));
      const float d_i = __fadd_rn(DI, __fmul_rn(__fsub_rn(1.f, w), a));
      carry = dlfm;
      if (lane == s) {
        my_di = d_i;
        my_df = __fmul_rn(dlfm, g.w);
      }
    }
    if (t0 + lane < S) {
      di[at(t0 + lane)] = my_di;
      df[at(t0 + lane)] = my_df;
    }
  }
}

// ---------------------------------------------------------------------------
// the launches
// ---------------------------------------------------------------------------

template <int HD, int MODE>
int scan(const ScanArgs& a, int B, int S, int H, cudaStream_t stream) {
  using L = Layout<HD>;
  // the ring's shared memory is allowed once a device
  static std::atomic<bool> allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !allowed[dev].load()) {
    err = cudaFuncSetAttribute(mlstm_bwd_scan_kernel<HD, MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::BYTES);
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) allowed[dev].store(true);
  }
  const long long blocks = (long long)B * H * Cfg<HD>::TILES;
  mlstm_bwd_scan_kernel<HD, MODE>
      <<<(unsigned)blocks, (Cfg<HD>::NW + 1) * 32, L::BYTES, stream>>>(
          a, B, S, H);
  return (int)cudaGetLastError();
}

struct Args {
  const float *q, *k, *v, *ip, *fp, *C0, *n0, *m0, *dh;
  float *dq, *dk, *dv, *di, *df;
  float4 *gate, *sc, *ch;
  float *nall, *p0, *p1, *p2;
};

template <int HD>
int launch(const Args& a, int B, int S, int H, cudaStream_t stream) {
  const long long n = (long long)B * S * H;
  if ((long long)B * H * Cfg<HD>::TILES > 0x7fffffffLL || n > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned heads = (unsigned)(B * H);
  const unsigned eblocks = (unsigned)((n + ET - 1) / ET);
  const int groups = HD / RW;
  mlstm_bwd_gates_kernel<<<heads, 32, 0, stream>>>(a.ip, a.fp, a.m0, a.gate,
                                                   S, H);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // mode 0: C^T dh into dq, n_t into nall, the n . q and q . C^T dh
  // partials into p0, p1
  ScanArgs s0{a.v,  a.dh,   a.k,  {a.q}, a.gate, a.sc, a.C0, a.n0,
              a.dq, a.nall, a.p0, a.p1};
  err = scan<HD, 0>(s0, B, S, H, stream);
  if (err) return err;
  mlstm_bwd_scalars_kernel<<<eblocks, ET, 0, stream>>>(a.p0, a.p1, a.sc,
                                                       (int)n, groups);
  err = (int)cudaGetLastError();
  if (err) return err;
  // mode 1: dv, the v . G k partials into p2
  ScanArgs s1{a.q,  a.k,     a.dh, {a.v},   a.gate, a.sc, nullptr, nullptr,
              a.dv, nullptr, a.p2, nullptr};
  err = scan<HD, 1>(s1, B, S, H, stream);
  if (err) return err;
  // mode 2: dk, dq in place, the dN . k and dN . n_{t-1} partials into p0,
  // p1 (mode 0's are spent)
  ScanArgs s2{a.dh, a.v,  a.q,  {a.k, a.nall, a.dq, a.nall}, a.gate, a.sc,
              nullptr, a.n0, a.dk, a.dq, a.p0, a.p1};
  err = scan<HD, 2>(s2, B, S, H, stream);
  if (err) return err;
  mlstm_bwd_sums_kernel<<<eblocks, ET, 0, stream>>>(
      a.p2, a.p0, a.p1, a.gate, a.sc, a.ch, (int)n, groups);
  err = (int)cudaGetLastError();
  if (err) return err;
  mlstm_bwd_chain_kernel<<<heads, 32, 0, stream>>>(a.gate, a.ch, a.di, a.df,
                                                   S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the seven kernels on `stream` (PyTorch's current stream) and
// returns the first cudaGetLastError() (or cudaFuncSetAttribute's error)
// that is not zero. q, k, v, dh, dq, dk, dv, nall (B, S, H, hd); i_pre,
// f_pre, di, df (B, S, H); the state before the scan C0 (B, H, hd, hd), n0
// (B, H, hd), m0 (B, H): contiguous float32, q, k, v and dh 16-byte aligned
// (copied by TMA). Scratch: gate, sc, ch (B, S, H) float4; p0, p1, p2
// (hd / 4, B, S, H) float32. hd one of 16, 32, 64, 128, 256, 512; S >= 1.
extern "C" int mlstm_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* i_pre,
    const void* f_pre, const void* C0, const void* n0, const void* m0,
    const void* dh, void* dq, void* dk, void* dv, void* di, void* df,
    void* gate, void* sc, void* ch, void* nall, void* p0, void* p1, void* p2,
    int B, int S, int H, int hd, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto c = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  const auto o4 = [](void* p) { return static_cast<float4*>(p); };
  const Args a{c(q),     c(k),     c(v),     c(i_pre), c(f_pre), c(C0),
               c(n0),    c(m0),    c(dh),    o(dq),    o(dk),    o(dv),
               o(di),    o(df),    o4(gate), o4(sc),   o4(ch),   o(nall),
               o(p0),    o(p1),    o(p2)};
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
