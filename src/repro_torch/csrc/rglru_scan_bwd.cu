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
// rglru_scan_backward_plain takes them; the coefficients are those of
// csrc/rglru_coeffs.cuh, which the forward kernel computes too.
//
// Design: the forward's time tiles run in reverse, in one launch, with
// every coefficient computed once. A tile is CW channels x TS steps of
// one batch row (TS the forward's, so the forward's carry buffer gives h
// at every tile start). Persistent blocks, as many as the card keeps
// resident, take tiles from a counter with the last time tile first, so
// a tile's successor (the same channels, the next TS steps) has always
// been taken by a running block. Thread (c, k) owns the SUB contiguous
// steps of sub-chunk k of channel c and keeps what the chain rule needs
// of them in registers (x, dh then g, i, r, a, e2, s). A tile
//   1. finds its x and dh in shared memory, copied there by cp.async
//      during the previous tile (element by element where W is not a
//      multiple of CW), and computes the coefficients of its steps, once,
//      in straight-line code: the reciprocal, division and square root by
//      their fast paths (csrc/rglru_coeffs.cuh), bitwise the CUDA
//      functions in the ranges that arise, the general routines for a
//      thread's whole batch of steps in the rare case one falls outside;
//   2. scans each sub-chunk into its forward aggregate (A, L: h_end = A
//      h_start + L) and its backward one (A' = the same a_t multiplied from
//      the last step down, L' = a_first g_first from a zero carry: c_out =
//      A' c_in + L', where c = a_t g_t is what step t hands to step t - 1),
//      into shared memory, then takes the next tile and issues its copies;
//   3. has warp w scan channel w's 32 sub-chunks, lane l the l-th: a
//      Kogge-Stone scan of the forward aggregates takes h from the tile's
//      start into each sub-chunk, one of the backward aggregates from the
//      top takes the successor's g carry into each, and lane 0 hands the
//      carry out of the tile to the predecessor. A carry and its flag are
//      one 64-bit word (relaxed atomic loads and stores: a word read with
//      the flag set holds its carry), read during the previous tile and
//      re-polled only if the successor had not written it yet;
//   4. re-runs g from the carry in and h_{t-1} from h in over the
//      thread's steps and applies the chain rule element by element: dx
//      into shared memory, then out by 16-byte pieces of rows, and the
//      thread's five parameter sums in step order;
//   5. adds a warp's four sub-chunks of a channel by shuffles, pairwise,
//      and the warps in order into the tile's partial sums, each a 64-bit
//      word with its flag; the group's last tile taken (time tile 0, the
//      last batch row) reads the group's words in tile order as they
//      arrive, so the result depends on no block's timing: no atomics on
//      the sums, two launches bitwise equal.
// The sub-chunks are SUB steps where the forward's are 32 and their
// carries come from a tree, so the float32 h_{t-1} here is the forward's
// up to the carries' rounding (within 1e-5 of max|h| of the plain loop,
// as the forward's). A tile zeroes each carry and partial-sum word it
// consumed and the last block to end the counters, so every launch
// leaves the workspace zero (a CUDA graph can replay it).
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): memory by bytes, the
// issue of instructions in practice. At (B, S, W) = (1, 4096, 4096) bf16,
// x and dh read once and dx written once are 100.7 MB, 30.0 us at 3.35
// TB/s. The coefficients' 4 expf, 2 reciprocals and sqrtf and the chain
// rule's division are 8 MUFU operations an element, 134 M at 16 an SM a
// clock, ~32 us. The function needs ~130 instructions an element with
// their FMA corrections, ~65 us at 4 warp instructions an SM a clock; the
// kernel issues more (the scans, the copies through shared memory, the
// range tests), and the per-tile latency of its barriers, copies and
// scans is not all hidden (tools/bench_decode_scan.py splits it).
// Registers hold the tile: CW = 8 channels keep 2 blocks (16 warps) on
// an SM, and a tile's copies in overlap the scans and chain rule of the
// tile before it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>
#include "rglru_coeffs.cuh"

namespace {

using namespace rglru;

constexpr int CW = 8;                // channels a tile: a warp each
constexpr int TS = 256;              // steps a tile: the forward's tile
constexpr int SUB = 8;               // steps a thread, contiguous
constexpr int SUBS = TS / SUB;       // sub-chunks a channel: a warp's lanes
constexpr int THREADS = CW * SUBS;   // a thread a (channel, sub-chunk)
constexpr int FCW = 32;              // the forward's channels a tile
constexpr int NP = 5;                // parameter sums: alpha_i, beta_i,
                                     // alpha_r, beta_r, nc
constexpr unsigned FULL = 0xffffffffu;
static_assert(SUBS == 32 && THREADS / 32 == CW && 32 % CW == 0 &&
                  NP * CW <= THREADS && TS % SUB == 0 && FCW % CW == 0,
              "tile shape");

// a g carry and its flag in one 64-bit word: the float's bits low, 1 high
__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_word(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ unsigned long long word_of(float c) {
  return (1ull << 32) | (unsigned)__float_as_int(c);
}

// a copy of 16 bytes into shared memory, zeros where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// a tile's rows in shared memory: one row of CW channels a step, a row
// of padding after every 8, so the 4 sub-chunks a warp reads at once sit
// in different banks; a row copied in and out in 16-byte pieces
template <typename T>
struct Rows {
  static constexpr int PER = CW * (int)sizeof(T) / 16;  // pieces a row
  static constexpr int EL = 16 / (int)sizeof(T);        // elements a piece
  static_assert(CW * sizeof(T) % 16 == 0, "rows of 16-byte pieces");
};
constexpr int ROWS = TS + TS / 8;
__device__ __forceinline__ int row_of(int t) { return t + (t >> 3); }

// where a tile lies: taken in order, the last time tile first
struct Tile {
  int taken, tt, b, ct;
};

// Workspace (int32, zero before the first launch and after every one):
// work[0] the next tile, work[1] blocks done, then a 64-bit carry word a
// (tile, channel), then a 64-bit partial-sum word a (tile, sum, channel).
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
                      int B, int S, int W, int n_tiles, int rows_ok) {
  // x and dh of this tile and the next (by parity), dx of this one, as
  // rows of shared memory
  extern __shared__ __align__(16) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);       // [2][ROWS][CW]
  T* ds = xs + 2 * ROWS * CW;               // [2][ROWS][CW]
  T* os = ds + 2 * ROWS * CW;               // [ROWS][CW]
  // per sub-chunk: forward (A, L) and backward (A', L') aggregates, then
  // h and the g carry entering it (a column of padding: no bank conflicts
  // where a warp reads one channel's sub-chunks)
  __shared__ float agg[4][SUBS][CW + 1];
  __shared__ float in_s[2][SUBS][CW + 1];
  __shared__ float red[CW][NP][CW];   // a warp's sums [warp][sum][channel]
  __shared__ Coef p_s[CW];            // the next tile's parameters
  __shared__ Tile take_s[2];          // the tile taken next, by parity
  unsigned long long* words = reinterpret_cast<unsigned long long*>(work + 2);
  unsigned long long* psum_words = words + (size_t)CW * n_tiles;
  const int n_ct = (W + CW - 1) / CW;
  const int n_tt = (S + TS - 1) / TS;
  const int n_fct = (W + FCW - 1) / FCW;
  const int row_tiles = B * n_ct;     // tiles of one time tile
  const int c = threadIdx.x % CW, sub = threadIdx.x / CW;
  const int lane = threadIdx.x % 32, wc = threadIdx.x / 32;  // wc: the
  // channel whose sub-chunks warp wc scans, lane its sub-chunk
  const int s0 = sub * SUB;
  // thread 0: a tile's place from its number
  auto locate = [&](int taken) {
    Tile t;
    t.taken = taken;
    t.tt = n_tt - 1 - taken / row_tiles;
    const int rt = taken % row_tiles;
    t.b = rt / n_ct;
    t.ct = rt % n_ct;
    return t;
  };
  // a tile's x and dh into the buffers of parity `buf`, zero past the
  // sequence's end: by cp.async of a row's pieces where W is a multiple
  // of CW on arrays aligned to a piece (rows_ok), else element by element,
  // zero past W too
  auto stage = [&](const Tile& tl, int buf) {
    const int t0 = tl.tt * TS, c0 = tl.ct * CW;
    const int steps = min(TS, S - t0);
    const size_t first = ((size_t)tl.b * S + t0) * W + c0;
    T* xb = xs + buf * ROWS * CW;
    T* db = ds + buf * ROWS * CW;
    if (rows_ok) {
      using R = Rows<T>;
#pragma unroll
      for (int k = threadIdx.x; k < TS * R::PER; k += THREADS) {
        const int r = k / R::PER, q = k % R::PER;
        const bool in = r < steps;
        const size_t at = in ? first + (size_t)r * W + q * R::EL : first;
        cp_async16(xb + row_of(r) * CW + q * R::EL, x + at, in);
        cp_async16(db + row_of(r) * CW + q * R::EL, dh + at, in);
      }
    } else {
#pragma unroll
      for (int k = threadIdx.x; k < TS * CW; k += THREADS) {
        const int r = k / CW, q = k % CW;
        const bool in = r < steps && c0 + q < W;
        const size_t at = first + (size_t)r * W + q;
        store(xb + row_of(r) * CW + q, in ? to_f(x[at]) : 0.f);
        store(db + row_of(r) * CW + q, in ? to_f(dh[at]) : 0.f);
      }
    }
  };
  float h0 = 0.f;               // h entering the tile, channel wc
  unsigned long long word = 0;  // the successor's g carry, channel wc
  // the forward's carry, the successor's carry word and (sub-chunk 0's
  // threads) the parameters of a tile
  auto prefetch = [&](const Tile& tl) {
    if (sub == 0) {
      const int ch = tl.ct * CW + c;
      Coef q = {0.f, 0.f, 0.f, 0.f, 0.f};
      if (ch < W) q = coef_of(a_param, alpha_i, beta_i, alpha_r, beta_r, ch);
      p_s[c] = q;
    }
    const int chw = tl.ct * CW + wc;
    h0 = 0.f;
    if (tl.tt > 0 && chw < W)
      h0 = hcarry[((size_t)(tl.tt - 1) * B * n_fct + (size_t)tl.b * n_fct +
                   chw / FCW) * FCW + chw % FCW];
    word = 0;
    const size_t succ = (size_t)(tl.tt + 1) * row_tiles + tl.b * n_ct + tl.ct;
    if (tl.tt + 1 < n_tt) word = load_word(words + succ * CW + wc);
  };
  if (threadIdx.x == 0) take_s[0] = locate(atomicAdd(work, 1));
  __syncthreads();
  Tile nt = take_s[0];
  if (nt.taken < n_tiles) {
    stage(nt, 1);
    prefetch(nt);
  }
  cp_async_wait_all();
  __syncthreads();
  for (int it = 1; nt.taken < n_tiles; ++it) {
    const Tile tl = nt;
    const int tile = tl.tt * row_tiles + tl.b * n_ct + tl.ct;
    const int steps = min(TS, S - tl.tt * TS);
    const int ch = tl.ct * CW + c;
    const bool on = ch < W;
    const int nvalid = on ? max(0, min(SUB, steps - s0)) : 0;
    const Coef p = p_s[c];
    // the next tile, taken now and read after the barrier below
    int taking = 0;
    if (threadIdx.x == 0) taking = atomicAdd(work, 1);
    float xv[SUB], gv[SUB];
    {
      const T* xb = xs + (it & 1) * ROWS * CW;
      const T* db = ds + (it & 1) * ROWS * CW;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        xv[j] = to_f(xb[row_of(s0 + j) * CW + c]);
        gv[j] = to_f(db[row_of(s0 + j) * CW + c]);
      }
    }
    // 1. the coefficients of the thread's steps, once, as the forward
    // computes them, in straight-line code: the sigmoids' 1 / (1 + e) by
    // the reciprocal's fast path (rcp_fast: 1 + e below 2^126), and by
    // the division for all the steps in the rare tile where one reaches it;
    // sqrt's operand lies in [1e-8, 1]. A step past the sequence's end is
    // the identity (a = 1, b = 0, dh = 0)
    float iv[SUB], rv[SUB], av[SUB], ev[SUB], sv[SUB];
    if (nvalid == 0) {  // past the end or past W: the identity
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        iv[j] = rv[j] = 0.f;
        av[j] = ev[j] = 1.f;
        sv[j] = 1e-4f;
      }
    } else {
      float ymax = 1.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float yi =
            __fadd_rn(1.f, expf(-__fadd_rn(__fmul_rn(xv[j], p.ai), p.bi)));
        const float yr =
            __fadd_rn(1.f, expf(-__fadd_rn(__fmul_rn(xv[j], p.ar), p.br)));
        iv[j] = rcp_fast(yi);
        rv[j] = rcp_fast(yr);
        ymax = fmaxf(ymax, fmaxf(yi, yr));
      }
      if (!(ymax < 0x1p126f)) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          iv[j] = sigmoid(__fadd_rn(__fmul_rn(xv[j], p.ai), p.bi));
          rv[j] = sigmoid(__fadd_rn(__fmul_rn(xv[j], p.ar), p.br));
        }
      }
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float log_a = __fmul_rn(p.nc, rv[j]);
        av[j] = s0 + j < steps ? expf(log_a) : 1.f;
        ev[j] = expf(__fmul_rn(2.f, log_a));
        sv[j] = sqrt_fast(fmaxf(__fsub_rn(1.f, ev[j]), 1e-8f));
      }
    }
    // 2. the sub-chunk's aggregates, forward and backward
    {
      float A = 1.f, L = 0.f;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        L = __fadd_rn(__fmul_rn(av[j], L),
                      __fmul_rn(sv[j], __fmul_rn(iv[j], xv[j])));
        A = __fmul_rn(av[j], A);
      }
      agg[0][sub][c] = A;
      agg[1][sub][c] = L;
      A = 1.f;
      float cc = 0.f;
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        cc = __fmul_rn(av[j], __fadd_rn(gv[j], cc));
        A = __fmul_rn(av[j], A);
      }
      agg[2][sub][c] = A;
      agg[3][sub][c] = cc;
    }
    if (threadIdx.x == 0) take_s[it & 1] = locate(taking);
    __syncthreads();
    nt = take_s[it & 1];
    // the next tile's x and dh, in flight during this tile's scans and
    // chain rule (their buffer was read before the barrier above)
    if (nt.taken < n_tiles) stage(nt, (it + 1) & 1);
    // 3. warp wc scans channel wc's sub-chunks, lane l the l-th: h into
    // each from the tile's h through the sub-chunks below (a forward
    // Kogge-Stone scan of the aggregates), the g carry into each from the
    // successor's through those above (a backward one), and lane 0 hands
    // the tile's carry to the predecessor
    {
      float fa = agg[0][lane][wc], fl = agg[1][lane][wc];
      float ba = agg[2][lane][wc], bl = agg[3][lane][wc];
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const float pa = __shfl_up_sync(FULL, fa, d);
        const float pl = __shfl_up_sync(FULL, fl, d);
        const float qa = __shfl_down_sync(FULL, ba, d);
        const float ql = __shfl_down_sync(FULL, bl, d);
        if (lane >= d) {
          fl = __fadd_rn(__fmul_rn(fa, pl), fl);
          fa = __fmul_rn(fa, pa);
        }
        if (lane + d < 32) {
          bl = __fadd_rn(__fmul_rn(ba, ql), bl);
          ba = __fmul_rn(ba, qa);
        }
      }
      float ea = __shfl_up_sync(FULL, fa, 1), el = __shfl_up_sync(FULL, fl, 1);
      float ga = __shfl_down_sync(FULL, ba, 1);
      float gl = __shfl_down_sync(FULL, bl, 1);
      if (lane == 0) {
        ea = 1.f;
        el = 0.f;
      }
      if (lane == 31) {
        ga = 1.f;
        gl = 0.f;
      }
      const bool has_succ = tl.tt + 1 < n_tt;
      unsigned long long* succ_word =
          words + (size_t)(tile + row_tiles) * CW + wc;
      if (has_succ && lane == 0) {
        while (!(word >> 32)) word = load_word(succ_word);
      }
      word = __shfl_sync(FULL, word, 0);
      const float cc = __int_as_float((int)(unsigned)word);
      if (lane == 0) {
        if (has_succ) store_word(succ_word, 0ull);  // consumed: zero
        if (tl.tt > 0)
          store_word(words + (size_t)tile * CW + wc,
                     word_of(__fadd_rn(__fmul_rn(ba, cc), bl)));
      }
      in_s[0][lane][wc] = __fadd_rn(__fmul_rn(ea, h0), el);
      in_s[1][lane][wc] = __fadd_rn(__fmul_rn(ga, cc), gl);
    }
    __syncthreads();
    // 4. g from the carry in; du = ds / (2 s) where u >= 1e-8 by the
    // division's fast path (div_fast), and by __fdiv_rn for all the steps
    // where one ds lies outside its range; then h_{t-1} from h in and the
    // chain rule, element by element: dx into shared memory, and the
    // thread's five sums in step order. A step past the end (or a channel
    // past W) has g = 0: its terms are zeros, and a thread with no step in
    // the sequence skips them
    {
      float cc = in_s[1][sub][c];
#pragma unroll
      for (int j = SUB - 1; j >= 0; --j) {
        gv[j] = __fadd_rn(gv[j], cc);
        cc = __fmul_rn(av[j], gv[j]);
      }
    }
    float du[SUB];
    {
      bool rare = false;
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float ds_j = __fmul_rn(gv[j], __fmul_rn(iv[j], xv[j]));
        const bool clamp = __fsub_rn(1.f, ev[j]) >= 1e-8f;
        du[j] = clamp ? div_fast(ds_j, __fmul_rn(2.f, sv[j])) : 0.f;
        const float ads = fabsf(ds_j);
        rare |= clamp & (((ads < 0x1p-100f) & (ds_j != 0.f)) |
                         !(ads <= 0x1p100f));
      }
      if (rare) {
#pragma unroll
        for (int j = 0; j < SUB; ++j) {
          const float ds_j = __fmul_rn(gv[j], __fmul_rn(iv[j], xv[j]));
          du[j] = __fsub_rn(1.f, ev[j]) >= 1e-8f
                      ? __fdiv_rn(ds_j, __fmul_rn(2.f, sv[j]))
                      : 0.f;
        }
      }
    }
    float acc[NP] = {0.f, 0.f, 0.f, 0.f, 0.f};
    if (nvalid > 0) {
      float hv = in_s[0][sub][c];
#pragma unroll
      for (int j = 0; j < SUB; ++j) {
        const float xf = xv[j], g = gv[j], i_t = iv[j], r_t = rv[j];
        const float a_t = av[j], e2 = ev[j], s = sv[j];
        const float ix = __fmul_rn(i_t, xf);
        const float da = __fmul_rn(g, hv);
        hv = __fadd_rn(__fmul_rn(a_t, hv), __fmul_rn(s, ix));
        const float dix = __fmul_rn(g, s);
        const float dlog_a = __fsub_rn(__fmul_rn(da, a_t),
                                       __fmul_rn(2.f, __fmul_rn(du[j], e2)));
        const float di = __fmul_rn(dix, xf);
        const float dr = __fmul_rn(dlog_a, p.nc);
        const float dzi =
            __fmul_rn(di, __fmul_rn(i_t, __fsub_rn(1.f, i_t)));
        const float dzr =
            __fmul_rn(dr, __fmul_rn(r_t, __fsub_rn(1.f, r_t)));
        const float dxf = __fadd_rn(
            __fadd_rn(__fmul_rn(dix, i_t), __fmul_rn(dzi, p.ai)),
            __fmul_rn(dzr, p.ar));
        store(os + row_of(s0 + j) * CW + c, dxf);
        acc[0] = __fadd_rn(acc[0], __fmul_rn(dzi, xf));
        acc[1] = __fadd_rn(acc[1], dzi);
        acc[2] = __fadd_rn(acc[2], __fmul_rn(dzr, xf));
        acc[3] = __fadd_rn(acc[3], dzr);
        acc[4] = __fadd_rn(acc[4], __fmul_rn(dlog_a, r_t));
      }
    }
    // 5. a warp's four sub-chunks of a channel, pairwise:
    // (s0 + s1) + (s2 + s3)
#pragma unroll
    for (int j = 0; j < NP; ++j) {
#pragma unroll
      for (int o = CW; o < 32; o *= 2)
        acc[j] = __fadd_rn(acc[j], __shfl_xor_sync(FULL, acc[j], o));
      if (lane < CW) red[wc][j][c] = acc[j];
    }
    if (nt.taken < n_tiles) prefetch(nt);
    cp_async_wait_all();
    __syncthreads();
    // 6. dx out of shared memory by pieces of rows (or element by element)
    {
      const int t0 = tl.tt * TS, c0 = tl.ct * CW;
      const size_t first = ((size_t)tl.b * S + t0) * W + c0;
      if (rows_ok) {
        using R = Rows<T>;
#pragma unroll
        for (int k = threadIdx.x; k < TS * R::PER; k += THREADS) {
          const int r = k / R::PER, q = k % R::PER;
          if (r < steps)
            *reinterpret_cast<uint4*>(dx + first + (size_t)r * W +
                                      q * R::EL) =
                *reinterpret_cast<const uint4*>(os + row_of(r) * CW +
                                                q * R::EL);
        }
      } else {
#pragma unroll
        for (int k = threadIdx.x; k < TS * CW; k += THREADS) {
          const int r = k / CW, q = k % CW;
          if (r < steps && c0 + q < W)
            dx[first + (size_t)r * W + q] = os[row_of(r) * CW + q];
        }
      }
    }
    // 7. warp 0 adds the warps' sums in order into the tile's partial
    // sums, each a 64-bit word with its flag; the group's last tile taken
    // (time tile 0, the last batch row) reads the group's words in tile
    // order as they arrive, so the result depends on no block's timing
    if (threadIdx.x < NP * CW) {
      const int j = threadIdx.x / CW, cj = threadIdx.x % CW;
      float mine = red[0][j][cj];
#pragma unroll
      for (int w = 1; w < CW; ++w) mine = __fadd_rn(mine, red[w][j][cj]);
      if (!(tl.tt == 0 && tl.b == B - 1)) {
        store_word(psum_words + ((size_t)tile * NP + j) * CW + cj,
                   word_of(mine));
      } else {
        const int chj = tl.ct * CW + cj;
        float sum = 0.f;
        for (int t2 = 0; t2 < n_tt; ++t2)
          for (int b2 = 0; b2 < B; ++b2) {
            const size_t t3 = ((size_t)t2 * B + b2) * n_ct + tl.ct;
            float v = mine;
            if (t3 != (size_t)tile) {
              unsigned long long* at = psum_words + (t3 * NP + j) * CW + cj;
              unsigned long long wd;
              while (!((wd = load_word(at)) >> 32)) __nanosleep(64);
              store_word(at, 0ull);  // consumed: zero
              v = __int_as_float((int)(unsigned)wd);
            }
            sum = __fadd_rn(sum, v);
          }
        // rows of grads: a_param, alpha_i, beta_i, alpha_r, beta_r
        if (chj < W) {
          if (j == NP - 1)
            sum = __fmul_rn(__fmul_rn(sum, -8.0f), sigmoid(a_param[chj]));
          grads[(size_t)((j + 1) % NP) * W + chj] = sum;
        }
      }
    }
  }
  // the last block to finish zeroes the counters
  if (threadIdx.x == 0 && atomicAdd(work + 1, 1) == (int)gridDim.x - 1) {
    work[0] = 0;
    work[1] = 0;
  }
}

template <typename T>
constexpr size_t smem_bytes() {
  return 5 * ROWS * CW * sizeof(T);
}

// blocks the card keeps resident at once, per device (asked once, with
// the dynamic shared memory the kernel takes set then)
template <typename T>
int resident_blocks(int dev) {
  static int known[64] = {};
  if (dev >= 0 && dev < 64 && known[dev]) return known[dev];
  int per_sm = 0, sms = 0;
  cudaFuncSetAttribute(rglru_scan_bwd_kernel<T>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)smem_bytes<T>());
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, rglru_scan_bwd_kernel<T>, THREADS, smem_bytes<T>());
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaGetLastError();  // a refused query leaves no error for the launch
  const int n = per_sm > 0 && sms > 0 ? per_sm * sms : 1;
  if (dev >= 0 && dev < 64) known[dev] = n;
  return n;
}

template <typename T>
int launch(const void* x, const float* const* prm, const void* dh,
           const float* hcarry, void* dx, float* grads, int* work, int B,
           int S, int W, cudaStream_t stream) {
  const long long n_tiles =
      (long long)B * ((W + CW - 1) / CW) * ((S + TS - 1) / TS);
  if (2 + 2LL * (NP + 1) * CW * n_tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  const long long resident = resident_blocks<T>(dev);
  const int grid = (int)(n_tiles < resident ? n_tiles : resident);
  // rows copied by pieces: W a multiple of CW on arrays aligned to a piece
  const int rows_ok =
      W % CW == 0 &&
      ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(dh) |
        reinterpret_cast<uintptr_t>(dx)) & 15) == 0;
  rglru_scan_bwd_kernel<T><<<grid, THREADS, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(x), prm[0], prm[1], prm[2], prm[3], prm[4],
      static_cast<const T*>(dh), hcarry, static_cast<T*>(dx), grads, work, B,
      S, W, (int)n_tiles, rows_ok);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// x, dh and dx (B, S, W) contiguous, float32 (is_bf16 = 0) or bfloat16; the
// five parameters (W,) float32; hcarry, the forward launch's carry buffer
// (csrc/rglru_scan.cu: float32, a tile of 32 channels x 256 steps' outgoing
// h at tile x 32 + c); grads (5, W) float32, rows d a_param, d alpha_i,
// d beta_i, d alpha_r, d beta_r. work, int32, 2 + 96 x tiles entries,
// tiles = B x ceil(W / 8) x ceil(S / 256) (kernels/rglru_scan.py
// backward_tiles), zero before the first launch (each launch leaves it
// zero).
extern "C" int rglru_scan_bwd_launch(const void* x, const void* a_param,
                                     const void* alpha_i, const void* beta_i,
                                     const void* alpha_r, const void* beta_r,
                                     const void* dh, const void* hcarry,
                                     void* dx, void* grads, void* work, int B,
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
  if (is_bf16)
    return launch<__nv_bfloat16>(x, prm, dh, hc, dx, g, wk, B, S, W, st);
  return launch<float>(x, prm, dh, hc, dx, g, wk, B, S, W, st);
}
