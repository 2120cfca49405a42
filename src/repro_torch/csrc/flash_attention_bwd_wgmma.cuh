// bf16 flash-attention gradient for Hopper's tensor cores (sm_90a): TMA
// loads, mbarrier rings, warp-specialized warpgroups, wgmma.
//
// Included by flash_attention_bwd.cu, whose C entry
// flash_attention_bwd_wgmma_launch runs every bfloat16 call here (head dims
// up to 256; float32 calls take the split-TF32 kernels there, through
// flash_attention_bwd_launch). It reuses the PTX helpers of the forward's
// header (mbarriers, TMA, the 128-byte-swizzle wgmma descriptors and
// wrappers, fence_regs, ex2) by including it.
//
// Inputs: q, dO (B, H, S, hd), k, v (B, H, T, hd) as strided views, o
// (B, H, S, hd), and the forward's log-sum-exp of each query row in base 2
// and in the forward's units (lse_i = m_i + log2 l_i with scores s * scale *
// log2 e), a float32 row of lse_rows(S) entries per (batch, head). Three
// kernels on the caller's stream:
//   1. rows_kernel: D_i = dO_i . o_i in float32 (0 in the padding rows), one
//      warp a row. It only moves bytes.
//   2. dkdv_kernel: one block per (batch x head, 128 keys; 64 at hd 256).
//      Warpgroup 0 is the producer (setmaxnreg 24; one thread issues the
//      TMA loads): K and V once, then the query tiles that can see the
//      block's keys (64 rows of Q and dO with their 64 lse and D values)
//      through a ring of STAGES stages with a full and an empty barrier
//      each. Warpgroups 1 and 2 are the consumers (setmaxnreg 240).
//      Head dims up to 128: each consumer owns 64 keys. Per tile: S^T = K
//      Q^T and dP^T = V dO^T by wgmma m64n64k16 (both operands K-major from
//      shared memory, f32 accumulators); in registers P^T = exp2(S^T *
//      scale log2 e - lse) under the mask (edge tiles only) and dS^T = P^T
//      (dP^T - D); then dV += P^T dO and dK += dS^T Q by wgmma with the A
//      operand from registers (the accumulator layout is the A-fragment
//      layout) and B = dO or Q from shared memory, MN-major (the
//      transpose-B bit).
//      Head dim 256: a 64 x 256 f32 accumulator is 128 registers a thread,
//      so a consumer cannot hold both dK and dV of 64 keys, and 128 keys of
//      K and V (128 KB) beside a two-stage ring of 64-row Q and dO tiles
//      (128 KB) pass the 227 KB a block may have. So the block owns 64 keys
//      and consumer c owns columns 128c .. 128c + 127 of dK and dV (64 + 64
//      accumulators, as a consumer holds at 128). Per tile consumer 0
//      computes S^T and P^T, consumer 1 dP^T (each over all 256 dims, so
//      neither product is computed twice); each writes its 64 x 64 f32
//      tile to shared memory (16 KB each, in its own accumulator layout,
//      so thread t of one reads what thread t of the other wrote), both
//      read the other's, and both compute the same dS^T from the same
//      bits. Then each runs dV += P^T dO and dK += dS^T Q on its half of
//      dO's and Q's columns. Two named barriers of the 256 consumer
//      threads order the exchange: one after the writes, one before the
//      next tile's writes (the other consumer has read).
//   3. dq_kernel: one block per (batch x head, 128 query rows); Q, dO and
//      their lse and D are loaded once, K and V tiles stream through the
//      ring (64 keys, two stages; at hd 256 32 keys, three stages, so Q
//      and dO's 128 KB and the ring fit); each consumer recomputes S and dP
//      for its 64 rows and accumulates dQ += dS K (dS from registers, K
//      MN-major), over all head dims (at 256, 128 registers).
// Every output element is owned by one thread of one block and summed in a
// fixed order (query tiles, or key tiles, in order): no atomics, so two
// launches on the same inputs agree bit for bit.
//
// Numerics. P, dS and every sum are float32. Each product whose A operand
// is P or dS (P^T dO, dS^T Q, dS K) splits it into hi = bf16(x) and lo =
// bf16(x - hi), two wgmmas into one f32 accumulator, as the forward splits
// P for P.V: rounded once, each of the three puts thousands of gradients
// outside the bf16 limit the checks hold the kernel to
// (tests/test_torch_kernels.py emulates this product by product). dK is
// scaled by 1/sqrt(hd) once at the store, dq too; the gradients are rounded
// to bf16 with round-to-nearest-even. The hd-256 exchange moves P^T and dP^T
// as f32, so its arithmetic is the same as at 128.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W), at S = T = 4096, H = 32,
// hd = 128, causal: the least work is 5 products of 2 FLOP per visible pair
// and head dim, 343.7 GFLOP (0.3475 ms at 989 TFLOP/s bf16) against 268 MB
// (0.08 ms at 3.35 TB/s): the operations bound it. This design issues 10
// such products (S^T, dP^T, P^T dO twice, dS^T Q twice; S, dP, dS K twice),
// 687 GFLOP, so it cannot beat 0.69 ms. At recurrentgemma-9b's local
// attention (S = T = 4096, 16 heads of 256, causal, window 2048: 6,292,480
// visible pairs a head) the least work is 257.7 GFLOP (0.2606 ms) against
// 268 MB (0.08 ms); the hd-256 layout issues the same 10 products, 515.4
// GFLOP, so it cannot beat 0.521 ms.
#pragma once

// the forward header's helpers, not its kernel (the forward library's)
#define WGMMA_FA_HELPERS_ONLY
#include "flash_attention_wgmma.cuh"

namespace wgmma_fa_bwd {

using wgmma_fa::desc_sw128;
using wgmma_fa::ex2;
using wgmma_fa::fence_regs;
using wgmma_fa::FULL;
using wgmma_fa::make_map;
using wgmma_fa::mbar_arrive;
using wgmma_fa::mbar_expect_tx;
using wgmma_fa::mbar_init;
using wgmma_fa::mbar_wait;
using wgmma_fa::smem_addr;
using wgmma_fa::split2;
using wgmma_fa::tma_load;
using wgmma_fa::wgmma_commit;
using wgmma_fa::wgmma_fence;
using wgmma_fa::wgmma_rs_n128;
using wgmma_fa::wgmma_rs_n256;
using wgmma_fa::wgmma_rs_n64;
using wgmma_fa::wgmma_ss_n64;
using wgmma_fa::wgmma_wait_all;

constexpr int OWN = 128;   // keys (dkdv) or query rows (dq) a block owns
constexpr int TILE = 64;   // query rows (dkdv) or keys (dq) a tile
constexpr int STAGES = 2;  // ring depth
constexpr int THREADS = 384;  // producer warpgroup + 2 consumers
constexpr int CONSUMER_WARPS = 8;
constexpr int ROWS_THREADS = 256;  // rows_kernel: 8 rows a block
constexpr int MAX_SMEM = 232448;   // a block's shared memory on an H100

// the layout at a padded head dim: keys a dkdv block owns, keys a dq tile
// and the dq ring's depth (see the header)
template <int HD>
struct Layout {
  static constexpr int KEYS = HD == 256 ? 64 : OWN;
  static constexpr int KT = HD == 256 ? 32 : TILE;
  static constexpr int DQ_STAGES = HD == 256 ? 3 : STAGES;
  // the hd-256 exchange of P^T and dP^T: 128 threads x 32 floats each
  static constexpr int XCH = HD == 256 ? 2 * 128 * 32 * 4 : 0;
};

using wgmma_fa::lse_rows;
// the lse and D rows of one (batch, head) are padded to the forward's 128-
// row blocks, so a block's 128 rows, or a tile's 64, are one aligned bulk
// copy that stays inside them
static_assert(wgmma_fa::BQ % OWN == 0 && OWN % TILE == 0,
              "lse rows must hold whole owned blocks and tiles");

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

// a named barrier of the two consumer warpgroups (256 threads); id 0 is
// __syncthreads'
__device__ __forceinline__ void consumers_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

// D (64 x 32, f32) = or += A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ bool visible(int i, int j, int S, int Tk,
                                        int causal, int window,
                                        int q_offset) {
  const int pos = i + q_offset;
  bool vis = i < S && j < Tk;
  if (causal) vis = vis && pos >= j;
  if (window > 0) vis = vis && (pos - j) < window;
  return vis;
}

// whether a (ROWS query rows from i0) x (KEYS keys from j0) tile needs the
// mask
template <int ROWS, int KEYS>
__device__ __forceinline__ bool edge_tile(int i0, int j0, int S, int Tk,
                                          int causal, int window,
                                          int q_offset) {
  return i0 + ROWS > S || j0 + KEYS > Tk ||
         (causal && i0 + q_offset < j0 + KEYS - 1) ||
         (window > 0 && i0 + ROWS - 1 + q_offset - j0 >= window);
}

// D (64 x N) += A (registers, 64 x K as K / 16 k16 fragments, hi and lo) .
// B, where B is an N-column tile in shared memory read MN-major (its rows
// are the K dimension; its 64-column blocks lie `rows` * 128 bytes apart)
template <int N, int K>
__device__ __forceinline__ void wgmma_rs_split(float (&d)[N / 2],
                                               const uint32_t (&hi)[K / 16][4],
                                               const uint32_t (&lo)[K / 16][4],
                                               uint32_t tile, int rows) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t db = desc_sw128(tile + kk * 2048, rows * 128, 1024);
    if constexpr (N == 64) {
      wgmma_rs_n64(d, hi[kk], db, 1);
      wgmma_rs_n64(d, lo[kk], db, 1);
    } else if constexpr (N == 128) {
      wgmma_rs_n128(d, hi[kk], db, 1);
      wgmma_rs_n128(d, lo[kk], db, 1);
    } else {
      wgmma_rs_n256(d, hi[kk], db, 1);
      wgmma_rs_n256(d, lo[kk], db, 1);
    }
  }
}

// D (64 x N, f32) = A . B^T over the head dim: A the 64 rows at `a` of a
// tile whose 64-column blocks hold A_ROWS rows, B an N-row tile whose
// column blocks hold B_ROWS rows
template <int HD, int N, int A_ROWS, int B_ROWS>
__device__ __forceinline__ void wgmma_ss_rows(float (&d)[N / 2], uint32_t a,
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t col = (kk % 4) * 32;
    const uint64_t da = desc_sw128(a + (kk / 4) * A_ROWS * 128 + col, 16,
                                   1024);
    const uint64_t db = desc_sw128(b + (kk / 4) * B_ROWS * 128 + col, 16,
                                   1024);
    if constexpr (N == 64)
      wgmma_ss_n64(d, da, db, kk > 0);
    else
      wgmma_ss_n32(d, da, db, kk > 0);
  }
}

// the 64 x N accumulator (rows row0 and row0 + 8 of each thread) times
// `mul`, rounded to bf16, into rows below `rows` and columns below `hd` of
// a strided output
template <int N>
__device__ __forceinline__ void store_rows(__nv_bfloat16* out, long long ss,
                                           const float (&acc)[N / 2],
                                           int row0, int rows, int hd, int t,
                                           float mul, int pairs) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    __nv_bfloat16* orow = out + row * ss;
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const int col = 8 * i + 2 * t;
      if (col >= hd) continue;
      const float v0 = acc[4 * i + 2 * r] * mul;
      const float v1 = acc[4 * i + 2 * r + 1] * mul;
      if (pairs && col + 1 < hd) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(v0, v1);
      } else {
        orow[col] = __float2bfloat16_rn(v0);
        if (col + 1 < hd) orow[col + 1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

// element strides of a (batch, head, seq, dim) view; dim is contiguous
struct View {
  long long b, h, s;
};

// D_i = sum_d dO_id o_id for every row of every (batch, head), one warp a
// row with a fixed shuffle tree; 0 in the padding rows S .. lse_rows(S)
__global__ void __launch_bounds__(ROWS_THREADS)
rows_kernel(const __nv_bfloat16* __restrict__ o,
            const __nv_bfloat16* __restrict__ dout, float* __restrict__ dd,
            int H, int S, int hd, View ov, View dov, long long n_rows) {
  const long long r =
      (long long)blockIdx.x * (ROWS_THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_rows) return;
  const int rows = lse_rows(S);
  const int bh = static_cast<int>(r / rows), i = static_cast<int>(r % rows);
  float acc = 0.0f;
  if (i < S) {
    const int b = bh / H, h = bh % H;
    const __nv_bfloat16* op = o + b * ov.b + h * ov.h + i * ov.s;
    const __nv_bfloat16* dp = dout + b * dov.b + h * dov.h + i * dov.s;
    for (int d = lane; d < hd; d += 32)
      acc = fmaf(__bfloat162float(dp[d]), __bfloat162float(op[d]), acc);
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) acc += __shfl_xor_sync(FULL, acc, m);
  if (lane == 0) dd[r] = acc;
}

// HD: the head dim padded to 64, 128 or 256
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tm_q,
            const __grid_constant__ CUtensorMap tm_do,
            const __grid_constant__ CUtensorMap tm_k,
            const __grid_constant__ CUtensorMap tm_v,
            const float* __restrict__ lse, const float* __restrict__ dd,
            __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
            View dkv, View dvv, int H, int S, int Tk, int hd, int causal,
            int window, int q_offset, float scale_log2, float scale,
            int pairs) {
  constexpr int NB = HD / 64;              // 128-byte column blocks
  constexpr int KEYS = Layout<HD>::KEYS;   // keys the block owns
  constexpr int OWN_BYTES = KEYS * HD * 2;   // K or V
  constexpr int TILE_BYTES = TILE * HD * 2;  // a Q or dO tile
  constexpr int ROW_BYTES = TILE * 4;      // a tile's lse or D
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sk = base, sv = sk + OWN_BYTES;
  const uint32_t sq = sv + OWN_BYTES;           // STAGES Q tiles
  const uint32_t sdo = sq + STAGES * TILE_BYTES;  // STAGES dO tiles
  const uint32_t srow = sdo + STAGES * TILE_BYTES;  // STAGES (lse, D)
  const uint32_t sxch = srow + STAGES * 2 * ROW_BYTES;  // hd 256: exchange
  const uint32_t bars = sxch + Layout<HD>::XCH;
  const uint32_t kv_full = bars;                // then, per stage:
  const uint32_t full = bars + 8;               //   tile arrived
  const uint32_t empty = full + 8 * STAGES;     //   tile read

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int j0 = blockIdx.x * KEYS;  // key 0's block, the most rows, first
  const int n_rows = lse_rows(S);
  // the query tiles any key of this block is visible to
  const int j_last = min(j0 + KEYS, Tk) - 1;
  int i_begin = causal ? max(0, j0 - q_offset) : 0;
  i_begin -= i_begin % TILE;
  const int i_end = window > 0 ? min(S, j_last + window - q_offset) : S;
  const int n_tiles =
      i_end > i_begin ? (i_end - i_begin + TILE - 1) / TILE : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * OWN_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load(sk + c * KEYS * 128, &tm_k, kv_full, c * 64, j0, h, b);
        tma_load(sv + c * KEYS * 128, &tm_v, kv_full, c * 64, j0, h, b);
      }
      const float* lse_bh = lse + (long long)bh * n_rows;
      const float* dd_bh = dd + (long long)bh * n_rows;
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        const uint32_t phase = (n / STAGES) & 1;
        const int i0 = i_begin + n * TILE;
        mbar_wait(empty + 8 * s, phase ^ 1);  // round 0 passes at once
        mbar_expect_tx(full + 8 * s, 2 * TILE_BYTES + 2 * ROW_BYTES);
        for (int c = 0; c < NB; ++c) {
          tma_load(sq + s * TILE_BYTES + c * TILE * 128, &tm_q, full + 8 * s,
                   c * 64, i0, h, b);
          tma_load(sdo + s * TILE_BYTES + c * TILE * 128, &tm_do,
                   full + 8 * s, c * 64, i0, h, b);
        }
        const uint32_t rows_s = srow + s * 2 * ROW_BYTES;
        bulk_load(rows_s, lse_bh + i0, ROW_BYTES, full + 8 * s);
        bulk_load(rows_s + ROW_BYTES, dd_bh + i0, ROW_BYTES, full + 8 * s);
      }
    }
  } else if constexpr (HD <= 128) {
    // consumers: warpgroup wg - 1 owns keys kj0 .. kj0 + 63
    constexpr int REGS = HD / 2;  // dK or dV accumulators a thread
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int kj0 = j0 + TILE * c;
    const int key0 = kj0 + 16 * warp + g;  // keys key0, key0 + 8
    const uint32_t k_rows = sk + TILE * c * 128, v_rows = sv + TILE * c * 128;

    float acc_k[REGS], acc_v[REGS];
#pragma unroll
    for (int e = 0; e < REGS; ++e) acc_k[e] = acc_v[e] = 0.0f;
    mbar_wait(kv_full, 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;
      const int i0 = i_begin + n * TILE;
      const uint32_t q_tile = sq + s * TILE_BYTES;
      const uint32_t do_tile = sdo + s * TILE_BYTES;
      const float* lse_t =
          reinterpret_cast<const float*>(gbase + (srow - base) +
                                         s * 2 * ROW_BYTES);
      const float* dd_t = lse_t + TILE;

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 query rows)
      float st[32], dpt[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = dpt[e] = 0.0f;
      mbar_wait(full + 8 * s, phase);
      wgmma_fence();
      wgmma_ss_rows<HD, 64, OWN, TILE>(st, k_rows, q_tile);
      wgmma_ss_rows<HD, 64, OWN, TILE>(dpt, v_rows, do_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T in place; thread element e is key key0 + 8 ((e % 4) /
      // 2), query row i0 + 8 (e / 4) + 2 t + e % 2
      const bool edge =
          edge_tile<TILE, TILE>(i0, kj0, S, Tk, causal, window, q_offset);
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int ci = 8 * (e / 4) + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + ci);
        const float2 d2 = *reinterpret_cast<const float2*>(dd_t + ci);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float p = ex2(st[e + u] * scale_log2 - (u ? l2.y : l2.x));
          if (edge) {
            const int j = key0 + 8 * ((e % 4) / 2);
            p = visible(i0 + ci + u, j, S, Tk, causal, window, q_offset)
                    ? p
                    : 0.0f;
          }
          st[e + u] = p;
          dpt[e + u] = p * (dpt[e + u] - (u ? d2.y : d2.x));
        }
      }
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          split2(st[8 * kk + 2 * a], st[8 * kk + 2 * a + 1], p_hi[kk][a],
                 p_lo[kk][a]);
          split2(dpt[8 * kk + 2 * a], dpt[8 * kk + 2 * a + 1], ds_hi[kk][a],
                 ds_lo[kk][a]);
        }
      }

      // dV += P^T dO, dK += dS^T Q (16 query rows per wgmma)
      wgmma_fence();
      wgmma_rs_split<HD, TILE>(acc_v, p_hi, p_lo, do_tile, TILE);
      wgmma_rs_split<HD, TILE>(acc_k, ds_hi, ds_lo, q_tile, TILE);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_v);
      fence_regs(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    store_rows<HD>(dk + b * dkv.b + h * dkv.h, dkv.s, acc_k, key0, Tk, hd, t,
                   scale, pairs);
    store_rows<HD>(dv + b * dvv.b + h * dvv.h, dvv.s, acc_v, key0, Tk, hd, t,
                   1.0f, pairs);
  } else {
    // consumers at hd 256: both own the block's 64 keys; warpgroup wg - 1
    // owns columns 128 c .. 128 c + 127 of dK and dV, and computes S^T
    // (c = 0) or dP^T (c = 1) for both
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int key0 = j0 + 16 * warp + g;  // keys key0, key0 + 8
    // the exchange: [matrix c][8 float4s][128 threads], so a warp's float4
    // stores and loads are 512 contiguous bytes
    float4* x_mine = reinterpret_cast<float4*>(
                         const_cast<uint8_t*>(gbase) + (sxch - base)) +
                     c * 8 * 128 + tid;
    const float4* x_other = x_mine + (1 - 2 * c) * 8 * 128;
    const uint32_t a_rows = c ? sv : sk;
    const uint32_t half = c * 2 * TILE * 128;  // column blocks 2c, 2c + 1

    float acc_k[64], acc_v[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc_k[e] = acc_v[e] = 0.0f;
    mbar_wait(kv_full, 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;
      const int i0 = i_begin + n * TILE;
      const uint32_t q_tile = sq + s * TILE_BYTES;
      const uint32_t do_tile = sdo + s * TILE_BYTES;
      const float* lse_t =
          reinterpret_cast<const float*>(gbase + (srow - base) +
                                         s * 2 * ROW_BYTES);
      const float* dd_t = lse_t + TILE;

      // S^T = K Q^T (c = 0) or dP^T = V dO^T (c = 1), 64 keys x 64 rows
      float mine[32], other[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) mine[e] = 0.0f;
      mbar_wait(full + 8 * s, phase);
      wgmma_fence();
      wgmma_ss_rows<HD, 64, KEYS, TILE>(mine, a_rows, c ? do_tile : q_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(mine);

      // P^T in place (c = 0); thread element e is key key0 + 8 ((e % 4) /
      // 2), query row i0 + 8 (e / 4) + 2 t + e % 2
      if (c == 0) {
        const bool edge =
            edge_tile<TILE, KEYS>(i0, j0, S, Tk, causal, window, q_offset);
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int ci = 8 * (e / 4) + 2 * t;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_t + ci);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            float p = ex2(mine[e + u] * scale_log2 - (u ? l2.y : l2.x));
            if (edge) {
              const int j = key0 + 8 * ((e % 4) / 2);
              p = visible(i0 + ci + u, j, S, Tk, causal, window, q_offset)
                      ? p
                      : 0.0f;
            }
            mine[e + u] = p;
          }
        }
      }
      if (n > 0) consumers_sync(2);  // the other has read the last tile's
#pragma unroll
      for (int f = 0; f < 8; ++f)
        x_mine[f * 128] = make_float4(mine[4 * f], mine[4 * f + 1],
                                      mine[4 * f + 2], mine[4 * f + 3]);
      consumers_sync(1);
#pragma unroll
      for (int f = 0; f < 8; ++f) {
        const float4 x = x_other[f * 128];
        other[4 * f] = x.x;
        other[4 * f + 1] = x.y;
        other[4 * f + 2] = x.z;
        other[4 * f + 3] = x.w;
      }

      // P^T into `mine`, dS^T = P^T (dP^T - D) into `other`: the same bits
      // in both warpgroups
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int ci = 8 * (e / 4) + 2 * t;
        const float2 d2 = *reinterpret_cast<const float2*>(dd_t + ci);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float p = c ? other[e + u] : mine[e + u];
          const float dp = c ? mine[e + u] : other[e + u];
          mine[e + u] = p;
          other[e + u] = p * (dp - (u ? d2.y : d2.x));
        }
      }
      uint32_t p_hi[4][4], p_lo[4][4], ds_hi[4][4], ds_lo[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          split2(mine[8 * kk + 2 * a], mine[8 * kk + 2 * a + 1], p_hi[kk][a],
                 p_lo[kk][a]);
          split2(other[8 * kk + 2 * a], other[8 * kk + 2 * a + 1],
                 ds_hi[kk][a], ds_lo[kk][a]);
        }
      }

      // dV += P^T dO, dK += dS^T Q on this warpgroup's 128 columns
      wgmma_fence();
      wgmma_rs_split<128, TILE>(acc_v, p_hi, p_lo, do_tile + half, TILE);
      wgmma_rs_split<128, TILE>(acc_k, ds_hi, ds_lo, q_tile + half, TILE);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc_v);
      fence_regs(acc_k);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    store_rows<128>(dk + b * dkv.b + h * dkv.h + 128 * c, dkv.s, acc_k, key0,
                    Tk, hd - 128 * c, t, scale, pairs);
    store_rows<128>(dv + b * dvv.b + h * dvv.h + 128 * c, dvv.s, acc_v, key0,
                    Tk, hd - 128 * c, t, 1.0f, pairs);
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
dq_kernel(const __grid_constant__ CUtensorMap tm_q,
          const __grid_constant__ CUtensorMap tm_do,
          const __grid_constant__ CUtensorMap tm_k,
          const __grid_constant__ CUtensorMap tm_v,
          const float* __restrict__ lse, const float* __restrict__ dd,
          __nv_bfloat16* __restrict__ dq, View dqv, int H, int S, int Tk,
          int hd, int causal, int window, int q_offset, float scale_log2,
          float scale, int pairs) {
  constexpr int NB = HD / 64;
  constexpr int KT = Layout<HD>::KT;         // keys a K or V tile
  constexpr int NST = Layout<HD>::DQ_STAGES;  // ring depth
  constexpr int OWN_BYTES = OWN * HD * 2;   // Q or dO
  constexpr int TILE_BYTES = KT * HD * 2;   // a K or V tile
  constexpr int ROW_BYTES = OWN * 4;        // the block's lse or D
  constexpr int REGS = HD / 2;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint8_t* gbase = smem_raw + (base - raw);
  const uint32_t sq = base, sdo = sq + OWN_BYTES;
  const uint32_t sk = sdo + OWN_BYTES;            // NST K tiles
  const uint32_t sv = sk + NST * TILE_BYTES;      // NST V tiles
  const uint32_t srow = sv + NST * TILE_BYTES;    // lse, then D
  const uint32_t bars = srow + 2 * ROW_BYTES;
  const uint32_t q_full = bars;
  const uint32_t full = bars + 8;
  const uint32_t empty = full + 8 * NST;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * OWN;  // longest rows first
  const int n_rows = lse_rows(S);
  // keys any real row of this block can see
  const int pos_lo = i0 + q_offset;
  const int pos_hi = min(i0 + OWN, S) - 1 + q_offset;
  const int k_end = causal ? min(Tk, pos_hi + 1) : Tk;
  int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  k_begin -= k_begin % KT;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + KT - 1) / KT : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < NST; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, 2 * OWN_BYTES + 2 * ROW_BYTES);
      for (int c = 0; c < NB; ++c) {
        tma_load(sq + c * OWN * 128, &tm_q, q_full, c * 64, i0, h, b);
        tma_load(sdo + c * OWN * 128, &tm_do, q_full, c * 64, i0, h, b);
      }
      bulk_load(srow, lse + (long long)bh * n_rows + i0, ROW_BYTES, q_full);
      bulk_load(srow + ROW_BYTES, dd + (long long)bh * n_rows + i0,
                ROW_BYTES, q_full);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % NST;
        const uint32_t phase = (n / NST) & 1;
        const int kt0 = k_begin + n * KT;
        mbar_wait(empty + 8 * s, phase ^ 1);
        mbar_expect_tx(full + 8 * s, 2 * TILE_BYTES);
        for (int c = 0; c < NB; ++c) {
          tma_load(sk + s * TILE_BYTES + c * KT * 128, &tm_k, full + 8 * s,
                   c * 64, kt0, h, b);
          tma_load(sv + s * TILE_BYTES + c * KT * 128, &tm_v, full + 8 * s,
                   c * 64, kt0, h, b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg - 1 owns query rows qi0 .. qi0 + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int qi0 = i0 + TILE * c;
    const int row0 = qi0 + 16 * warp + g;  // rows row0, row0 + 8
    const uint32_t q_rows = sq + TILE * c * 128, do_rows = sdo + TILE * c * 128;

    float acc[REGS];
#pragma unroll
    for (int e = 0; e < REGS; ++e) acc[e] = 0.0f;
    mbar_wait(q_full, 0);
    const float* lse_s = reinterpret_cast<const float*>(gbase + (srow - base));
    const int r0 = row0 - i0;
    const float lse_r[2] = {lse_s[r0], lse_s[r0 + 8]};
    const float dd_r[2] = {lse_s[OWN + r0], lse_s[OWN + r0 + 8]};

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % NST;
      const uint32_t phase = (n / NST) & 1;
      const int kt0 = k_begin + n * KT;
      const uint32_t k_tile = sk + s * TILE_BYTES, v_tile = sv + s * TILE_BYTES;

      // S = Q K^T and dP = dO V^T (64 query rows x KT keys)
      float sc[KT / 2], dp[KT / 2];
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) sc[e] = dp[e] = 0.0f;
      mbar_wait(full + 8 * s, phase);
      wgmma_fence();
      wgmma_ss_rows<HD, KT, OWN, KT>(sc, q_rows, k_tile);
      wgmma_ss_rows<HD, KT, OWN, KT>(dp, do_rows, v_tile);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // dS in place; thread element e is row row0 + 8 ((e % 4) / 2), key
      // kt0 + 8 (e / 4) + 2 t + e % 2
      const bool edge =
          edge_tile<TILE, KT>(qi0, kt0, S, Tk, causal, window, q_offset);
      uint32_t ds_hi[KT / 16][4], ds_lo[KT / 16][4];
#pragma unroll
      for (int e = 0; e < KT / 2; ++e) {
        const int r = (e % 4) / 2;
        float p = ex2(sc[e] * scale_log2 - lse_r[r]);
        if (edge) {
          const int j = kt0 + 8 * (e / 4) + 2 * t + (e % 2);
          p = visible(row0 + 8 * r, j, S, Tk, causal, window, q_offset)
                  ? p
                  : 0.0f;
        }
        dp[e] = p * (dp[e] - dd_r[r]);
      }
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split2(dp[8 * kk + 2 * a], dp[8 * kk + 2 * a + 1], ds_hi[kk][a],
                 ds_lo[kk][a]);
      }

      // dQ += dS K (16 keys per wgmma)
      wgmma_fence();
      wgmma_rs_split<HD, KT>(acc, ds_hi, ds_lo, k_tile, KT);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    store_rows<HD>(dq + b * dqv.b + h * dqv.h, dqv.s, acc, row0, S, hd, t,
                   scale, pairs);
  }
}

template <typename K>
int allow_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, const float* lse,
           float* dd, int B, int H, int S, int Tk, int hd, const View* vw,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  // vw: q, k, v, o, dout, dq, dk, dv
  using L = Layout<HD>;
  constexpr int smem_dkdv = 1024 + 2 * L::KEYS * HD * 2 +
                            STAGES * (2 * TILE * HD * 2 + 2 * TILE * 4) +
                            L::XCH + 8 * (1 + 2 * STAGES);
  constexpr int smem_dq = 1024 + 2 * OWN * HD * 2 + 2 * OWN * 4 +
                          L::DQ_STAGES * 2 * L::KT * HD * 2 +
                          8 * (1 + 2 * L::DQ_STAGES);
  static_assert(smem_dkdv <= MAX_SMEM && smem_dq <= MAX_SMEM,
                "a block's shared memory");
  // the runtime calls first: they make the device's primary context
  // current on this thread (autograd's backward thread may not have it
  // yet), which cuTensorMapEncodeTiled needs
  int err = allow_smem(dkdv_kernel<HD>, smem_dkdv);
  if (!err) err = allow_smem(dq_kernel<HD>, smem_dq);
  if (err) return err;
  CUtensorMap q_t, do_t, k_o, v_o;  // dkdv: 64-row Q/dO tiles, owned K/V
  CUtensorMap q_o, do_o, k_t, v_t;  // dq: owned Q/dO, K/V tiles
  const View &qv = vw[0], &kv = vw[1], &vv = vw[2], &dov = vw[4];
  err = make_map(&q_t, q, B, H, S, hd, qv.b, qv.h, qv.s, TILE);
  if (!err) err = make_map(&do_t, dout, B, H, S, hd, dov.b, dov.h, dov.s, TILE);
  if (!err) err = make_map(&k_o, k, B, H, Tk, hd, kv.b, kv.h, kv.s, L::KEYS);
  if (!err) err = make_map(&v_o, v, B, H, Tk, hd, vv.b, vv.h, vv.s, L::KEYS);
  if (!err) err = make_map(&q_o, q, B, H, S, hd, qv.b, qv.h, qv.s, OWN);
  if (!err) err = make_map(&do_o, dout, B, H, S, hd, dov.b, dov.h, dov.s, OWN);
  if (!err) err = make_map(&k_t, k, B, H, Tk, hd, kv.b, kv.h, kv.s, L::KT);
  if (!err) err = make_map(&v_t, v, B, H, Tk, hd, vv.b, vv.h, vv.s, L::KT);
  if (err) return err;
  // bf16x2 stores need every output row and batch/head offset even
  long long odd = 0;
  for (int x = 5; x < 8; ++x) odd |= vw[x].b | vw[x].h | vw[x].s;
  const int pairs = (odd & 1) == 0;
  const float scale_log2 =
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const long long n_rows = (long long)B * H * lse_rows(S);
  const int rows_blocks = static_cast<int>(
      (n_rows + ROWS_THREADS / 32 - 1) / (ROWS_THREADS / 32));
  rows_kernel<<<rows_blocks, ROWS_THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), dd, H, S, hd, vw[3], dov,
      n_rows);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 k_grid((Tk + L::KEYS - 1) / L::KEYS, B * H);
  dkdv_kernel<HD><<<k_grid, THREADS, smem_dkdv, stream>>>(
      q_t, do_t, k_o, v_o, lse, dd, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), vw[6], vw[7], H, S, Tk, hd, causal,
      window, q_offset, scale_log2, scale, pairs);
  if ((err = (int)cudaGetLastError())) return err;
  const dim3 q_grid((S + OWN - 1) / OWN, B * H);
  dq_kernel<HD><<<q_grid, THREADS, smem_dq, stream>>>(
      q_o, do_o, k_t, v_t, lse, dd, static_cast<__nv_bfloat16*>(dq), vw[5],
      H, S, Tk, hd, causal, window, q_offset, scale_log2, scale, pairs);
  return (int)cudaGetLastError();
}

// every bf16 head dim <= 256, zero-padded to 64, 128 or 256; `strides` holds
// the (batch, head, seq) element strides of q, k, v, o, dout, dq, dk and dv
inline int dispatch(const void* q, const void* k, const void* v,
                    const void* o, const void* dout, void* dq, void* dk,
                    void* dv, const float* lse, float* dd, int B, int H,
                    int S, int Tk, int hd, const long long* strides,
                    int causal, int window, int q_offset, float scale,
                    cudaStream_t stream) {
  View vw[8];
  for (int x = 0; x < 8; ++x)
    vw[x] = {strides[3 * x], strides[3 * x + 1], strides[3 * x + 2]};
  if (hd <= 64)
    return launch<64>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, S, Tk, hd,
                      vw, causal, window, q_offset, scale, stream);
  if (hd <= 128)
    return launch<128>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, S, Tk,
                       hd, vw, causal, window, q_offset, scale, stream);
  if (hd <= 256)
    return launch<256>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, S, Tk,
                       hd, vw, causal, window, q_offset, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace wgmma_fa_bwd
