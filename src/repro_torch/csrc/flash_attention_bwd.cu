// The gradient of blockwise (flash) attention for Hopper (sm_90a).
//
// The JAX package has no Pallas backward: it trains by differentiating the
// jnp `blockwise_attention` (src/repro/models/attention.py:29) under
// jax.value_and_grad. The port's forward is the hand-written kernel of
// flash_attention.cu (replacing `_flash_kernel`,
// src/repro/kernels/flash_attention.py:25, pallas_call at :93), so its
// gradient is this kernel. Given q (B, H, S, hd), k and v (B, H, T, hd), the
// forward's output o, its log-sum-exp and the output's gradient dO, it
// computes dq, dk and dv under the forward's masks: key j is visible to
// query row i when j < T (the true length), i + q_offset >= j when causal
// and (i + q_offset) - j < window when window > 0. With s_ij = (q_i *
// scale) . k_j, P_ij = exp(s_ij - lse_i) over the visible keys and D_i =
// dO_i . o_i:
//   dv_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dk_j = sum_i dS_ij (q_i * scale)
//   dq_i = scale * sum_j dS_ij k_j
//
// Two routes, each with its own C entry, chosen by type in the Python
// wrapper; both read the log-sum-exp that the forward stores (base 2, rows
// of wgmma_fa::lse_rows(S) floats a (batch, head)). bfloat16 runs
// flash_attention_bwd_wgmma.cuh (TMA, wgmma). Float32 runs the split-TF32
// kernels of this file (tf32x3.cuh: each product as three TF32 mma.sync),
// two on the caller's stream, one after the other. The head dim is
// zero-padded to the first of 16, 32, 64, 80, 96, 128, 256 that holds it,
// one instantiation each; blocks have 8 warps where the shared memory
// holds them (padded head dims up to 80), else 4 (at 256, 2 in dq_kernel):
//   1. dq_kernel: one block per (batch x head, 16 query rows a warp). It
//      computes D_i = dO_i . o_i for its rows (a warp a row, lanes over the
//      dims, then a butterfly) and stores it for the second kernel; q
//      (scaled) and dO stay in shared memory split into TF32 hi and lo
//      planes; K and V tiles (32 keys, 16 at 256) stream through a
//      two-stage cp.async ring. Per tile a warp recomputes S = q K^T and
//      dP = dO V^T, forms P = exp2(S log2 e - lse) under the mask (edge
//      tiles only) and dS = P (dP - D) in registers and adds dQ += dS K
//      (dS's accumulator fragments are the A fragments; B fragments split
//      in registers).
//   2. dkdv_kernel: one block per (batch x head, 16 keys a warp); K and V
//      stay in shared memory split into hi and lo planes while 32-row
//      tiles of q and dO (16 at 256) with their lse and D stream through a
//      two-stage ring. A warp owns 16 keys: S^T = K q^T, dP^T = V dO^T,
//      P^T and dS^T in registers, then dV += P^T dO and dK += dS^T q. At a
//      head dim of 256 one warp cannot hold dK and dV of 16 keys (256
//      floats a thread), so two warps own the same 16 keys, each the dK
//      and dV columns of one half of the dims; both compute S^T and dP^T.
// Every output element is summed by one thread in a fixed order (key
// tiles for dq, query tiles for dk and dv, in order): no float atomics, so
// two launches on the same inputs agree bit for bit. Inputs may be
// strided views (the transposes of (B, S, H, hd) tensors that
// ops.flash_mha passes); the head dim is contiguous.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W). The gradient's least work
// is 5 products of S x T x hd a head (dO.v, the recomputed q.k, P^T dO,
// dS^T q, dS k). At hubert-xlarge's (4, 1024, 1024, 16 x 80), not causal:
// 53.7 GFLOP; as split TF32 (three TF32 products each) 0.325 ms at 495
// TFLOP/s (0.801 ms at the float32 pipe's 67 TFLOP/s), against 134 MB
// (0.040 ms at 3.35 TB/s): the operations bound it. This design issues 7
// such products (q.k and dO.v once more in the dq kernel), 75.2 GFLOP,
// 0.456 ms as split TF32; mma.sync and the splits of B fragments in
// registers keep it above that. The tensor-core route's bound is in its
// header.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention_bwd_wgmma.cuh"
#include "tf32x3.cuh"

namespace tf32_fa_bwd {

using namespace tf32x3;
using wgmma_fa::lse_rows;

constexpr int STAGES = 2;  // the rings' depth

struct Views {
  Strides q, k, v, o, dout, dq, dk, dv;
};

// bytes of shared memory at padded head dim hdp (rows of hdp + 4 floats):
// dq_kernel with `warps` warps of 16 query rows and key tiles of bk (the
// split q and dO planes, the K/V ring, lse and D), dkdv_kernel with kg
// warps of 16 keys and query tiles of bq (the split K and V planes, the q
// and dO ring, its lse and D)
constexpr size_t dq_smem(int hdp, int warps, int bk) {
  return 4ull * ((hdp + 4) * (4 * 16 * warps + STAGES * 2 * bk) +
                 2 * 16 * warps);
}
constexpr size_t kv_smem(int hdp, int kg, int bq) {
  return 4ull * ((hdp + 4) * (4 * 16 * kg + STAGES * 2 * bq) +
                 STAGES * 2 * bq);
}

// the two kernels' blocks at padded head dim HDP (16, 32, 64, 80, 96, 128
// or 256): 8 warps where the shared memory holds them, else 4 (2 at 256)
template <int HDP>
struct Layout {
  static constexpr int DT = HDP / 8;  // k8 steps and n8 tiles of dims
  static constexpr int LD = HDP + 4;  // a shared row, LD % 8 == 4
  // dq_kernel: warps of 16 query rows, key tiles of DQ_BK
  static constexpr int DQ_BK = HDP > 128 ? 16 : 32;
  static constexpr int DQ_WARPS =
      HDP > 128 ? 2 : dq_smem(HDP, 8, DQ_BK) <= MAX_SMEM ? 8 : 4;
  static constexpr int DQ_THREADS = DQ_WARPS * 32;
  static constexpr int DQ_BQ = DQ_WARPS * 16;
  // dkdv_kernel: KG warps of 16 keys times DSPLIT warps of dims, query
  // tiles of KV_BQ
  static constexpr int KV_BQ = HDP > 128 ? 16 : 32;
  static constexpr int KG =
      HDP > 128 ? 2 : kv_smem(HDP, 8, KV_BQ) <= MAX_SMEM ? 8 : 4;
  static constexpr int DSPLIT = HDP > 128 ? 2 : 1;
  static constexpr int KV_THREADS = KG * DSPLIT * 32;
  static constexpr int KV_BK = KG * 16;
  static constexpr int KV_DT = DT / DSPLIT;  // n8 tiles of dims a warp owns
  static constexpr size_t DQ_SMEM = dq_smem(HDP, DQ_WARPS, DQ_BK);
  static constexpr size_t KV_SMEM = kv_smem(HDP, KG, KV_BQ);
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

template <int HDP>
__global__ void __launch_bounds__(Layout<HDP>::DQ_THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ o,
          const float* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ dd, float* __restrict__ dq, int H, int S,
          int Tk, int hd, Views vw, int causal, int window, int q_offset,
          float scale, int vec) {
  using L = Layout<HDP>;
  constexpr int BQ = L::DQ_BQ, BK = L::DQ_BK, NT = BK / 8, DT = L::DT;
  constexpr int NTH = L::DQ_THREADS, ld = L::LD, hdp = HDP;
  extern __shared__ __align__(16) float smem[];
  uint32_t* q_hi = reinterpret_cast<uint32_t*>(smem);  // [BQ][ld] each
  uint32_t* q_lo = q_hi + BQ * ld;
  uint32_t* do_hi = q_lo + BQ * ld;
  uint32_t* do_lo = do_hi + BQ * ld;
  float* ring = smem + 4 * BQ * ld;  // STAGES x (K [BK][ld], V [BK][ld])
  float* sh_lse = ring + STAGES * 2 * BK * ld;  // [BQ]
  float* sh_dd = sh_lse + BQ;                   // [BQ]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane_g(), t = lane_t();
  const float* kp = k + b * vw.k.b + h * vw.k.h;
  const float* vp = v + b * vw.v.b + h * vw.v.h;
  const float* dop = dout + b * vw.dout.b + h * vw.dout.h;
  const float* op = o + b * vw.o.b + h * vw.o.h;
  const long long rows = lse_rows(S);
  const float* lrow = lse + blockIdx.y * rows;
  float* drow = dd + blockIdx.y * rows;

  const int pos_lo = i0 + q_offset;
  const int pos_hi = min(i0 + BQ, S) - 1 + q_offset;
  const int k_end = causal ? min(Tk, pos_hi + 1) : Tk;
  int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_tile = [&](int it) {
    float* dst = ring + (it % STAGES) * 2 * BK * ld;
    const int j0 = k_begin + it * BK;
    load_rows<BK, NTH>(dst, ld, kp, vw.k.s, j0, Tk, hd, hdp, vec);
    load_rows<BK, NTH>(dst + BK * ld, ld, vp, vw.v.s, j0, Tk, hd, hdp, vec);
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);
  stage_split<NTH>(q_hi, q_lo, ld, q + b * vw.q.b + h * vw.q.h, vw.q.s, i0,
                   BQ, S, hd, hdp, scale);
  stage_split<NTH>(do_hi, do_lo, ld, dop, vw.dout.s, i0, BQ, S, hd, hdp,
                   1.0f);
  for (int r = threadIdx.x; r < BQ; r += NTH)
    sh_lse[r] = i0 + r < S ? lrow[i0 + r] : 0.0f;
  // D of the warp's 16 rows, stored for dkdv_kernel
  for (int r = warp * 16; r < warp * 16 + 16; ++r) {
    const int i = i0 + r;
    float x = 0.0f;
    for (int d = lane; i < S && d < hd; d += 32)
      x = fmaf(dop[i * vw.dout.s + d], op[i * vw.o.s + d], x);
    x = warp_sum(x);
    if (lane == 0) {
      sh_dd[r] = x;
      if (i < S) drow[i] = x;
    }
  }
  __syncthreads();  // lse, D and the split planes are staged

  const int row0 = warp * 16;
  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = k_begin + it * BK;
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = ring + (it % STAGES) * 2 * BK * ld;
    const float* sv = sk + BK * ld;

    // S = q K^T and dP = dO V^T
    float s[NT][4], dp[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < DT; ++kd) {
      const int off = row0 * ld + kd * 8;
      const FragA aq = load_a_split(q_hi + off, q_lo + off, ld);
      const FragA ado = load_a_split(do_hi + off, do_lo + off, ld);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const FragB bk = load_b_nk(sk + nt * 8 * ld + kd * 8, ld, 1.0f);
        mma3(s[nt], aq, bk);
        const FragB bv = load_b_nk(sv + nt * 8 * ld + kd * 8, ld, 1.0f);
        mma3(dp[nt], ado, bv);
      }
    }

    // P and dS (into s) under the mask
    const bool edge = i0 + BQ > S || j0 + BK > Tk ||
                      (causal && pos_lo < j0 + BK - 1) ||
                      (window > 0 && pos_hi - j0 >= window);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + g + 8 * hf, i = i0 + r;
      const float lr = sh_lse[r], dr = sh_dd[r];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = j0 + nt * 8 + 2 * t + e;
          const bool vis = !edge || (i < S && visible(i + q_offset, j, Tk,
                                                      causal, window));
          const float p =
              vis ? exp2f(fmaf(s[nt][2 * hf + e], LOG2E, -lr)) : 0.0f;
          s[nt][2 * hf + e] = p * (dp[nt][2 * hf + e] - dr);
        }
    }

    // dQ += dS K
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const FragA a = a_of_acc(s[kk]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const FragB bb = load_b_kn(sk + kk * 8 * ld + dt * 8, ld, 1.0f);
        mma3(acc[dt], a, bb);
      }
    }
    __syncthreads();  // the stage is read before a later load refills it
  }

  float* dqp = dq + b * vw.dq.b + h * vw.dq.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int i = i0 + row0 + g + 8 * hf;
    if (i >= S) continue;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = dt * 8 + 2 * t + e;
        if (d < hd) dqp[i * vw.dq.s + d] = acc[dt][2 * hf + e] * scale;
      }
  }
}

template <int HDP>
__global__ void __launch_bounds__(Layout<HDP>::KV_THREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dd,
            float* __restrict__ dk, float* __restrict__ dv, int H, int S,
            int Tk, int hd, Views vw, int causal, int window, int q_offset,
            float scale, int vec) {
  using L = Layout<HDP>;
  constexpr int BK = L::KV_BK, BQ = L::KV_BQ, NT = BQ / 8;
  constexpr int KDT = L::KV_DT, NTH = L::KV_THREADS, ld = L::LD, hdp = HDP;
  extern __shared__ __align__(16) float smem[];
  uint32_t* k_hi = reinterpret_cast<uint32_t*>(smem);  // [BK][ld] each
  uint32_t* k_lo = k_hi + BK * ld;
  uint32_t* v_hi = k_lo + BK * ld;
  uint32_t* v_lo = v_hi + BK * ld;
  float* ring = smem + 4 * BK * ld;  // STAGES x (q [BQ][ld], dO [BQ][ld])
  float* ring_r = ring + STAGES * 2 * BQ * ld;  // STAGES x (lse, D [BQ])

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int j0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const int kg = warp % L::KG, dh = warp / L::KG;
  const float* qp = q + b * vw.q.b + h * vw.q.h;
  const float* dop = dout + b * vw.dout.b + h * vw.dout.h;
  const long long rows = lse_rows(S);
  const float* lrow = lse + blockIdx.y * rows;
  const float* drow = dd + blockIdx.y * rows;

  // the query rows that can see any key of this block
  const int j_last = min(j0 + BK, Tk) - 1;
  const int i_begin = causal ? max(0, j0 - q_offset) : 0;
  const int i_end = window > 0 ? min(S, j_last + window - q_offset) : S;
  const int n_tiles = i_end > i_begin ? (i_end - i_begin + BQ - 1) / BQ : 0;

  auto load_tile = [&](int it) {
    const int st = it % STAGES, i0 = i_begin + it * BQ;
    float* dst = ring + st * 2 * BQ * ld;
    load_rows<BQ, NTH>(dst, ld, qp, vw.q.s, i0, S, hd, hdp, vec);
    load_rows<BQ, NTH>(dst + BQ * ld, ld, dop, vw.dout.s, i0, S, hd, hdp,
                       vec);
    load_vec<BQ, NTH>(ring_r + st * 2 * BQ, lrow, i0, S);
    load_vec<BQ, NTH>(ring_r + st * 2 * BQ + BQ, drow, i0, S);
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);
  stage_split<NTH>(k_hi, k_lo, ld, k + b * vw.k.b + h * vw.k.h, vw.k.s, j0,
                   BK, Tk, hd, hdp, 1.0f);
  stage_split<NTH>(v_hi, v_lo, ld, v + b * vw.v.b + h * vw.v.h, vw.v.s, j0,
                   BK, Tk, hd, hdp, 1.0f);

  const int key0 = kg * 16;  // the warp's first key in the block
  float adk[KDT][4], adv[KDT][4];
#pragma unroll
  for (int dt = 0; dt < KDT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[dt][e] = adv[dt][e] = 0.0f;

  for (int it = 0; it < n_tiles; ++it) {
    const int i0 = i_begin + it * BQ;
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, at it = 0, the K/V planes) is staged
    const float* sq = ring + (it % STAGES) * 2 * BQ * ld;
    const float* sdo = sq + BQ * ld;
    const float* s_lse = ring_r + (it % STAGES) * 2 * BQ;
    const float* s_dd = s_lse + BQ;

    // S^T = K q^T (q scaled) and dP^T = V dO^T
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < L::DT; ++kd) {
      const int off = key0 * ld + kd * 8;
      const FragA ak = load_a_split(k_hi + off, k_lo + off, ld);
      const FragA av = load_a_split(v_hi + off, v_lo + off, ld);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const FragB bq = load_b_nk(sq + nt * 8 * ld + kd * 8, ld, scale);
        mma3(st[nt], ak, bq);
        const FragB bo = load_b_nk(sdo + nt * 8 * ld + kd * 8, ld, 1.0f);
        mma3(dpt[nt], av, bo);
      }
    }

    // P^T (into st) and dS^T (into dpt) under the mask
    const bool edge = i0 + BQ > S || j0 + BK > Tk ||
                      (causal && i0 + q_offset < j0 + BK - 1) ||
                      (window > 0 && i0 + BQ - 1 + q_offset - j0 >= window);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = j0 + key0 + g + 8 * hf;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = nt * 8 + 2 * t + e, i = i0 + r;
          const bool vis = !edge || (i < S && visible(i + q_offset, j, Tk,
                                                      causal, window));
          const float p =
              vis ? exp2f(fmaf(st[nt][2 * hf + e], LOG2E, -s_lse[r]))
                  : 0.0f;
          st[nt][2 * hf + e] = p;
          dpt[nt][2 * hf + e] = p * (dpt[nt][2 * hf + e] - s_dd[r]);
        }
    }

    // dV += P^T dO and dK += dS^T q (q scaled), over the warp's dims
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      const FragA ap = a_of_acc(st[kk]);
      const FragA ads = a_of_acc(dpt[kk]);
#pragma unroll
      for (int dt = 0; dt < KDT; ++dt) {
        const int dg = dh * KDT + dt;
        const FragB bo = load_b_kn(sdo + kk * 8 * ld + dg * 8, ld, 1.0f);
        mma3(adv[dt], ap, bo);
        const FragB bq = load_b_kn(sq + kk * 8 * ld + dg * 8, ld, scale);
        mma3(adk[dt], ads, bq);
      }
    }
    __syncthreads();  // the stage is read before a later load refills it
  }

  float* dkp = dk + b * vw.dk.b + h * vw.dk.h;
  float* dvp = dv + b * vw.dv.b + h * vw.dv.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int j = j0 + key0 + g + 8 * hf;
    if (j >= Tk) continue;
#pragma unroll
    for (int dt = 0; dt < KDT; ++dt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = (dh * KDT + dt) * 8 + 2 * t + e;
        if (d < hd) {
          dkp[j * vw.dk.s + d] = adk[dt][2 * hf + e];
          dvp[j * vw.dv.s + d] = adv[dt][2 * hf + e];
        }
      }
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HDP>
int launch(const float* q, const float* k, const float* v, const float* o,
           const float* dout, float* dq, float* dk, float* dv,
           const float* lse, float* dd, int B, int H, int S, int Tk, int hd,
           const Views& vw, int causal, int window, int q_offset,
           float scale, cudaStream_t stream) {
  using L = Layout<HDP>;
  int err;
  if ((err = allow_smem(dq_kernel<HDP>, L::DQ_SMEM))) return err;
  if ((err = allow_smem(dkdv_kernel<HDP>, L::KV_SMEM))) return err;
  const int vec = rows_vec(q, vw.q, hd) && rows_vec(k, vw.k, hd) &&
                  rows_vec(v, vw.v, hd) && rows_vec(dout, vw.dout, hd);
  const dim3 q_grid((S + L::DQ_BQ - 1) / L::DQ_BQ, B * H);
  const dim3 k_grid((Tk + L::KV_BK - 1) / L::KV_BK, B * H);
  dq_kernel<HDP><<<q_grid, L::DQ_THREADS, L::DQ_SMEM, stream>>>(
      q, k, v, o, dout, lse, dd, dq, H, S, Tk, hd, vw, causal, window,
      q_offset, scale, vec);
  if ((err = (int)cudaGetLastError())) return err;
  dkdv_kernel<HDP><<<k_grid, L::KV_THREADS, L::KV_SMEM, stream>>>(
      q, k, v, dout, lse, dd, dk, dv, H, S, Tk, hd, vw, causal, window,
      q_offset, scale, vec);
  return (int)cudaGetLastError();
}

// every float32 head dim <= 256, zero-padded to the first of the widths
// below that holds it (the forward's)
int dispatch(const float* q, const float* k, const float* v, const float* o,
             const float* dout, float* dq, float* dk, float* dv,
             const float* lse, float* dd, int B, int H, int S, int Tk,
             int hd, const Views& vw, int causal, int window, int q_offset,
             float scale, cudaStream_t st) {
#define TF32_BWD_LAUNCH(HDP)                                             \
  if (hd <= HDP)                                                         \
  return launch<HDP>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, S, Tk, \
                     hd, vw, causal, window, q_offset, scale, st)
  TF32_BWD_LAUNCH(16);
  TF32_BWD_LAUNCH(32);
  TF32_BWD_LAUNCH(64);
  TF32_BWD_LAUNCH(80);
  TF32_BWD_LAUNCH(96);
  TF32_BWD_LAUNCH(128);
  TF32_BWD_LAUNCH(256);
#undef TF32_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace tf32_fa_bwd

// Two C entries, one a route; the Python wrapper picks the route by type
// (kernels/flash_attention.py:bwd_route) and calls its entry,
// so the route it records is the one launched. Each launches its kernels on
// `stream` (PyTorch's current stream) and returns the first
// cudaGetLastError() that is not 0, so the wrapper can raise on a refused
// launch (or wgmma_fa::ENCODE_ERROR + the CUresult when a TMA tensor map is
// refused). q, o, dout and dq are (B, H, S, hd), k, v, dk and dv (B, H, T,
// hd), each given by its element strides in `strides` (8 views x (batch,
// head, seq); dim contiguous). lse is the forward's log-sum-exp (base 2,
// B * H * wgmma_fa::lse_rows(S) floats, an input) and dd float32 scratch of
// the same size. The wrapper checks devices, types, shapes and strides and
// allocates the outputs and the scratch. When T = 0 the wrapper zero-fills
// dq itself.
//
// flash_attention_bwd_launch: the split-TF32 kernels above, float32, hd <=
// 256.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dd,
    int B, int H, int S, int Tk, int hd, const long long* strides,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0 || Tk == 0) return 0;
  const long long* s = strides;
  const tf32_fa_bwd::Views vw{{s[0], s[1], s[2]},    {s[3], s[4], s[5]},
                              {s[6], s[7], s[8]},    {s[9], s[10], s[11]},
                              {s[12], s[13], s[14]}, {s[15], s[16], s[17]},
                              {s[18], s[19], s[20]}, {s[21], s[22], s[23]}};
  return tf32_fa_bwd::dispatch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<float*>(dq),
      static_cast<float*>(dk), static_cast<float*>(dv),
      static_cast<const float*>(lse), static_cast<float*>(dd), B, H, S, Tk,
      hd, vw, causal, window, q_offset, scale, (cudaStream_t)stream);
}

// flash_attention_bwd_wgmma_launch: the tensor-core kernels of
// flash_attention_bwd_wgmma.cuh, bfloat16, hd <= 256; q, k, v and dout
// meet TMA's 16-byte rule.
extern "C" int flash_attention_bwd_wgmma_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dd,
    int B, int H, int S, int Tk, int hd, const long long* strides,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0 || Tk == 0) return 0;
  return wgmma_fa_bwd::dispatch(q, k, v, o, dout, dq, dk, dv,
                                static_cast<const float*>(lse),
                                static_cast<float*>(dd), B, H, S, Tk, hd,
                                strides, causal, window, q_offset, scale,
                                (cudaStream_t)stream);
}
