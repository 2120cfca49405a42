// Blockwise (flash) attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` of
// src/repro/kernels/flash_attention.py:25 (pallas_call in `flash_attention`,
// :93). For every (batch, head) and query row i it computes
//   o[i] = sum_j softmax_j(mask(q_i . k_j / sqrt(hd))) v_j
// over the visible keys j: j < T (the true key length, never a padded one);
// i + q_offset >= j when causal; (i + q_offset) - j < window when window > 0.
// Accumulation is float32 with a running max m, denominator l and
// accumulator acc over key tiles; the result is acc / max(l, 1e-30), cast to
// the input type with round-to-nearest-even.
//
// Two routes, chosen by the input type in `flash_attention_launch`:
//   * bfloat16 goes to the tensor-core kernel of flash_attention_wgmma.cuh
//     (TMA, mbarrier ring, warp-specialized warpgroups, wgmma);
//   * float32 goes to the split-TF32 tensor-core kernel below (tf32x3.cuh:
//     each product as three TF32 mma.sync), held to atol 2e-5 against the
//     plain version.
//
// Masked scores are the finite NEG_INF = -1e30 of the Pallas kernel, not
// -inf: a row whose first tiles are wholly masked (a window) accumulates
// junk there that the next corr = exp(m_prev - m_new) = 0 wipes out, where
// -inf would give NaN (-inf - -inf).
//
// The float32 kernel. The TPU grid (BH, S/bq, T/bk) walked its key axis in
// order and carried m, l, acc in VMEM scratch across grid steps; here that
// axis is a loop inside the block. The head dim is zero-padded to the
// first of 16, 32, 64, 80, 96, 128, 256 that holds it (hubert's 80 runs 80
// wide), one instantiation each, so every loop over it is unrolled. One
// block per (batch x head, BQ query rows): 8 warps (4 at 256), each owning
// MT m16 tiles of rows, MT = 2 where the shared memory holds it (padded
// head dims up to 80), else 1. q, scaled before the dot product as the
// Pallas kernel scales it, is split once into TF32 hi and lo planes in
// shared memory. K and V tiles of BK keys (32; 16 at 256) come by cp.async
// into a two-stage ring, so the next tile loads during this one's
// products. Per tile each warp computes S = q K^T (A fragments from the q
// planes, B fragments from the K tile, split in registers; both read as
// 8-byte pairs of dims), masks it where the tile crosses T, the causal
// diagonal or the window's edge, runs the online softmax in registers
// (expf; the row max and sum are quad shuffles), and adds P V (P's
// accumulator fragments are the A fragments, V's B fragments split in
// registers). Tiles wholly above the block's causal diagonal, and wholly
// below its window, are not visited (the Pallas kernel skips the former);
// blocks are issued longest rows first. No atomics.
//
// The log-sum-exp. Given a non-null `lse` the kernel also stores each row's
// (m + log(max(l, 1e-30))) * log2 e, the base-2 log-sum-exp of the scaled
// scores that flash_attention_plain returns and the bf16 route stores, in
// rows of wgmma_fa::lse_rows(S) floats per (batch, head), 0 from S on; the
// float32 gradient (flash_attention_bwd.cu) reads it. Only the store is
// added: o is the same with and without it.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W). At S = T = 2048, H = 32,
// hd = 128, causal, float32: 4 * S * (S + 1) / 2 * H * hd = 34.4 GFLOP.
// Split TF32 issues three TF32 products for each: 103 GFLOP at 495 TFLOP/s
// = 0.208 ms (0.513 ms at the float32 pipe's 67 TFLOP/s), against 134 MB
// of q, k, v, o (0.040 ms at 3.35 TB/s): the operations bound it. At
// hubert-xlarge's (4, 1024, 1024, 16 x 80), not causal: 21.5 GFLOP, 0.130
// ms as split TF32. mma.sync reaches only part of the tensor cores' rate
// (wgmma alone reaches all of it), and every warp splits each B fragment
// it loads (three operations a value), so the issue slots, not the tensor
// pipe alone, bound this design. Staging K and V split through registers
// instead (each value split once a block) was 9% faster at hubert's shape
// and no faster at hd 128; the gradient's kernels spilled that way.
#include <cuda_runtime.h>

#include "flash_attention_wgmma.cuh"
#include "tf32x3.cuh"

namespace tf32_fa {

using namespace tf32x3;

constexpr int STAGES = 2;  // the K/V ring

// bytes of shared memory of a block of `warps` warps with `mt` m16 tiles
// each at padded head dim hdp, key tiles of bk: the split q planes (rows of
// hdp + 8) and the K/V ring (K rows of hdp + 8, V rows of hdp + 4)
constexpr size_t fwd_smem(int hdp, int warps, int bk, int mt) {
  return 4ull * (2 * (hdp + 8) * warps * 16 * mt +
                 STAGES * bk * (2 * hdp + 12));
}

// the block at padded head dim HDP (16, 32, 64, 80, 96, 128 or 256)
template <int HDP>
struct Layout {
  static constexpr int WARPS = HDP > 128 ? 4 : 8;
  static constexpr int THREADS = WARPS * 32;
  static constexpr int BK = HDP > 128 ? 16 : 32;  // keys a tile
  static constexpr int NT = BK / 8;               // n8 tiles of keys
  static constexpr int DT = HDP / 8;  // k8 steps and n8 tiles of dims
  // shared rows: the q planes and K read by paired loads (LDQ % 32 in
  // {8, 24}), V by rows 2t and 2t + 1 (LDV % 8 == 4)
  static constexpr int LDQ = HDP + 8, LDV = HDP + 4;
  // m16 tiles a warp: two where the shared memory holds them
  static constexpr int MT = fwd_smem(HDP, WARPS, BK, 2) <= MAX_SMEM ? 2 : 1;
  static constexpr int BQ = WARPS * 16 * MT;  // query rows a block
  static constexpr size_t SMEM = fwd_smem(HDP, WARPS, BK, MT);
};

template <int HDP>
__global__ void __launch_bounds__(Layout<HDP>::THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, float* __restrict__ o,
           float* __restrict__ lse, int H, int S, int Tk, int hd,
           Strides qs, Strides ks, Strides vs, Strides os, int causal,
           int window, int q_offset, float scale, int vec) {
  using L = Layout<HDP>;
  constexpr int MT = L::MT, BQ = L::BQ, BK = L::BK, NT = L::NT, DT = L::DT;
  constexpr int LDQ = L::LDQ, LDV = L::LDV, NTH = L::THREADS;
  constexpr int STAGE = BK * (LDQ + LDV);  // floats of a ring stage
  extern __shared__ __align__(16) float smem[];
  uint32_t* q_hi = reinterpret_cast<uint32_t*>(smem);  // [BQ][LDQ]
  uint32_t* q_lo = q_hi + BQ * LDQ;                     // [BQ][LDQ]
  float* ring = smem + 2 * BQ * LDQ;  // STAGES x (K [BK][LDQ], V [BK][LDV])

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int warp = threadIdx.x / 32, g = lane_g(), t = lane_t();
  const float* kp = k + b * ks.b + h * ks.h;
  const float* vp = v + b * vs.b + h * vs.h;

  // the keys any real row of this block can see
  const int pos_lo = i0 + q_offset;
  const int pos_hi = min(i0 + BQ, S) - 1 + q_offset;
  const int k_end = causal ? min(Tk, pos_hi + 1) : Tk;
  int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  auto load_tile = [&](int it) {
    float* dst = ring + (it % STAGES) * STAGE;
    const int j0 = k_begin + it * BK;
    load_rows<BK, NTH>(dst, LDQ, kp, ks.s, j0, Tk, hd, HDP, vec);
    load_rows<BK, NTH>(dst + BK * LDQ, LDV, vp, vs.s, j0, Tk, hd, HDP, vec);
    cp_async_commit();
  };
  if (n_tiles > 0) load_tile(0);
  stage_split<NTH>(q_hi, q_lo, LDQ, q + b * qs.b + h * qs.h, qs.s, i0, BQ,
                   S, hd, HDP, scale);

  const int row0 = warp * 16 * MT;  // the warp's first row in the block
  float m[MT][2], l[MT][2], acc[MT][DT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = NEG_INF;
      l[mt][hf] = 0.0f;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.0f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int j0 = k_begin + it * BK;
    if (it + 1 < n_tiles) {
      load_tile(it + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, at it = 0, the q planes) is staged
    const float* sk = ring + (it % STAGES) * STAGE;
    const float* sv = sk + BK * LDQ;

    // S = q K^T over the DT k-steps of 8 dims (paired loads)
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][nt][e] = 0.0f;
#pragma unroll
    for (int kd = 0; kd < DT; ++kd) {
      FragA a[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int off = (row0 + mt * 16) * LDQ + kd * 8;
        a[mt] = load_a_split2(q_hi + off, q_lo + off, LDQ);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const FragB bb = load_b_nk2(sk + nt * 8 * LDQ + kd * 8, LDQ);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(s[mt][nt], a[mt], bb);
      }
    }

    // mask (edge tiles only), then the online softmax; s becomes p
    const bool edge = j0 + BK > Tk || (causal && j0 + BK - 1 > pos_lo) ||
                      (window > 0 && pos_hi - j0 >= window);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int pos = i0 + row0 + mt * 16 + g + 8 * hf + q_offset;
        float mx = NEG_INF;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hf + e];
            if (edge && !visible(pos, j0 + nt * 8 + 2 * t + e, Tk, causal,
                                 window))
              x = NEG_INF;
            mx = fmaxf(mx, x);
          }
        const float m_new = fmaxf(m[mt][hf], quad_max(mx));
        const float corr = expf(m[mt][hf] - m_new);
        float sum = 0.0f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[mt][nt][2 * hf + e];
            x = expf(x - m_new);
            sum += x;
          }
        l[mt][hf] = l[mt][hf] * corr + quad_sum(sum);
        m[mt][hf] = m_new;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt) {
          acc[mt][dt][2 * hf] *= corr;
          acc[mt][dt][2 * hf + 1] *= corr;
        }
      }
    }

    // acc += P V, one k-step a key n8 tile
#pragma unroll
    for (int kk = 0; kk < NT; ++kk) {
      FragA pa[MT];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) pa[mt] = a_of_acc(s[mt][kk]);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const FragB bb = load_b_kn(sv + kk * 8 * LDV + dt * 8, LDV, 1.0f);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) mma3(acc[mt][dt], pa[mt], bb);
      }
    }
    __syncthreads();  // the stage is read before a later load refills it
  }

  float* op = o + b * os.b + h * os.h;
  float* lrow = lse == nullptr
                    ? nullptr
                    : lse + (long long)blockIdx.y * wgmma_fa::lse_rows(S);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int i = i0 + row0 + mt * 16 + g + 8 * hf;
      if (i >= S) continue;
      const float den = fmaxf(l[mt][hf], 1e-30f);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const int d = dt * 8 + 2 * t;
        if (d < hd) op[i * os.s + d] = acc[mt][dt][2 * hf] / den;
        if (d + 1 < hd) op[i * os.s + d + 1] = acc[mt][dt][2 * hf + 1] / den;
      }
      if (lrow != nullptr && t == 0)
        lrow[i] = (m[mt][hf] + logf(den)) * LOG2E;
    }
  }
  // the block holding row S - 1 zeroes the padding rows S .. lse_rows(S)
  if (lrow != nullptr && i0 + BQ >= S)
    for (int r = S + threadIdx.x; r < wgmma_fa::lse_rows(S); r += NTH)
      lrow[r] = 0.0f;
}

template <int HDP>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int H, int S, int Tk, int hd, Strides qs,
           Strides ks, Strides vs, Strides os, int causal, int window,
           int q_offset, float scale, cudaStream_t stream) {
  using L = Layout<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int vec = rows_vec(q, qs, hd) && rows_vec(k, ks, hd) &&
                  rows_vec(v, vs, hd);
  const dim3 grid((S + L::BQ - 1) / L::BQ, B * H);
  fwd_kernel<HDP><<<grid, L::THREADS, L::SMEM, stream>>>(
      q, k, v, o, lse, H, S, Tk, hd, qs, ks, vs, os, causal, window,
      q_offset, scale, vec);
  return (int)cudaGetLastError();
}

// every float32 head dim <= 256, zero-padded to the first of the widths
// below that holds it
int dispatch(const float* q, const float* k, const float* v, float* o,
             float* lse, int B, int H, int S, int Tk, int hd, Strides qs,
             Strides ks, Strides vs, Strides os, int causal, int window,
             int q_offset, float scale, cudaStream_t stream) {
#define TF32_FA_LAUNCH(HDP)                                               \
  if (hd <= HDP)                                                          \
  return launch<HDP>(q, k, v, o, lse, B, H, S, Tk, hd, qs, ks, vs, os,    \
                     causal, window, q_offset, scale, stream)
  TF32_FA_LAUNCH(16);
  TF32_FA_LAUNCH(32);
  TF32_FA_LAUNCH(64);
  TF32_FA_LAUNCH(80);
  TF32_FA_LAUNCH(96);
  TF32_FA_LAUNCH(128);
  TF32_FA_LAUNCH(256);
#undef TF32_FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace tf32_fa

// Launches on `stream` (PyTorch's current stream); returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch,
// or wgmma_fa::ENCODE_ERROR (+ the CUresult) when a TMA tensor map is
// refused. q (B, H, S, hd), k and v (B, H, T, hd), o (B, H, S, hd), each
// given by its element strides (dim contiguous), float32 (is_bf16 = 0) or
// bfloat16. The wrapper checks devices, types, shapes and strides (for
// bfloat16, the 16-byte alignment TMA needs) and allocates o. `lse` is
// null, or float32 of B * H * wgmma_fa::lse_rows(S), which receives each
// row's log-sum-exp in base 2 for the gradient kernel (both routes).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int S, int Tk, int hd, long long qsb, long long qsh, long long qss,
    long long ksb, long long ksh, long long kss, long long vsb,
    long long vsh, long long vss, long long osb, long long osh,
    long long oss, int causal, int window, int q_offset, float scale,
    int is_bf16, void* lse, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  if (is_bf16) {
    const long long qst[3] = {qsb, qsh, qss}, kst[3] = {ksb, ksh, kss},
                    vst[3] = {vsb, vsh, vss}, ost[3] = {osb, osh, oss};
    return wgmma_fa::dispatch(q, k, v, o, B, H, S, Tk, hd, qst, kst, vst, ost,
                              causal, window, q_offset, scale,
                              static_cast<float*>(lse), st);
  }
  const tf32x3::Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss},
      vs{vsb, vsh, vss}, os{osb, osh, oss};
  return tf32_fa::dispatch(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), B, H, S, Tk, hd, qs, ks, vs, os, causal,
      window, q_offset, scale, st);
}
