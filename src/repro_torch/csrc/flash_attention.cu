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
//   * float32 stays on the CUDA-core kernel below, which is held to atol
//     2e-5 against the plain version, a bound no bf16 tensor-core product
//     can meet.
//
// Masked scores are the finite NEG_INF = -1e30 of the Pallas kernel, not
// -inf: a row whose first tiles are wholly masked (a window) accumulates
// junk there that the next corr = exp(m_prev - m_new) = 0 wipes out, where
// -inf would give NaN (-inf - -inf).
//
// The float32 kernel. The TPU grid (BH, S/bq, T/bk) walked its key axis in
// order and carried m, l, acc in VMEM scratch across grid steps; here that
// axis is a loop inside the block. One block per (batch x head, 64 query
// rows), 8 warps, 8 query rows per warp. Per key tile of 32 keys the block
// stages K transposed (padded, so lanes read distinct banks) and V in shared
// memory; q (scaled before the dot product, as the Pallas kernel does,
// zero-padded to the template head dim) stays in shared memory for the
// whole loop. For the scores each lane owns one key and dots it with the
// warp's 8 rows (q read as float4 broadcasts); the row max and sum are warp
// shuffles; for P.V each lane owns HD/32 output dims of each row and takes
// p_j by shuffle. m, l and acc live in registers. Tiles wholly above the
// block's causal diagonal, and wholly below its window, are not visited
// (the Pallas kernel skips the former). Blocks are issued longest rows
// first. Float32 CUDA-core FMAs, no tensor cores, no atomics.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W). At S = T = 2048, H = 32,
// hd = 128, causal, float32: 4 * S * (S + 1) / 2 * H * hd = 34 GFLOP
// (0.51 ms on the 67 TFLOP/s float32 pipe; a float32 input has no faster
// tensor-core route at this accuracy) against 134 MB of q, k, v, o
// (0.040 ms at 3.35 TB/s): the operations bound it.
#include <cuda_runtime.h>

#include "flash_attention_wgmma.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int ROWS = 8;             // query rows per warp
constexpr int BQ = WARPS * ROWS;    // query rows per block
constexpr int BK = 32;              // keys per tile: one per lane
constexpr int THREADS = WARPS * 32;
constexpr float NEG_INF = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// element strides of a (batch, head, seq, dim) view; dim is contiguous
struct Strides {
  long long b, h, s;
};

// HD: the head dim padded to a multiple of 32 (32, 64, 128 or 256)
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int S,
             int Tk, int hd, Strides qs, Strides ks, Strides vs, Strides os,
             int causal, int window, int q_offset, float scale) {
  constexpr int DPL = HD / 32;       // output dims per lane
  constexpr int KT = BK + 1;         // padded row of transposed K
  extern __shared__ __align__(16) float smem[];
  float* sh_q = smem;                // [BQ][HD]
  float* sh_kt = sh_q + BQ * HD;     // [HD][KT]
  float* sh_v = sh_kt + HD * KT;     // [BK][HD]

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const T* qp = q + b * qs.b + h * qs.h;
  const T* kp = k + b * ks.b + h * ks.h;
  const T* vp = v + b * vs.b + h * vs.h;
  T* op = o + b * os.b + h * os.h;

  for (int idx = threadIdx.x; idx < BQ * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD, i = i0 + r;
    sh_q[idx] = (i < S && d < hd) ? load_f(qp + i * qs.s + d) * scale : 0.0f;
  }

  // keys any real row of this block can see
  const int pos_lo = i0 + q_offset;
  const int pos_hi = min(i0 + BQ, S) - 1 + q_offset;
  int k_end = causal ? min(Tk, pos_hi + 1) : Tk;
  int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  k_begin -= k_begin % BK;

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < DPL; ++e) acc[r][e] = 0.0f;
  }
  const float* qw = sh_q + warp * ROWS * HD;
  const int pos0 = i0 + warp * ROWS + q_offset;  // position of the warp's row 0

  for (int j0 = k_begin; j0 < k_end; j0 += BK) {
    __syncthreads();  // the previous tile's reads are done (and q is staged)
    for (int idx = threadIdx.x; idx < BK * HD; idx += THREADS) {
      const int jj = idx / HD, d = idx % HD, j = j0 + jj;
      const bool ok = j < Tk && d < hd;
      sh_kt[d * KT + jj] = ok ? load_f(kp + j * ks.s + d) : 0.0f;
      sh_v[jj * HD + d] = ok ? load_f(vp + j * vs.s + d) : 0.0f;
    }
    __syncthreads();

    // scores of the warp's rows against key j0 + lane
    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k0 = sh_kt[(d + 0) * KT + lane];
      const float k1 = sh_kt[(d + 1) * KT + lane];
      const float k2 = sh_kt[(d + 2) * KT + lane];
      const float k3 = sh_kt[(d + 3) * KT + lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * HD + d);
        s[r] = fmaf(qv.x, k0, s[r]);
        s[r] = fmaf(qv.y, k1, s[r]);
        s[r] = fmaf(qv.z, k2, s[r]);
        s[r] = fmaf(qv.w, k3, s[r]);
      }
    }

    // mask, then the online softmax update; s becomes p
    const int j = j0 + lane;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int pos = pos0 + r;
      bool vis = j < Tk;
      if (causal) vis = vis && pos >= j;
      if (window > 0) vis = vis && (pos - j) < window;
      const float sc = vis ? s[r] : NEG_INF;
      const float m_new = fmaxf(m[r], warp_max(sc));
      const float p = expf(sc - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < DPL; ++e) acc[r][e] *= corr;
      s[r] = p;
    }

    // acc += P . V, lane owning dims lane, lane + 32, ...
#pragma unroll 4
    for (int jj = 0; jj < BK; ++jj) {
      float vv[DPL];
#pragma unroll
      for (int e = 0; e < DPL; ++e) vv[e] = sh_v[jj * HD + e * 32 + lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float pj = __shfl_sync(FULL, s[r], jj);
#pragma unroll
        for (int e = 0; e < DPL; ++e) acc[r][e] = fmaf(pj, vv[e], acc[r][e]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = i0 + warp * ROWS + r;
    if (i >= S) continue;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < DPL; ++e) {
      const int d = e * 32 + lane;
      if (d < hd) store_f(op + i * os.s + d, acc[r][e] / den);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int S, int Tk, int hd, Strides qs, Strides ks, Strides vs,
           Strides os, int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * HD + HD * (BK + 1) + BK * HD);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_kernel<T, HD><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, S, Tk, hd, qs, ks, vs,
      os, causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int S, int Tk, int hd, Strides qs, Strides ks,
             Strides vs, Strides os, int causal, int window, int q_offset,
             float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, B, H, S, Tk, hd, qs, ks, vs, os, causal,
                         window, q_offset, scale, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, H, S, Tk, hd, qs, ks, vs, os, causal,
                         window, q_offset, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, H, S, Tk, hd, qs, ks, vs, os,
                          causal, window, q_offset, scale, stream);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, o, B, H, S, Tk, hd, qs, ks, vs, os,
                          causal, window, q_offset, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch,
// or wgmma_fa::ENCODE_ERROR (+ the CUresult) when a TMA tensor map is
// refused. q (B, H, S, hd), k and v (B, H, T, hd), o (B, H, S, hd), each
// given by its element strides (dim contiguous), float32 (is_bf16 = 0) or
// bfloat16. The wrapper checks devices, types, shapes and strides (for
// bfloat16, the 16-byte alignment TMA needs) and allocates o. `lse` is
// null, or (bfloat16 only) float32 of B * H * wgmma_fa::lse_rows(S), which
// receives each row's log-sum-exp in base 2 for the gradient kernel.
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
  if (lse != nullptr) return (int)cudaErrorInvalidValue;
  const Strides qs{qsb, qsh, qss}, ks{ksb, ksh, kss}, vs{vsb, vsh, vss},
      os{osb, osh, oss};
  return dispatch<float>(q, k, v, o, B, H, S, Tk, hd, qs, ks, vs, os, causal,
                         window, q_offset, scale, st);
}
