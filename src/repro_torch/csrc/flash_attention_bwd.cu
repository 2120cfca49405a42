// The gradient of blockwise (flash) attention for Hopper (sm_90a).
//
// The JAX package has no Pallas backward: it trains by differentiating the
// jnp `blockwise_attention` (src/repro/models/attention.py:29) under
// jax.value_and_grad. The port's forward is the hand-written kernel of
// flash_attention.cu (replacing `_flash_kernel`,
// src/repro/kernels/flash_attention.py:25, pallas_call at :93), so its
// gradient is this kernel. Given q (B, H, S, hd), k and v (B, H, T, hd), the
// forward's output o and its gradient dO, it computes dq, dk and dv under
// the forward's masks: key j is visible to query row i when j < T (the true
// length), i + q_offset >= j when causal and (i + q_offset) - j < window
// when window > 0. With s_ij = (q_i * scale) . k_j, P_ij = exp(s_ij - lse_i)
// over the visible keys and D_i = dO_i . o_i:
//   dv_j = sum_i P_ij dO_i
//   dS_ij = P_ij (dO_i . v_j - D_i)
//   dk_j = sum_i dS_ij (q_i * scale)
//   dq_i = scale * sum_j dS_ij k_j
//
// Two routes, each with its own C entry, chosen by type in the Python
// wrapper. bfloat16 (the training paths, head dims up to 256) runs on the
// tensor cores: flash_attention_bwd_wgmma.cuh (TMA, wgmma, the forward's
// saved log-sum-exp). Float32 runs the CUDA-core kernels of this file, three
// on the caller's stream, one after another:
//   1. stats_kernel: per (b, h, 32 query rows), lse_i by an online max and
//      sum over the visible key tiles, and D_i.
//   2. dkdv_kernel: per (b, h, 32 keys), K and V stay in shared memory
//      while the block walks the query tiles that can see them; each tile
//      stages q (scaled), dO, lse and D, recomputes P and dS (32 x 32) into
//      shared memory, then accumulates dk and dv.
//   3. dq_kernel: per (b, h, 32 query rows), q and dO stay in shared memory
//      while the block walks the visible key tiles, recomputing P and dS.
// Every output element is summed by one thread in a fixed order (query
// tiles, then rows, in order), so the result is deterministic: no float
// atomics. Accumulation is float32 on the CUDA cores. Inputs may be strided
// views (the transposes of (B, S, H, hd) tensors that ops.flash_mha passes);
// the head dim is contiguous. The head dim is padded to HD in {32, 64, 128,
// 256} with zeros.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W). The gradient's least work
// is 5 products of S x T x hd a head (dO.v, the recomputed q.k, P^T dO,
// dS^T q, dS k): at S = T = 4096, H = 32, hd = 128, causal, 2.5 x the
// forward's 137.5 GFLOP = 344 GFLOP, 0.35 ms at 989 TFLOP/s bf16 (the bytes,
// ~0.3 GB, take 0.1 ms). The CUDA-core route computes 8 such products (q.k
// three times, dO.v twice) in float32, ~550 GFLOP, so it cannot beat 8.2 ms
// at 67 TFLOP/s; its shared-memory reads (two a fused multiply-add) bound it
// well below that. The tensor-core route's bound is in its header.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_attention_bwd_wgmma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BQ = 32;  // query rows per tile
constexpr int BK = 32;  // keys per tile
constexpr int GROUP = THREADS / BQ;  // threads sharing a row (8)
constexpr int PP = BK + 1;           // padded row of the P and dS tiles
constexpr float NEG_INF = -1.0e30f;

// element strides of a (batch, head, seq, dim) view; dim is contiguous
struct Strides {
  long long b, h, s;
};

struct Views {
  Strides q, k, v, o, dout, dq, dk, dv;
};

__device__ __forceinline__ bool visible(int pos, int j, int Tk, int causal,
                                        int window) {
  bool vis = j < Tk;
  if (causal) vis = vis && pos >= j;
  if (window > 0) vis = vis && (pos - j) < window;
  return vis;
}

// max and sum over the GROUP consecutive lanes that share a row; the xor
// butterfly leaves the same bits on every lane of the group
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = GROUP / 2; o > 0; o >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// rows row0 .. row0 + 31 of a (L, hd) slice into a [32][HD + 1] tile, times
// mul, zero past L and past hd
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src,
                                      long long stride, int row0, int L,
                                      int hd, float mul) {
  constexpr int HP = HD + 1;
  for (int idx = threadIdx.x; idx < 32 * HD; idx += THREADS) {
    const int r = idx / HD, d = idx % HD, row = row0 + r;
    dst[r * HP + d] =
        (row < L && d < hd) ? src[row * stride + d] * mul : 0.0f;
  }
}

// the four scores s_ij = q_i . k_j of thread (i = t / 8, j = t % 8 + 8c)
template <int HD>
__device__ __forceinline__ void scores(const float* sh_q, const float* sh_k,
                                       float s[4]) {
  constexpr int HP = HD + 1;
  const int i = threadIdx.x / GROUP, jc = threadIdx.x % GROUP;
#pragma unroll
  for (int c = 0; c < 4; ++c) s[c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    const float qd = sh_q[i * HP + d];
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s[c] = fmaf(qd, sh_k[(jc + GROUP * c) * HP + d], s[c]);
  }
}

// P and dS of a (query tile i0, key tile j0) pair into [BQ][PP] tiles
template <int HD>
__device__ __forceinline__ void p_and_ds(
    const float* sh_q, const float* sh_do, const float* sh_k,
    const float* sh_v, const float* sh_lse, const float* sh_dd, float* sh_p,
    float* sh_ds, int i0, int j0, int S, int Tk, int causal, int window,
    int q_offset) {
  const int i = threadIdx.x / GROUP, jc = threadIdx.x % GROUP;
  float s[4], dp[4];
  scores<HD>(sh_q, sh_k, s);
  scores<HD>(sh_do, sh_v, dp);
  const bool row_ok = i0 + i < S;
  const int pos = i0 + i + q_offset;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int j = jc + GROUP * c;
    const bool vis = row_ok && visible(pos, j0 + j, Tk, causal, window);
    const float p = vis ? expf(s[c] - sh_lse[i]) : 0.0f;
    sh_p[i * PP + j] = p;
    sh_ds[i * PP + j] = p * (dp[c] - sh_dd[i]);
  }
}

// the key tiles [k_begin, k_end) that any row of query tile i0 can see
__device__ __forceinline__ void key_range(int i0, int S, int Tk, int causal,
                                          int window, int q_offset,
                                          int* k_begin, int* k_end) {
  const int pos_lo = i0 + q_offset;
  const int pos_hi = min(i0 + BQ, S) - 1 + q_offset;
  *k_end = causal ? min(Tk, pos_hi + 1) : Tk;
  int kb = window > 0 ? max(0, pos_lo - window + 1) : 0;
  *k_begin = kb - kb % BK;
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ o, const float* __restrict__ dout,
             float* __restrict__ lse, float* __restrict__ dd, int H, int S,
             int Tk, int hd, Views vw, int causal, int window, int q_offset,
             float scale) {
  constexpr int HP = HD + 1;
  extern __shared__ __align__(16) float smem[];
  float* sh_q = smem;            // [BQ][HP]
  float* sh_k = sh_q + BQ * HP;  // [BK][HP]
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int i0 = blockIdx.x * BQ;
  const int i = threadIdx.x / GROUP, jc = threadIdx.x % GROUP;
  const float* qp = q + b * vw.q.b + h * vw.q.h;
  const float* kp = k + b * vw.k.b + h * vw.k.h;
  stage<HD>(sh_q, qp, vw.q.s, i0, S, hd, scale);

  int k_begin, k_end;
  key_range(i0, S, Tk, causal, window, q_offset, &k_begin, &k_end);
  const int pos = i0 + i + q_offset;
  float m = NEG_INF, l = 0.0f;
  for (int j0 = k_begin; j0 < k_end; j0 += BK) {
    __syncthreads();  // the previous tile's reads are done
    stage<HD>(sh_k, kp, vw.k.s, j0, Tk, hd, 1.0f);
    __syncthreads();
    float s[4];
    scores<HD>(sh_q, sh_k, s);
    float mx = NEG_INF;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!visible(pos, j0 + jc + GROUP * c, Tk, causal, window))
        s[c] = NEG_INF;
      mx = fmaxf(mx, s[c]);
    }
    const float m_new = fmaxf(m, group_max(mx));
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) sum += expf(s[c] - m_new);
    l = l * expf(m - m_new) + group_sum(sum);
    m = m_new;
  }
  // every lane stays for the shuffles; a row past S reads nothing
  const bool row_ok = i0 + i < S;
  const float* op = o + b * vw.o.b + h * vw.o.h + (i0 + i) * vw.o.s;
  const float* dp =
      dout + b * vw.dout.b + h * vw.dout.h + (i0 + i) * vw.dout.s;
  float acc = 0.0f;
  for (int d = jc; row_ok && d < hd; d += GROUP)
    acc = fmaf(dp[d], op[d], acc);
  acc = group_sum(acc);
  if (row_ok && jc == 0) {
    const long long r = (long long)blockIdx.y * S + i0 + i;
    lse[r] = m + logf(l);
    dd[r] = acc;
  }
}

// lse and D of rows row0 .. row0 + 31 into shared memory (0 past S)
__device__ __forceinline__ void stage_rows(float* sh_lse, float* sh_dd,
                                          const float* lse, const float* dd,
                                          long long base, int row0, int S) {
  if (threadIdx.x < BQ) {
    const int row = row0 + threadIdx.x;
    sh_lse[threadIdx.x] = row < S ? lse[base + row] : 0.0f;
    sh_dd[threadIdx.x] = row < S ? dd[base + row] : 0.0f;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ dd,
            float* __restrict__ dk, float* __restrict__ dv, int H, int S,
            int Tk, int hd, Views vw, int causal, int window, int q_offset,
            float scale) {
  constexpr int HP = HD + 1;
  constexpr int E = HD / GROUP;  // dims a thread accumulates
  extern __shared__ __align__(16) float smem[];
  float* sh_k = smem;               // [BK][HP]
  float* sh_v = sh_k + BK * HP;     // [BK][HP]
  float* sh_q = sh_v + BK * HP;     // [BQ][HP]
  float* sh_do = sh_q + BQ * HP;    // [BQ][HP]
  float* sh_p = sh_do + BQ * HP;    // [BQ][PP]
  float* sh_ds = sh_p + BQ * PP;    // [BQ][PP]
  float* sh_lse = sh_ds + BQ * PP;  // [BQ]
  float* sh_dd = sh_lse + BQ;       // [BQ]
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int j0 = blockIdx.x * BK;
  const float* qp = q + b * vw.q.b + h * vw.q.h;
  const float* dop = dout + b * vw.dout.b + h * vw.dout.h;
  stage<HD>(sh_k, k + b * vw.k.b + h * vw.k.h, vw.k.s, j0, Tk, hd, 1.0f);
  stage<HD>(sh_v, v + b * vw.v.b + h * vw.v.h, vw.v.s, j0, Tk, hd, 1.0f);

  // the query rows that can see any key of this tile
  const int j_last = min(j0 + BK, Tk) - 1;
  const int i_begin = causal ? max(0, j0 - q_offset) : 0;
  const int i_end = window > 0 ? min(S, j_last + window - q_offset) : S;

  const int jt = threadIdx.x / GROUP, dc = threadIdx.x % GROUP;
  float ak[E], av[E];
#pragma unroll
  for (int e = 0; e < E; ++e) ak[e] = av[e] = 0.0f;
  for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
    __syncthreads();  // the previous tile's reads are done (K, V staged)
    stage<HD>(sh_q, qp, vw.q.s, i0, S, hd, scale);
    stage<HD>(sh_do, dop, vw.dout.s, i0, S, hd, 1.0f);
    stage_rows(sh_lse, sh_dd, lse, dd, (long long)blockIdx.y * S, i0, S);
    __syncthreads();
    p_and_ds<HD>(sh_q, sh_do, sh_k, sh_v, sh_lse, sh_dd, sh_p, sh_ds, i0,
                 j0, S, Tk, causal, window, q_offset);
    __syncthreads();
    for (int r = 0; r < BQ; ++r) {
      const float p = sh_p[r * PP + jt], ds = sh_ds[r * PP + jt];
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int d = dc + GROUP * e;
        av[e] = fmaf(p, sh_do[r * HP + d], av[e]);
        ak[e] = fmaf(ds, sh_q[r * HP + d], ak[e]);
      }
    }
  }
  const int j = j0 + jt;
  if (j >= Tk) return;
  float* dkp = dk + b * vw.dk.b + h * vw.dk.h + j * vw.dk.s;
  float* dvp = dv + b * vw.dv.b + h * vw.dv.h + j * vw.dv.s;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = dc + GROUP * e;
    if (d < hd) {
      dkp[d] = ak[e];
      dvp[d] = av[e];
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, const float* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dd,
          float* __restrict__ dq, int H, int S, int Tk, int hd, Views vw,
          int causal, int window, int q_offset, float scale) {
  constexpr int HP = HD + 1;
  constexpr int E = HD / GROUP;
  extern __shared__ __align__(16) float smem[];
  float* sh_k = smem;
  float* sh_v = sh_k + BK * HP;
  float* sh_q = sh_v + BK * HP;
  float* sh_do = sh_q + BQ * HP;
  float* sh_p = sh_do + BQ * HP;
  float* sh_ds = sh_p + BQ * PP;
  float* sh_lse = sh_ds + BQ * PP;
  float* sh_dd = sh_lse + BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int i0 = blockIdx.x * BQ;
  const float* kp = k + b * vw.k.b + h * vw.k.h;
  const float* vp = v + b * vw.v.b + h * vw.v.h;
  stage<HD>(sh_q, q + b * vw.q.b + h * vw.q.h, vw.q.s, i0, S, hd, scale);
  stage<HD>(sh_do, dout + b * vw.dout.b + h * vw.dout.h, vw.dout.s, i0, S,
            hd, 1.0f);
  stage_rows(sh_lse, sh_dd, lse, dd, (long long)blockIdx.y * S, i0, S);

  int k_begin, k_end;
  key_range(i0, S, Tk, causal, window, q_offset, &k_begin, &k_end);
  const int it = threadIdx.x / GROUP, dc = threadIdx.x % GROUP;
  float aq[E];
#pragma unroll
  for (int e = 0; e < E; ++e) aq[e] = 0.0f;
  for (int j0 = k_begin; j0 < k_end; j0 += BK) {
    __syncthreads();  // the previous tile's reads are done (q, dO staged)
    stage<HD>(sh_k, kp, vw.k.s, j0, Tk, hd, 1.0f);
    stage<HD>(sh_v, vp, vw.v.s, j0, Tk, hd, 1.0f);
    __syncthreads();
    p_and_ds<HD>(sh_q, sh_do, sh_k, sh_v, sh_lse, sh_dd, sh_p, sh_ds, i0,
                 j0, S, Tk, causal, window, q_offset);
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      const float ds = sh_ds[it * PP + c];
#pragma unroll
      for (int e = 0; e < E; ++e)
        aq[e] = fmaf(ds, sh_k[c * HP + dc + GROUP * e], aq[e]);
    }
  }
  const int i = i0 + it;
  if (i >= S) return;
  float* dqp = dq + b * vw.dq.b + h * vw.dq.h + i * vw.dq.s;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int d = dc + GROUP * e;
    if (d < hd) dqp[d] = aq[e] * scale;
  }
}

template <typename K>
int allow_smem(K kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, void* dq, void* dk, void* dv, float* lse,
           float* dd, int B, int H, int S, int Tk, int hd, const Views& vw,
           int causal, int window, int q_offset, float scale,
           cudaStream_t stream) {
  constexpr int HP = HD + 1;
  const size_t smem_stats = sizeof(float) * (BQ + BK) * HP;
  const size_t smem_tiles =
      sizeof(float) * (2 * BK * HP + 2 * BQ * HP + 2 * BQ * PP + 2 * BQ);
  int err;
  if ((err = allow_smem(stats_kernel<HD>, smem_stats))) return err;
  if ((err = allow_smem(dkdv_kernel<HD>, smem_tiles))) return err;
  if ((err = allow_smem(dq_kernel<HD>, smem_tiles))) return err;
  const float* qt = static_cast<const float*>(q);
  const float* kt = static_cast<const float*>(k);
  const float* vt = static_cast<const float*>(v);
  const float* dot = static_cast<const float*>(dout);
  const dim3 q_grid((S + BQ - 1) / BQ, B * H), k_grid((Tk + BK - 1) / BK,
                                                      B * H);
  stats_kernel<HD><<<q_grid, THREADS, smem_stats, stream>>>(
      qt, kt, static_cast<const float*>(o), dot, lse, dd, H, S, Tk, hd, vw,
      causal, window, q_offset, scale);
  if ((err = (int)cudaGetLastError())) return err;
  dkdv_kernel<HD><<<k_grid, THREADS, smem_tiles, stream>>>(
      qt, kt, vt, dot, lse, dd, static_cast<float*>(dk),
      static_cast<float*>(dv), H, S, Tk, hd, vw, causal, window, q_offset,
      scale);
  if ((err = (int)cudaGetLastError())) return err;
  dq_kernel<HD><<<q_grid, THREADS, smem_tiles, stream>>>(
      qt, kt, vt, dot, lse, dd, static_cast<float*>(dq), H, S, Tk, hd, vw,
      causal, window, q_offset, scale);
  return (int)cudaGetLastError();
}

// every head dim <= 256, zero-padded to 32, 64, 128 or 256
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dout, void* dq, void* dk, void* dv, float* lse,
             float* dd, int B, int H, int S, int Tk, int hd,
             const Views& vw, int causal, int window, int q_offset,
             float scale, cudaStream_t st) {
#define FA_BWD_LAUNCH(HD)                                                 \
  return launch<HD>(q, k, v, o, dout, dq, dk, dv, lse, dd, B, H, S, Tk, hd, \
                    vw, causal, window, q_offset, scale, st)
  if (hd <= 32) FA_BWD_LAUNCH(32);
  if (hd <= 64) FA_BWD_LAUNCH(64);
  if (hd <= 128) FA_BWD_LAUNCH(128);
  if (hd <= 256) FA_BWD_LAUNCH(256);
#undef FA_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Two C entries, one a route; the Python wrapper picks the route by type
// (kernels/flash_attention.py:bwd_route) and calls its entry,
// so the route it records is the one launched. Each launches its kernels on
// `stream` (PyTorch's current stream) and returns the first
// cudaGetLastError() that is not 0, so the wrapper can raise on a refused
// launch (or wgmma_fa::ENCODE_ERROR + the CUresult when a TMA tensor map is
// refused). q, o, dout and dq are (B, H, S, hd), k, v, dk and dv (B, H, T,
// hd), each given by its element strides in `strides` (8 views x (batch,
// head, seq); dim contiguous). The wrapper checks devices, types, shapes and
// strides and allocates the outputs and the scratch. When T = 0 the wrapper
// zero-fills dq itself.
//
// flash_attention_bwd_launch: the CUDA-core kernels above, float32, hd <=
// 256; lse and dd are float32 scratch of B * H * S that the stats kernel
// fills.
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, void* dq, void* dk, void* dv, void* lse, void* dd,
    int B, int H, int S, int Tk, int hd, const long long* strides,
    int causal, int window, int q_offset, float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0 || Tk == 0) return 0;
  const long long* s = strides;
  const Views vw{{s[0], s[1], s[2]},    {s[3], s[4], s[5]},
                 {s[6], s[7], s[8]},    {s[9], s[10], s[11]},
                 {s[12], s[13], s[14]}, {s[15], s[16], s[17]},
                 {s[18], s[19], s[20]}, {s[21], s[22], s[23]}};
  return dispatch(q, k, v, o, dout, dq, dk, dv, static_cast<float*>(lse),
                  static_cast<float*>(dd), B, H, S, Tk, hd, vw, causal,
                  window, q_offset, scale, (cudaStream_t)stream);
}

// flash_attention_bwd_wgmma_launch: the tensor-core kernels of
// flash_attention_bwd_wgmma.cuh, bfloat16, hd <= 256. lse is the forward's
// log-sum-exp (base 2, B * H * wgmma_fa::lse_rows(S) floats, an input) and
// dd float32 scratch of the same size; q, k, v and dout meet TMA's 16-byte
// rule.
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
