// Fused noisy-crossbar population GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_kernel` of
// src/repro/kernels/imc_fused.py (pallas_call in `imc_fused_gemm`). Per
// design p it gathers the crossbar row count `rows = row_table[rows_idx[p]]`,
// injects conductance noise into the differential weight pair
// (g = clip(clip(+-w, 0, 1) + sigma(g) * eps, 0, 1)), forms
// w_eff = (g+ - g-) * ir_drop(rows), runs the 8 bit-plane GEMMs of the
// activation codes against w_eff in sub-tiles of `sub` rows, quantizes the
// running crossbar sums with the signed mid-tread ADC at every crossbar-group
// boundary (floor((s+1)*sub/rows) != floor(s*sub/rows)) and shift-accumulates
// the codes: out[p, b, n] = sum_groups sum_bits 2^bit * q.
//
// Design. The TPU grid walked (design, sub-tile) in order and carried the
// bit-plane sums in VMEM from one sub-tile to the next; here the sub-tile axis
// is a loop inside the block. One block per (design, 8 batch rows, 32 output
// columns), 256 threads, one thread per output (b, n) holding its 8 sub-tile
// partial sums and 8 crossbar-group sums in registers. For each sub-tile the
// block stages w_eff (sub x 32, noise applied on the fly) and the activation
// codes (8 x sub) in shared memory. The sums are IEEE float32 adds in a fixed
// order (k within the sub-tile, then sub-tiles in order), with no tensor cores
// and no contraction: each term is 0 or w_eff exactly, so the kernel agrees
// bit for bit with `imc_fused_plain` (repro_torch/kernels/imc_fused.py),
// which sums in the same order. The noise arithmetic uses __f*_rn intrinsics
// so that nvcc cannot fuse it into FMAs the plain PyTorch version lacks.
//
// Bound on an H100 SXM at the main-path shape (B=32, K=256, N=32, sub=64,
// P=120 designs): 2*8*B*K*N*P = 0.50 GFLOP of float32 against ~8.4 MB of
// input (the eps fields dominate), so the FP32 rate bounds it (~7.5 us at
// 67 TFLOP/s) and memory does not (~2.5 us at 3.35 TB/s). The bit extraction
// costs integer instructions on top of each add; making this fast (tensor
// cores on the 0/1 planes, the threefry noise draw fused into the kernel so
// eps never reaches HBM) is later work.
#include <cuda_runtime.h>

#include <cstddef>

#include "adc.cuh"

namespace {

constexpr int TB = 8;             // batch rows per block
constexpr int TN = 32;            // output columns per block (one warp)
constexpr int THREADS = TB * TN;  // one thread per output
constexpr int BITS = 8;           // bit-serial activation planes

__device__ __forceinline__ float clip01(float v) {
  return fminf(fmaxf(v, 0.0f), 1.0f);
}

// sigma(g) / g_max: SIGMA_POLY (c0 + c1 g + ... + c4 g^4) clipped to [0, 0.5],
// in the plain version's operation order
__device__ __forceinline__ float sigma_of_g(float g) {
  const float g2 = __fmul_rn(g, g);
  const float g3 = __fmul_rn(g, g2);
  const float g4 = __fmul_rn(g2, g2);
  float s = __fadd_rn(0.010f, __fmul_rn(0.150f, g));
  s = __fadd_rn(s, __fmul_rn(-0.133f, g2));
  s = __fadd_rn(s, __fmul_rn(-0.0005f, g3));
  s = __fadd_rn(s, __fmul_rn(0.0396f, g4));
  return fminf(fmaxf(s, 0.0f), 0.5f);
}

__device__ __forceinline__ float noisy_weight(float w, float ep, float en,
                                              float ir) {
  float gp = clip01(w);
  gp = clip01(__fadd_rn(gp, __fmul_rn(sigma_of_g(gp), ep)));
  float gn = clip01(-w);
  gn = clip01(__fadd_rn(gn, __fmul_rn(sigma_of_g(gn), en)));
  return __fmul_rn(__fsub_rn(gp, gn), ir);
}

__global__ void __launch_bounds__(THREADS)
imc_fused_kernel(const int* __restrict__ x_q, const float* __restrict__ w,
                 const float* __restrict__ eps_pos,
                 const float* __restrict__ eps_neg,
                 const int* __restrict__ rows_idx,
                 const float* __restrict__ row_table, float* __restrict__ out,
                 int B, int K, int N, int sub, int n_sub, int adc_bits,
                 int n_table) {
  extern __shared__ float smem[];
  float* sh_w = smem;                                   // sub x TN
  int* sh_x = reinterpret_cast<int*>(smem + sub * TN);  // TB x sub

  const int p = blockIdx.x;
  const int b0 = blockIdx.y * TB, n0 = blockIdx.z * TN;
  const int tid = threadIdx.x, tb = tid / TN, tn = tid % TN;
  const int b = b0 + tb, n = n0 + tn;

  // value-table gather, clamped like an XLA gather
  const int ri = min(max(rows_idx[p], 0), n_table - 1);
  const float rows = row_table[ri];
  // ir_drop_factor: 1 - (beta * activity) * (rows / 512)
  const float ir = __fsub_rn(1.0f, __fmul_rn(0.02f, __fdiv_rn(rows, 512.0f)));
  // ADC at full scale rows / 4 (adc.cuh)
  const Adc adc = adc_make(__fdiv_rn(rows, 4.0f), adc_bits);
  const float subf = (float)sub;

  const size_t kn = (size_t)K * N;
  const float* ep = eps_pos + (size_t)p * kn;
  const float* en = eps_neg + (size_t)p * kn;

  float grp[BITS], part[BITS];
#pragma unroll
  for (int q = 0; q < BITS; ++q) grp[q] = 0.0f;
  float acc = 0.0f;

  for (int s = 0; s < n_sub; ++s) {
    const int k0 = s * sub;
    __syncthreads();  // the previous sub-tile's shared reads are done
    for (int i = tid; i < sub * TN; i += THREADS) {
      const int gk = k0 + i / TN, gn = n0 + i % TN;
      float we = 0.0f;  // zero-padded ragged K and N
      if (gk < K && gn < N) {
        const size_t o = (size_t)gk * N + gn;
        we = noisy_weight(w[o], ep[o], en[o], ir);
      }
      sh_w[i] = we;
    }
    for (int i = tid; i < TB * sub; i += THREADS) {
      const int gb = b0 + i / sub, gk = k0 + i % sub;
      sh_x[i] = (gb < B && gk < K) ? x_q[(size_t)gb * K + gk] : 0;
    }
    __syncthreads();

#pragma unroll
    for (int q = 0; q < BITS; ++q) part[q] = 0.0f;
    for (int k = 0; k < sub; ++k) {
      const int xv = sh_x[tb * sub + k];
      const float wv = sh_w[k * TN + tn];
#pragma unroll
      for (int q = 0; q < BITS; ++q)
        part[q] = __fadd_rn(part[q], ((xv >> q) & 1) ? wv : 0.0f);
    }
#pragma unroll
    for (int q = 0; q < BITS; ++q) grp[q] = __fadd_rn(grp[q], part[q]);

    // crossbar-group boundary: the next sub-tile starts a new crossbar
    const float sf = (float)s;
    const bool group_end =
        (s == n_sub - 1) ||
        floorf(__fdiv_rn(__fmul_rn(sf + 1.0f, subf), rows)) !=
            floorf(__fdiv_rn(__fmul_rn(sf, subf), rows));
    if (group_end) {
#pragma unroll
      for (int q = 0; q < BITS; ++q) {
        acc = __fadd_rn(acc, __fmul_rn(adc_quantize(grp[q], adc),
                                       (float)(1 << q)));
        grp[q] = 0.0f;
      }
    }
  }
  if (b < B && n < N) out[((size_t)p * B + b) * N + n] = acc;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. The wrapper checks
// devices, dtypes, shapes and contiguity and allocates `out` (P, B, N).
extern "C" int imc_fused_launch(const void* x_q, const void* w,
                                const void* eps_pos, const void* eps_neg,
                                const void* rows_idx, const void* row_table,
                                void* out, int P, int B, int K, int N, int sub,
                                int adc_bits, int n_table, void* stream) {
  if (P == 0 || B == 0 || N == 0) return 0;
  const int n_sub = (K + sub - 1) / sub;
  const size_t smem = (size_t)sub * TN * sizeof(float) +
                      (size_t)TB * sub * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        imc_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(P, (B + TB - 1) / TB, (N + TN - 1) / TN);
  imc_fused_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const int*>(x_q), static_cast<const float*>(w),
      static_cast<const float*>(eps_pos), static_cast<const float*>(eps_neg),
      static_cast<const int*>(rows_idx), static_cast<const float*>(row_table),
      static_cast<float*>(out), B, K, N, sub, n_sub, adc_bits, n_table);
  return (int)cudaGetLastError();
}
