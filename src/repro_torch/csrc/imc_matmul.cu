// Bit-serial crossbar GEMM for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_imc_kernel` of
// src/repro/kernels/imc_matmul.py:29 (pallas_call in `imc_matmul`, :68).
// x_q (M, K) int32 activation codes in [0, 255] times w (K, N) float32
// pre-noised weights, K a multiple of the crossbar row count R. For each
// R-row K-tile (one physical crossbar) it forms the 8 bit-plane column sums
// s_b = sum_k bit_b(x[m, k]) * w[k, n], quantizes each with the signed
// mid-tread ADC at full scale w_scale * R / 4 (adc.cuh), and shift-
// accumulates: out[m, n] = sum_tiles sum_b 2^b * q(s_b).
//
// Design. The TPU grid (M/bm, N/bn, K/R) walked its K axis in order and
// accumulated into the output block across grid steps; here that axis is a
// loop inside the block. One block per (8 rows of M, 32 output columns),
// 256 threads, one thread per output holding its 8 bit-plane sums of the
// current K-tile in registers. The block stages KC rows of the tile at a
// time in shared memory: the activation codes (8 x KC, read as a warp-wide
// broadcast, since a warp shares its row m) and the weights (KC x 32, one
// column per lane). No atomics, no tensor cores.
//
// Rounding, and why the kernel is bitwise equal to imc_matmul_plain
// (repro_torch/kernels/imc_matmul.py):
// - every term of a bit-plane sum is 0 or w exactly, so the only rounding
//   before the ADC is the order of the R additions; kernel and plain add
//   them in k order, 0 to R-1 (__fadd_rn, no contraction);
// - the ADC is a true division by delta and rintf (half to even);
// - after the ADC everything is exact on the registry's paths: each term is
//   an integer code of at most 2^(adc_bits-1) times delta * 2^b, and delta is
//   a power of two for every registry row count (64..512) at w_scale = 1, so
//   while n_tiles * 255 * 2^(adc_bits-1) < 2^24 no order of the shift-
//   accumulate can round. With the 8-bit ADC that holds with margin (K = 2560,
//   R = 64: 40 tiles give 1.3e6), so the Pallas kernel's order (bits within
//   a tile, then tiles) and the reference oracle's (tiles, then bits) give
//   the same bits. A 12-bit ADC reaches the limit near 32 tiles, so kernel
//   and plain keep the Pallas order: bits 0..7 within a tile, then tiles.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W). At the qwen3-4b QKV
// projection (M=16, K=2560, N=12288) the 8 bit-plane GEMMs are
// 2 * 8 * M * K * N = 8.05 GFLOP of float32 (~0.120 ms at 67 TFLOP/s)
// against 126.8 MB of operands (~0.038 ms at 3.35 TB/s): the operations
// bound it. At the host accuracy oracle's shape (32 x 256 times 256 x 32)
// the work is ~4 MFLOP and the kernel is pure launch latency. The bit
// extraction and select cost integer instructions beside each add; tensor
// cores (wgmma) on the 0/1 planes with float32 accumulation in this fixed
// order are later work.
#include <cuda_runtime.h>

#include <cstddef>

#include "adc.cuh"

namespace {

constexpr int TM = 8;             // rows of M per block
constexpr int TN = 32;            // output columns per block (one warp)
constexpr int THREADS = TM * TN;  // one thread per output
constexpr int KC = 64;            // K rows staged in shared memory at a time
constexpr int BITS = 8;           // bit-serial activation planes

__global__ void __launch_bounds__(THREADS)
imc_matmul_kernel(const int* __restrict__ x_q, const float* __restrict__ w,
                  float* __restrict__ out, int M, int K, int N, int R,
                  int adc_bits, float full_scale) {
  __shared__ int sh_x[TM * KC];
  __shared__ float sh_w[KC * TN];

  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int tid = threadIdx.x, tm = tid / TN, tn = tid % TN;
  const Adc adc = adc_make(full_scale, adc_bits);
  const int n_tiles = K / R;

  float acc = 0.0f;
  for (int t = 0; t < n_tiles; ++t) {
    float part[BITS];
#pragma unroll
    for (int q = 0; q < BITS; ++q) part[q] = 0.0f;
    for (int kc = 0; kc < R; kc += KC) {
      const int k0 = t * R + kc;
      const int kn = min(KC, R - kc);
      __syncthreads();  // the previous chunk's shared reads are done
      for (int i = tid; i < kn * TN; i += THREADS) {
        const int gn = n0 + i % TN;
        sh_w[i] = gn < N ? w[(size_t)(k0 + i / TN) * N + gn] : 0.0f;
      }
      for (int i = tid; i < TM * kn; i += THREADS) {
        const int gm = m0 + i / kn;
        sh_x[(i / kn) * KC + i % kn] =
            gm < M ? x_q[(size_t)gm * K + k0 + i % kn] : 0;
      }
      __syncthreads();
      for (int k = 0; k < kn; ++k) {
        const int xv = sh_x[tm * KC + k];
        const float wv = sh_w[k * TN + tn];
#pragma unroll
        for (int q = 0; q < BITS; ++q)
          part[q] = __fadd_rn(part[q], ((xv >> q) & 1) ? wv : 0.0f);
      }
    }
    // the tile's crossbar: ADC each bit plane, shift-accumulate bits 0..7
    float tile = 0.0f;
#pragma unroll
    for (int q = 0; q < BITS; ++q)
      tile = __fadd_rn(tile, __fmul_rn(adc_quantize(part[q], adc),
                                       (float)(1 << q)));
    acc = __fadd_rn(acc, tile);
  }
  const int m = m0 + tm, n = n0 + tn;
  if (m < M && n < N) out[(size_t)m * N + n] = acc;
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. The wrapper checks
// devices, dtypes, shapes (K a multiple of R) and contiguity and allocates
// `out` (M, N).
extern "C" int imc_matmul_launch(const void* x_q, const void* w, void* out,
                                 int M, int K, int N, int R, int adc_bits,
                                 float full_scale, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  imc_matmul_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      static_cast<const int*>(x_q), static_cast<const float*>(w),
      static_cast<float*>(out), M, K, N, R, adc_bits, full_scale);
  return (int)cudaGetLastError();
}
