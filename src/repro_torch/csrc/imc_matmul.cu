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
// Bound on an H100 SXM (data-sheet peaks, 700 W). At the qwen3-4b QKV
// projection (M=16, K=2560, N=12288) the 8 bit-plane sums are
// 8 * M * K * N = 4.03 G float32 adds, of which the set bits of the codes
// need about half; at 128 FP32 lanes x 132 SMs x 1.98 GHz = 33.5 T adds/s
// that is ~0.120 ms dense and ~0.06 ms for the set bits alone, against
// 126.8 MB of operands (~0.038 ms at 3.35 TB/s): the adds bound it, and an
// add costs an issue slot whether its predicate is set or not. At the host
// accuracy oracle's shape (32 x 256 times 256 x 32) the work is ~2 M adds
// and the kernel is launch latency.
//
// Design. The TPU grid (M/bm, N/bn, K/R) walked its K axis in order and
// accumulated into the output block across grid steps. Here:
// - One CTA computes whole crossbar tiles for 16 rows of M and 32 output
//   columns: the tile's k-ordered bit-plane sums, their ADC and the shift-
//   accumulate of bits 0..7 (the tile's value). A thread holds one row and
//   8 columns (64 threads, 64 accumulators). Each term is one
//   predicated add.rn.f32 (predicated_add.cuh) whose predicate is the
//   term's activation bit, tested once for the 8 columns (ptxas loads 7 of
//   a code's 8 bits into predicates with one R2P); a row's 16 next codes
//   arrive in one 16-byte shared load of bytes, and a k's 8 weights in two
//   float4 loads shared by 64 adds: ~1.12 instructions a term.
// - The CTA stages the weights of 32 k-rows x 32 columns at a time in a
//   3-slot shared-memory ring filled by cp.async, so the next chunks load
//   while this one is summed, and each weight is read from device memory
//   once per 16-row block. The codes are read into registers one chunk
//   ahead and stored in shared memory as bytes.
// - The crossbar tiles of a column slab, the K/R axis, are spread over the
//   C CTAs of a thread-block cluster (C <= 8): in round j CTA r computes
//   tile j * C + r and writes the tile's values to its shared memory;
//   after cluster.sync() each CTA owns 1/C of the slab's outputs and adds
//   the round's tile values into them in tile order, reading the other
//   CTAs' shared memory (cluster.map_shared_rank). The tile values are
//   double-buffered, so one cluster.sync() a round suffices.
// - The launcher picks C for the shape: the fewest waves times rounds,
//   waves counted against the CTAs the runtime can keep resident in
//   clusters of C (cudaOccupancyMaxActiveClusters), ties to the larger C.
//   Small CTAs balance the adds over the 132 SMs; a few clusters per SM
//   keep enough warps to issue an add nearly every cycle. At the
//   projection that is C=5 for R=512 (1,920 CTAs, one round) and C=2 for
//   R=64..256; the host oracle's 2 slabs take C = T.
// - Where the product has fewer crossbar tiles than the card has SMs (the
//   host oracle's), a thread holds 4 columns (128 threads a CTA), so each
//   of the few CTAs has half as long a chain of adds.
// - The weights arrive by 16-byte cp.async, or by 4-byte ones where N is
//   not a multiple of 4 or w is not 16-byte aligned.
// - No atomics, no tensor cores (a wgmma sums a k-group in its own order
//   and precision, which moves ADC codes), no library GEMM.
//
// Why the kernel is bitwise equal to imc_matmul_plain
// (repro_torch/kernels/imc_matmul.py) for any w_scale and ADC width: the
// plain version adds the R terms of a bit-plane sum in k order, runs the
// ADC, adds bits 0..7 of a tile in order, then the tiles in order 0..T-1,
// each a separately rounded float32 operation. The kernel makes the same
// operations in the same order: the adds of a bit-plane sum in ascending
// k (the skipped ones are exact zeros, see predicated_add.cuh, for finite
// weights), the ADC as a true division and rintf (adc.cuh), the bits in
// order, and the tiles in order across ranks and rounds. It relies on no
// step being exact, so a full scale whose ADC step is not a power of two
// (w_scale != 1), whose tile values round when added, gives the same bits
// (the ADC's exact reciprocal for a power-of-two step, adc.cuh, rounds
// as the division does). All arithmetic is __f*_rn intrinsics or .rn PTX;
// no fast math.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "adc.cuh"
#include "predicated_add.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int TM = 16;           // rows of M per CTA
constexpr int TN = 32;           // output columns per CTA
constexpr int OUT = TM * TN;     // outputs of a CTA
constexpr int KC = 32;           // k rows of a tile per pipeline chunk
constexpr int STAGES = 3;        // weight chunks in the shared ring
constexpr int KG = 16;           // codes per 16-byte shared load
constexpr int BITS = 8;          // bit-serial activation planes
constexpr int MAX_CLUSTER = 8;   // portable cluster size

// threads of a CTA whose threads hold CPT columns each
constexpr int threads_of(int cpt) { return TM * TN / cpt; }

struct MatmulArgs {
  const int* x_q;    // (M, K) codes
  const float* w;    // (K, N) weights
  float* out;        // (M, N)
  int M, K, N, R;
  int T;             // K / R crossbar tiles
  int nch;           // chunks of KC rows per tile
  int adc_bits;
  float full_scale;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(full ? 4 : 0));
}

// one predicated add per column of a thread's NQ float4 groups
template <int NQ>
__device__ __forceinline__ void add_bits(float4 (&p)[NQ],
                                         const float4 (&w)[NQ],
                                         unsigned bit) {
  if constexpr (NQ == 1)
    add_if(p[0], w[0], bit);
  else
    add_if(p[0], p[1], w[0], w[1], bit);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// shared memory of a CTA in a cluster of C: the weight ring, the double-
// buffered tile values, the codes (bytes) and this CTA's output sums
size_t smem_bytes(int C) {
  return (size_t)(STAGES * KC * TN + 2 * OUT + (OUT + C - 1) / C) *
             sizeof(float) +
         2 * TM * KC;
}

// CPT columns a thread (8 or 4); VEC: the weights arrive by 16-byte
// cp.async (N % 4 == 0, w 16-byte aligned), else by 4-byte ones
template <int CPT, bool VEC>
__global__ void __launch_bounds__(threads_of(CPT), 4)
imc_matmul_kernel(const MatmulArgs a) {
  constexpr int CGS = TN / CPT;          // column groups of a row
  constexpr int THREADS = TM * CGS;
  constexpr int NQ = CPT / 4;            // float4 groups of a thread
  constexpr int QS = TN / NQ;            // distance between them
  constexpr int CODES = TM * KC / THREADS;  // codes a thread stages
  static_assert((CPT == 4 || CPT == 8) && QS == 4 * CGS, "thread tile");
  static_assert(KC % CODES == 0 && KC % KG == 0, "chunk");

  extern __shared__ float4 smem4[];
  float* sh_w = reinterpret_cast<float*>(smem4);      // [STAGES][KC][TN]
  float* sh_tile = sh_w + STAGES * KC * TN;           // [2][TM][TN]
  unsigned char* sh_x =
      reinterpret_cast<unsigned char*>(sh_tile + 2 * OUT);  // [2][TM][KC]
  float* sh_acc = reinterpret_cast<float*>(sh_x + 2 * TM * KC);  // [own]

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int n0 = (blockIdx.x / C) * TN;
  const int m0 = blockIdx.y * TM;
  const int tid = threadIdx.x;
  const int row = tid / CGS, cgi = tid % CGS;
  const int n_rounds = (a.T + C - 1) / C;
  const int n_mine = (a.T - rank + C - 1) / C;   // rounds with a tile
  const int total = n_mine * a.nch;              // this CTA's chunks
  const int own = (OUT + C - 1) / C;             // outputs this CTA sums
  const int o0 = rank * own, o1 = min(o0 + own, OUT);
  const Adc adc = adc_make(a.full_scale, a.adc_bits);

  // chunk i of this CTA: round i / nch (tile (i / nch) * C + rank), rows
  // (i % nch) * KC .. of that tile
  auto chunk_k0 = [&](int i) {
    return ((i / a.nch) * C + rank) * a.R + (i % a.nch) * KC;
  };
  auto chunk_kn = [&](int i) { return min(KC, a.R - (i % a.nch) * KC); };

  // weights of chunk i into ring slot i % STAGES; rows past the tile and
  // columns past N are zero; one cp.async group per chunk, empty past the
  // last, so wait_group counts stay uniform
  auto issue_weights = [&](int i) {
    if (i < total) {
      const int k0 = chunk_k0(i), kn = chunk_kn(i);
      float* dst = sh_w + (i % STAGES) * KC * TN;
      constexpr int V = VEC ? 4 : 1;  // floats a copy
      for (int u = tid; u < KC * TN / V; u += THREADS) {
        const int kr = u / (TN / V), c = V * (u % (TN / V));
        const bool in = kr < kn && n0 + c < a.N;
        const float* src = in ? a.w + (size_t)(k0 + kr) * a.N + n0 + c : a.w;
        if constexpr (VEC)
          cp_async16(dst + kr * TN + c, src, in);
        else
          cp_async4(dst + kr * TN + c, src, in);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  // codes of chunk i: this thread's CODES consecutive k of one row, into
  // registers (0 past M and past the tile), later stored as bytes
  const int xe = tid * CODES, xrow = xe / KC, xk = xe % KC;
  int xr[CODES];
  auto load_codes = [&](int i) {
    const bool live = i < total && m0 + xrow < a.M;
    const int k0 = live ? chunk_k0(i) : 0, kn = live ? chunk_kn(i) : 0;
#pragma unroll
    for (int j = 0; j < CODES; ++j)
      xr[j] = xk + j < kn
                  ? __ldg(a.x_q + (size_t)(m0 + xrow) * a.K + k0 + xk + j)
                  : 0;
  };
  auto store_codes = [&](int i) {
    unsigned char* dst = sh_x + (i & 1) * TM * KC + xrow * KC + xk;
#pragma unroll
    for (int j = 0; j < CODES; ++j) dst[j] = (unsigned char)(xr[j] & 0xff);
  };

  for (int s = 0; s < STAGES - 1; ++s) issue_weights(s);
  load_codes(0);
  store_codes(0);

  float4 part[BITS][NQ];
  int i = 0;
  for (int j = 0; j < n_rounds; ++j) {
    float* tile_buf = sh_tile + (j & 1) * OUT;
    if (j < n_mine) {
#pragma unroll
      for (int q = 0; q < BITS; ++q)
#pragma unroll
        for (int g = 0; g < NQ; ++g)
          part[q][g] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int c = 0; c < a.nch; ++c, ++i) {
        asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
        // chunk i has landed for every thread, and every thread is done
        // with chunk i - 1: its ring slot and code buffer are free
        __syncthreads();
        issue_weights(i + STAGES - 1);
        load_codes(i + 1);
        const float* ws = sh_w + (i % STAGES) * KC * TN + 4 * cgi;
        const unsigned char* xs = sh_x + (i & 1) * TM * KC + row * KC;
#pragma unroll 1
        for (int kg = 0; kg < KC; kg += KG) {
          const uint4 xv = *reinterpret_cast<const uint4*>(xs + kg);
          const unsigned words[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
          for (int kk = 0; kk < KG; ++kk) {
            float4 wv[NQ];
#pragma unroll
            for (int g = 0; g < NQ; ++g)
              wv[g] = *reinterpret_cast<const float4*>(
                  ws + (kg + kk) * TN + g * QS);
            const unsigned word = words[kk / 4];
            // the term's bits, k ascending; one test for the CPT columns
#pragma unroll
            for (int q = 0; q < BITS; ++q)
              add_bits<NQ>(part[q], wv, word & (1u << (8 * (kk % 4) + q)));
          }
        }
        store_codes(i + 1);
      }
      // the tile's crossbar: ADC each bit plane, shift-accumulate bits 0..7
#pragma unroll
      for (int g = 0; g < NQ; ++g) {
        float t[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          t[e] = 0.0f;
#pragma unroll
          for (int q = 0; q < BITS; ++q)
            t[e] = __fadd_rn(t[e], __fmul_rn(adc_quantize(comp(part[q][g], e),
                                                          adc),
                                             (float)(1 << q)));
        }
        *reinterpret_cast<float4*>(tile_buf + row * TN + g * QS + 4 * cgi) =
            make_float4(t[0], t[1], t[2], t[3]);
      }
    }
    cluster.sync();
    // this CTA's outputs: the round's tile values in tile order (rank s
    // holds tile j * C + s); the double-buffered tile values are not
    // rewritten before every CTA has passed the next cluster.sync()
    const int n_tiles = min(C, a.T - j * C);
    for (int o = o0 + tid; o < o1; o += THREADS) {
      float acc = j == 0 ? 0.0f : sh_acc[o - o0];
      for (int s = 0; s < n_tiles; ++s)
        acc = __fadd_rn(acc, cluster.map_shared_rank(tile_buf, s)[o]);
      sh_acc[o - o0] = acc;
    }
  }
  // every CTA's tile values read before any CTA exits
  cluster.sync();
  for (int o = o0 + tid; o < o1; o += THREADS) {
    const int m = m0 + o / TN, n = n0 + o % TN;
    if (m < a.M && n < a.N) a.out[(size_t)m * a.N + n] = sh_acc[o - o0];
  }
}

cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int C,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(C);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// CTAs the card keeps resident at once in clusters of C, per device (the
// runtime's answer is fixed for a kernel and a card, so it is asked once;
// the 16-byte route's answer stands for both routes)
template <int CPT>
long long resident_ctas(int C, int dev) {
  static int known[64][MAX_CLUSTER + 1] = {};
  if (dev >= 0 && dev < 64 && known[dev][C]) return known[dev][C];
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(C), threads_of(CPT), C, nullptr, &attr);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, imc_matmul_kernel<CPT, true>, &cfg);
  cudaGetLastError();  // a refused query leaves no error for the launch
  if (e != cudaSuccess || n < 1) n = 1;
  if (dev >= 0 && dev < 64) known[dev][C] = n * C;
  return (long long)n * C;
}

// the cluster size with the fewest waves times rounds; ties to the larger
template <int CPT>
int cluster_size(long long units, int T, int dev) {
  int best_c = 1;
  long long best = -1;
  for (int c = 1; c <= MAX_CLUSTER && c <= T; ++c) {
    const long long resident = resident_ctas<CPT>(c, dev);
    const long long cost =
        (units * c + resident - 1) / resident * ((T + c - 1) / c);
    if (best < 0 || cost <= best) {
      best = cost;
      best_c = c;
    }
  }
  return best_c;
}

// the columns a thread holds for a product of `units` 16 x 32 output
// blocks and T crossbar tiles: 4 where the tiles are fewer than the SMs
int columns_per_thread(long long units, int T, int dev) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return units * T < sms ? 4 : 8;
}

template <int CPT>
int launch(const MatmulArgs& a, long long slabs, long long blocks, int dev,
           cudaStream_t s) {
  const int C = cluster_size<CPT>(slabs * blocks, a.T, dev);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3((unsigned)(slabs * C), (unsigned)blocks),
                     threads_of(CPT), C, s, &attr);
  const bool vec =
      a.N % 4 == 0 && (reinterpret_cast<uintptr_t>(a.w) & 15) == 0;
  const cudaError_t e =
      vec ? cudaLaunchKernelEx(&cfg, imc_matmul_kernel<CPT, true>, a)
          : cudaLaunchKernelEx(&cfg, imc_matmul_kernel<CPT, false>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream); returns cudaGetLastError()
// (or the launch's own error) so the Python wrapper can raise on a refused
// launch. The wrapper checks devices, dtypes, shapes (K a multiple of R) and
// contiguity and allocates `out` (M, N).
extern "C" int imc_matmul_launch(const void* x_q, const void* w, void* out,
                                 int M, int K, int N, int R, int adc_bits,
                                 float full_scale, void* stream) {
  if (M == 0 || N == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  MatmulArgs a = {};
  a.x_q = static_cast<const int*>(x_q);
  a.w = static_cast<const float*>(w);
  a.out = static_cast<float*>(out);
  a.M = M; a.K = K; a.N = N; a.R = R;
  a.T = K / R;
  a.nch = (R + KC - 1) / KC;
  a.adc_bits = adc_bits;
  a.full_scale = full_scale;
  if (a.T == 0) {  // no crossbar: the plain version's zeros
    const cudaError_t e =
        cudaMemsetAsync(out, 0, (size_t)M * N * sizeof(float), s);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  }
  int dev = 0;
  cudaGetDevice(&dev);
  const long long slabs = (N + TN - 1) / TN, blocks = (M + TM - 1) / TM;
  return columns_per_thread(slabs * blocks, a.T, dev) == 8
             ? launch<8>(a, slabs, blocks, dev, s)
             : launch<4>(a, slabs, blocks, dev, s);
}

// what imc_matmul_launch picks for an (M, K) x (K, N) product with R-row
// crossbars on the current device: the cluster size and the columns a
// thread holds (0 and 0 where it launches nothing), for the chip smoke's
// report
extern "C" int imc_matmul_plan(int M, int K, int N, int R, void* cluster,
                               void* columns) {
  int dev = 0, C = 0, cpt = 0;
  cudaGetDevice(&dev);
  if (M > 0 && N > 0 && R > 0 && K / R > 0) {
    const long long units =
        (long long)((N + TN - 1) / TN) * ((M + TM - 1) / TM);
    cpt = columns_per_thread(units, K / R, dev);
    C = cpt == 8 ? cluster_size<8>(units, K / R, dev)
                 : cluster_size<4>(units, K / R, dev);
  }
  *static_cast<int*>(cluster) = C;
  *static_cast<int*>(columns) = cpt;
  return (int)cudaGetLastError();
}
