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
// Two instantiations of one kernel. The keyed one (imc_fused_keyed_launch)
// draws the noise itself: eps_pos, eps_neg and the output-noise field z_out
// come from split(fold_in(k_noise, flat[p]), 3) with the threefry2x32 of
// threefry.cuh, bit for bit as repro_torch/random.py draws them, at counter
// k * N + n of the untiled (K, N) weight shape (b * N + n for z_out). The
// TPU kernel took the eps fields from memory because jax.random does not
// lower inside Pallas; the other instantiation (imc_fused_launch) keeps that
// interface and reads them.
//
// Design. One thread-block cluster of C CTAs per (design, 32 output
// columns), C = the largest power of two up to min(sub-tiles, 8); the
// sub-tile axis the TPU grid walked in order is split over the cluster in
// rounds: in each round CTA r takes sub-tile r0 + r. It forms that
// sub-tile's w_eff (sub x 32, drawing its noise) in its own shared memory,
// then computes the sub-tile's 8 bit-plane partial sums for a group of 32
// batch rows (one thread per row and 4 columns, one float4 of w_eff per
// k). After cluster.sync() each CTA owns 1/C of the row group's outputs
// and reads their partial sums from the round's CTAs through distributed
// shared memory (cluster.map_shared_rank) in sub-tile order, adding them
// into the crossbar-group sums and quantizing at group ends as the plain
// version does. Each normal is drawn once per design whenever one round
// covers K (up to 8 sub-tiles: the w_eff stays for the next row group);
// with more rounds it is drawn once per 32 batch rows, so the shared memory
// does not grow with B or K. At the main path's P=120, B=32, K=256, sub=64
// that is one round, one row group and 480 CTAs of 256 threads for the 132
// SMs. Each thread of the draw interleaves two elements, four threefry
// chains, because the hash is a serial chain of dependent integer
// operations.
//
// The bit-plane sums skip unset bits. Each term of a partial sum is
// added by a predicated add.rn.f32 whose predicate is the term's bit
// (predicated_add.cuh, shared with imc_matmul.cu), in ascending k; every
// term of the plain version's sums is 0 * w or 1 * w, and adding a zero
// to an accumulator that starts at +0.0 changes no bit
// (it can never become -0.0 under round-to-nearest), so the skipped terms
// leave the plain version's sums unchanged and the kernel agrees with
// `imc_fused_plain` / `imc_fused_keyed_plain` (repro_torch/kernels/
// imc_fused.py) bit for bit. A term costs one predicated add plus a
// quarter of the bit test shared by a thread's 4 columns. Walking the set
// bits of warp-uniform 64-bit masks instead (__ffsll, one batch row per
// warp) issues about half the adds but ~10 instructions and a dependent
// shared load per set bit: measured 3x slower than this kernel's
// predecessor on the H100, so the adds are predicated, not walked. All
// arithmetic uses __f*_rn intrinsics or .rn PTX, so nvcc cannot fuse it
// into FMAs the plain PyTorch version lacks. No tensor cores: a wgmma sums
// a k-group in its own order and precision, and a moved last bit of a
// crossbar sum moves an ADC code (one code is up to 2^7 * rows / 512 at
// the analog scale, 16 at 64 rows), which breaks that bitwise contract.
//
// Bound on an H100 SXM at the main path's shape (B=32, K=256, N=32, sub=64,
// P=120; chip_smoke.py computes it from each run's inputs): per design
// 2*K*N + B*N = 17,408 normal draws of ~75 INT32 operations of threefry and
// uniform each, ~157 M in all, at 64 lanes x 132 SMs x 1.98 GHz = 16.7 T/s
// is ~9.4 us; their 17 conversions to and from float64 at 16 per SM and
// clock ~8.5 us; the 16 float64 adds and multiplies of each erf_inv at 64
// lanes ~2 us; float32 work (the adds of the set bits only, the noise
// arithmetic) ~5.6 us; memory (x_q, w, rows, table read once, raw and
// z_out written once, ~1 MB) ~0.3 us. So the INT32 pipe bounds it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "adc.cuh"
#include "predicated_add.cuh"
#include "threefry.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int RG = 32;             // batch rows per row group
constexpr int TN = 32;             // output columns per cluster
constexpr int CPT = 4;             // columns per thread in the partial sums
constexpr int CG = TN / CPT;       // column groups of a row
constexpr int OUT_RG = RG * TN;    // outputs of a row group
constexpr int BITS = 8;            // bit-serial activation planes
constexpr int MAX_CLUSTER = 8;     // portable cluster size
constexpr int STATE = BITS + 1;    // per output: 8 group sums + the total

struct FusedArgs {
  const int* x_q;              // (B, K) activation codes
  const float* w;              // (K, N)
  const float* eps_pos;        // (P, K, N), eps instantiation only
  const float* eps_neg;        // (P, K, N), eps instantiation only
  const long long* key;        // (2,) k_noise, keyed instantiation only
  const long long* flat;       // (P,) flat design index, keyed only
  const int* rows_idx;         // (P,)
  const float* row_table;      // (n_table,)
  float* out;                  // (P, B, N)
  float* z_out;                // (P, B, N), keyed only
  int B, K, N, sub, n_sub, adc_bits, n_table;
  int words;                   // 4-code words of a sub-tile row
  int xs;                      // shared row stride of the codes, in words
};

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

// w_eff at row k and column n; zero past K and N (the zero-padded ragged
// edges). The keyed kernel draws the element's two normals at its index in
// the untiled (K, N) shape.
template <bool KEYED>
__device__ __forceinline__ float weff_at(const FusedArgs& a, int p, int k,
                                         int n, TfKey kp, TfKey kn, float ir) {
  if (k >= a.K || n >= a.N) return 0.0f;
  const size_t o = (size_t)k * a.N + n;
  float ep, en;
  if constexpr (KEYED) {
    ep = tf_normal(kp, (uint32_t)o);
    en = tf_normal(kn, (uint32_t)o);
  } else {
    const size_t po = (size_t)p * a.K * a.N + o;
    ep = a.eps_pos[po];
    en = a.eps_neg[po];
  }
  return noisy_weight(a.w[o], ep, en, ir);
}

template <bool KEYED>
__global__ void __launch_bounds__(THREADS, 4)
imc_fused_kernel(const FusedArgs a) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int p = blockIdx.x / C;
  const int n0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int rows_pad = a.words * 4;      // sub rounded up to whole words
  const int n_rg = (a.B + RG - 1) / RG;
  const int n_rounds = (a.n_sub + C - 1) / C;
  const int own = OUT_RG / C;            // outputs of a row group per CTA

  float* sh_part = reinterpret_cast<float*>(smem4);   // [q][row][col]
  float* sh_w = sh_part + BITS * OUT_RG;              // [k][col]
  unsigned* sh_x = reinterpret_cast<unsigned*>(sh_w + rows_pad * TN);
  float* sh_state = reinterpret_cast<float*>(sh_x + RG * a.xs);
  __shared__ TfKey sh_keys[3];

  // value-table gather, clamped like an XLA gather
  const int ri = min(max(a.rows_idx[p], 0), a.n_table - 1);
  const float rows = a.row_table[ri];
  // ir_drop_factor: 1 - (beta * activity) * (rows / 512)
  const float ir = __fsub_rn(1.0f, __fmul_rn(0.02f, __fdiv_rn(rows, 512.0f)));
  // ADC at full scale rows / 4 (adc.cuh)
  const Adc adc = adc_make(__fdiv_rn(rows, 4.0f), a.adc_bits);
  const float subf = (float)a.sub;

  if constexpr (KEYED) {
    if (tid < 3) {
      // split(fold_in(k_noise, flat[p]), 3)[tid]: eps_pos, eps_neg, z_out
      const TfKey base{(uint32_t)a.key[0], (uint32_t)a.key[1]};
      sh_keys[tid] = tf_split(tf_fold_in(base, (uint32_t)a.flat[p]), tid);
    }
    __syncthreads();
  }
  TfKey kp{}, kn{};
  if constexpr (KEYED) {
    kp = sh_keys[0];
    kn = sh_keys[1];
  }

  const int row = tid / CG, cg = tid % CG;  // partial sums: a row, 4 columns
  for (int g = 0; g < n_rg; ++g) {
    const int b0 = g * RG;
    for (int r0 = 0; r0 < a.n_sub; r0 += C) {
      const int s = r0 + rank;                 // this CTA's sub-tile
      const int k0 = s * a.sub;
      const bool mine = s < a.n_sub;
      const int r1 = min(r0 + C, a.n_sub);     // the round's sub-tiles
      // 1. w_eff of the sub-tile (kept for the next row group when there is
      // one round), two elements per thread per step; rows past sub (whole
      // words) and past K, and columns past N, are zero
      if (mine && (g == 0 || n_rounds > 1)) {
        for (int i = tid; i < rows_pad * TN; i += 2 * THREADS) {
          const int i1 = min(i + THREADS, rows_pad * TN - 1);
          const int kr0 = i / TN, kr1 = i1 / TN;
          const float v0 =
              kr0 < a.sub
                  ? weff_at<KEYED>(a, p, k0 + kr0, n0 + i % TN, kp, kn, ir)
                  : 0.0f;
          const float v1 =
              kr1 < a.sub
                  ? weff_at<KEYED>(a, p, k0 + kr1, n0 + i1 % TN, kp, kn, ir)
                  : 0.0f;
          sh_w[i] = v0;
          if (i + THREADS < rows_pad * TN) sh_w[i1] = v1;
        }
      }
      // 2. the row group's codes of the sub-tile, 4 per word (0 past B, K)
      if (mine) {
        for (int i = tid; i < RG * a.words; i += THREADS) {
          const int rr = i / a.words, kw = i % a.words;
          unsigned word = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kr = kw * 4 + j, k = k0 + kr;
            if (b0 + rr < a.B && kr < a.sub && k < a.K)
              word |= (unsigned)(a.x_q[(size_t)(b0 + rr) * a.K + k] & 0xff)
                      << (8 * j);
          }
          sh_x[rr * a.xs + kw] = word;
        }
      }
      __syncthreads();
      // 3. the sub-tile's bit-plane partial sums: k ascending, set bits only
      if (mine) {
        float4 part[BITS];
#pragma unroll
        for (int q = 0; q < BITS; ++q) part[q] = make_float4(0.f, 0.f, 0.f, 0.f);
        const unsigned* xr = sh_x + row * a.xs;
        const float4* wc = reinterpret_cast<const float4*>(sh_w) + cg;
        for (int kw = 0; kw < a.words; ++kw) {
          const unsigned x4 = xr[kw];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 wv = wc[(kw * 4 + j) * CG];
            const unsigned xv = x4 >> (8 * j);
#pragma unroll
            for (int q = 0; q < BITS; ++q) add_if(part[q], wv, xv & (1u << q));
          }
        }
        float4* pr = reinterpret_cast<float4*>(sh_part) + row * CG + cg;
#pragma unroll
        for (int q = 0; q < BITS; ++q) pr[q * RG * CG] = part[q];
      }
      cluster.sync();
      // 4. this CTA's outputs of the row group: the round's partial sums in
      // sub-tile order into the crossbar-group sums, the ADC at group ends;
      // the sums wait in shared memory between rounds, the last round
      // writes the outputs
      for (int o = tid; o < own; o += THREADS) {
        const int oi = rank * own + o;
        float* st = sh_state + (size_t)o * STATE;
        float grp[BITS], acc = 0.0f;
#pragma unroll
        for (int q = 0; q < BITS; ++q) grp[q] = r0 > 0 ? st[q] : 0.0f;
        if (r0 > 0) acc = st[BITS];
        for (int t = r0; t < r1; ++t) {
          const float* rp = cluster.map_shared_rank(sh_part, t - r0);
#pragma unroll
          for (int q = 0; q < BITS; ++q)
            grp[q] = __fadd_rn(grp[q], rp[q * OUT_RG + oi]);
          // crossbar-group boundary: the next sub-tile starts a new crossbar
          const float sf = (float)t;
          const bool group_end =
              (t == a.n_sub - 1) ||
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
        if (r1 < a.n_sub) {
#pragma unroll
          for (int q = 0; q < BITS; ++q) st[q] = grp[q];
          st[BITS] = acc;
          continue;
        }
        const int b = b0 + oi / TN, n = n0 + oi % TN;
        if (b >= a.B || n >= a.N) continue;
        const size_t off = ((size_t)p * a.B + b) * a.N + n;
        a.out[off] = acc;
        if constexpr (KEYED)
          a.z_out[off] = tf_normal(sh_keys[2], (uint32_t)(b * a.N + n));
      }
      cluster.sync();  // partial sums read before the next pass rewrites them
    }
  }
}

// the normal transform of threefry.cuh on given 32-bit words
__global__ void normal_of_bits_kernel(const long long* __restrict__ bits,
                                      float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = tf_normal_of_bits((uint32_t)bits[i]);
}

template <bool KEYED>
int launch(FusedArgs a, int P, void* stream) {
  if (P == 0 || a.B == 0 || a.N == 0) return 0;
  a.n_sub = (a.K + a.sub - 1) / a.sub;
  a.words = (a.sub + 3) / 4;
  a.xs = a.words | 1;  // odd: the 4 rows a warp reads sit in 4 banks
  int C = 1;
  while (C * 2 <= a.n_sub && C * 2 <= MAX_CLUSTER) C *= 2;
  const size_t smem =
      ((size_t)BITS * OUT_RG + (size_t)a.words * 4 * TN) * sizeof(float) +
      (size_t)RG * a.xs * sizeof(unsigned) +
      (size_t)(OUT_RG / C) * STATE * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        imc_fused_kernel<KEYED>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * C, (a.N + TN - 1) / TN, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, imc_fused_kernel<KEYED>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// Launch functions on `stream` (PyTorch's current stream); each returns
// cudaGetLastError() (or the launch's own error) so the Python wrapper can
// raise on a refused launch. The wrappers check devices, dtypes, shapes and
// contiguity and allocate the outputs.

// eps read from memory: eps_pos / eps_neg (P, K, N) -> out (P, B, N)
extern "C" int imc_fused_launch(const void* x_q, const void* w,
                                const void* eps_pos, const void* eps_neg,
                                const void* rows_idx, const void* row_table,
                                void* out, int P, int B, int K, int N, int sub,
                                int adc_bits, int n_table, void* stream) {
  FusedArgs a = {};
  a.x_q = static_cast<const int*>(x_q);
  a.w = static_cast<const float*>(w);
  a.eps_pos = static_cast<const float*>(eps_pos);
  a.eps_neg = static_cast<const float*>(eps_neg);
  a.rows_idx = static_cast<const int*>(rows_idx);
  a.row_table = static_cast<const float*>(row_table);
  a.out = static_cast<float*>(out);
  a.B = B; a.K = K; a.N = N; a.sub = sub; a.adc_bits = adc_bits;
  a.n_table = n_table;
  return launch<false>(a, P, stream);
}

// noise drawn in the kernel from key (2,) int64 and flat (P,) int64:
// out and z_out (P, B, N)
extern "C" int imc_fused_keyed_launch(const void* x_q, const void* w,
                                      const void* key, const void* flat,
                                      const void* rows_idx,
                                      const void* row_table, void* out,
                                      void* z_out, int P, int B, int K, int N,
                                      int sub, int adc_bits, int n_table,
                                      void* stream) {
  FusedArgs a = {};
  a.x_q = static_cast<const int*>(x_q);
  a.w = static_cast<const float*>(w);
  a.key = static_cast<const long long*>(key);
  a.flat = static_cast<const long long*>(flat);
  a.rows_idx = static_cast<const int*>(rows_idx);
  a.row_table = static_cast<const float*>(row_table);
  a.out = static_cast<float*>(out);
  a.z_out = static_cast<float*>(z_out);
  a.B = B; a.K = K; a.N = N; a.sub = sub; a.adc_bits = adc_bits;
  a.n_table = n_table;
  return launch<true>(a, P, stream);
}

// normals of n 32-bit words (held in int64, as repro_torch/random.py holds
// them): the draw's transform alone, for the tests
extern "C" int normal_of_bits_launch(const void* bits, void* out, int n,
                                     void* stream) {
  if (n == 0) return 0;
  normal_of_bits_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      static_cast<const long long*>(bits), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}
