// The mLSTM scan of xLSTM's matrix-memory blocks, for Hopper (sm_90a).
//
// Replaces the reference's `lax.scan` over `_mlstm_cell` in `mlstm_sequence`
// (src/repro/models/recurrent.py:116, the scan at :124, the cell at :101;
// the JAX package has no Pallas kernel there), and the second scan its
// prefill runs only to get the final state (src/repro/models/transformer.py
// :331-343). For every batch row b and head of q, k, v (B, S, H, HD) and
// the gate pre-activations i, f (B, S, H), all float32, it runs the cell
// from the state C (B, H, HD, HD), n (B, H, HD), m (B, H):
//   log_f = -softplus(-f),  m' = max(log_f + m, i),
//   i_g = exp(i - m'),  f_g = exp((log_f + m) - m'),
//   C' = f_g C + i_g (v k^T),  n' = f_g n + i_g k,
//   h = (C' q) / max(|n' . q|, 1),
// writes h (B, S, H, HD) and leaves the final state in C, n, m (in place).
// Every product and sum is rounded on its own (__fmul_rn, __fadd_rn: no
// contraction into FMAs), as the plain version's tensor operations round
// them, so the state carried from step to step is the plain version's; the
// two dot products are summed in the order of `kernel_order_dot`
// (kernels/mlstm_scan.py). The transcendentals are CUDA's expf and log1pf
// (no fast math).
//
// Design. Row i of C depends only on v_i, on the whole of k and q and on
// the per-(b, head) scalars m, i_g, f_g. So a warp owns RW rows of C of one
// (b, head) for the whole sequence and keeps them in registers: lane l holds
// columns l, l + 32, ... (HD / 32 of them, at least 1). Every warp also
// keeps its own copy of n (the same columns) and m, and recomputes the
// scalars, n' and den = max(|n' . q|, 1) in a fixed order, so the warps
// never talk to each other and all of them hold bit-identical n and m. A
// block is WARPS such warps, ROWS = WARPS x RW rows of one (b, head); the
// grid is B x H x HD / ROWS blocks (128 at B = 1, H = 4, HD = 512: one a
// SM). There is no shared memory and no barrier inside the time loop: a
// lane loads step t + 1's q and k columns, v rows and gates into registers
// before it computes step t, so the loads are in flight during the step.
// The row sums C' q and n' . q are a lane's columns in order, then the
// warp's lanes pairwise by __shfl_xor_sync. At the end each warp writes its
// rows of C back, and the last block of a (b, head) to finish (an arrival
// counter a (b, head), returned to zero) writes n and m: every other block
// has read them by then. At HD = 512 a lane holds 64 C values, 16 of n and
// 2 x 32 of q and k.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): operations. At (B, S, H,
// HD) = (1, 4096, 4, 512) the C update and C' q are 6 float32 operations an
// element of C a step, 25.8 GFLOP with n's, 0.39 ms at 67 TFLOP/s; q, k, v
// and h are 134 MB, C read and written 8.4 MB, 0.043 ms at 3.35 TB/s. As no
// product is fused with a sum, the operations run at half the FMA peak.
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;          // warps a block
constexpr int RW = 4;             // rows of C a warp
constexpr int ROWS = WARPS * RW;  // rows of C a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), as torch's logaddexp
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

template <int HD>
__global__ void __launch_bounds__(WARPS * 32)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, float* __restrict__ C,
                  float* __restrict__ n, float* __restrict__ m,
                  float* __restrict__ h, int* __restrict__ arrivals, int S,
                  int H) {
  constexpr int CPL = HD >= 32 ? HD / 32 : 1;  // columns a lane
  constexpr int TILES = HD / ROWS;             // blocks a (b, head)
  static_assert(HD % ROWS == 0 && (HD < 32 || HD % 32 == 0), "head width");
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bh = blockIdx.x / TILES;  // b * H + head
  const int b = bh / H, head = bh % H;
  const int row0 = (blockIdx.x % TILES) * ROWS + warp * RW;
  const bool on = HD >= 32 || lane < HD;

  float c_reg[RW][CPL], n_reg[CPL];
  float m_reg = m[bh];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
    n_reg[c] = on ? n[(size_t)bh * HD + j] : 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r)
      c_reg[r][c] =
          on ? C[((size_t)bh * HD + row0 + r) * HD + j] : 0.f;
  }

  // step t's inputs: q, k columns of this lane, v rows of this warp, gates
  float q_nx[CPL], k_nx[CPL], v_nx[RW], i_nx, f_nx;
  auto load = [&](int t) {
    const size_t g = ((size_t)b * S + t) * H + head;
    const float* qt = q + g * HD;
    const float* kt = k + g * HD;
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      q_nx[c] = on ? __ldg(qt + lane + 32 * c) : 0.f;
      k_nx[c] = on ? __ldg(kt + lane + 32 * c) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) v_nx[r] = __ldg(v + g * HD + row0 + r);
    i_nx = __ldg(ig + g);
    f_nx = __ldg(fg + g);
  };
  load(0);
  for (int t = 0; t < S; ++t) {
    float q_c[CPL], k_c[CPL], v_c[RW];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      q_c[c] = q_nx[c];
      k_c[c] = k_nx[c];
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) v_c[r] = v_nx[r];
    const float i_pre = i_nx, f_pre = f_nx;
    if (t + 1 < S) load(t + 1);
    // the gates: every lane of every warp the same bits
    const float log_f = -softplus(-f_pre);
    const float lfm = __fadd_rn(log_f, m_reg);
    const float m_new = fmaxf(lfm, i_pre);
    const float i_g = expf(__fsub_rn(i_pre, m_new));
    const float f_g = expf(__fsub_rn(lfm, m_new));
    m_reg = m_new;
    float dn = 0.f, acc[RW];
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      n_reg[c] = __fadd_rn(__fmul_rn(f_g, n_reg[c]), __fmul_rn(i_g, k_c[c]));
      dn = __fadd_rn(dn, __fmul_rn(n_reg[c], q_c[c]));
    }
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      acc[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        c_reg[r][c] = __fadd_rn(__fmul_rn(f_g, c_reg[r][c]),
                                __fmul_rn(i_g, __fmul_rn(v_c[r], k_c[c])));
        acc[r] = __fadd_rn(acc[r], __fmul_rn(c_reg[r][c], q_c[c]));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      dn = __fadd_rn(dn, __shfl_xor_sync(FULL, dn, off));
#pragma unroll
      for (int r = 0; r < RW; ++r)
        acc[r] = __fadd_rn(acc[r], __shfl_xor_sync(FULL, acc[r], off));
    }
    const float den = fmaxf(fabsf(dn), 1.f);
    float* ht = h + (((size_t)b * S + t) * H + head) * HD + row0;
#pragma unroll
    for (int r = 0; r < RW; ++r)
      if (lane == r) ht[r] = __fdiv_rn(acc[r], den);
  }

#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
#pragma unroll
    for (int r = 0; r < RW; ++r)
      if (on) C[((size_t)bh * HD + row0 + r) * HD + j] = c_reg[r][c];
  }
  // the last block of this (b, head) writes n and m: the others have read
  // them (at their start, before they arrive)
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(arrivals + bh, 1) == TILES - 1;
    if (last) arrivals[bh] = 0;  // zero for the next launch
  }
  __syncthreads();
  if (last && warp == 0) {
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (on) n[(size_t)bh * HD + lane + 32 * c] = n_reg[c];
    if (lane == 0) m[bh] = m_reg;
  }
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* ig,
           const float* fg, float* C, float* n, float* m, float* h,
           int* arrivals, int B, int S, int H, cudaStream_t stream) {
  const long long blocks = (long long)B * H * (HD / ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  mlstm_scan_kernel<HD><<<(unsigned)blocks, WARPS * 32, 0, stream>>>(
      q, k, v, ig, fg, C, n, m, h, arrivals, S, H);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
// q, k, v, h (B, S, H, hd), i_pre, f_pre (B, S, H), C (B, H, hd, hd),
// n (B, H, hd), m (B, H): contiguous float32; hd one of 16, 32, 64, 128,
// 256, 512. arrivals: int32, B x H entries, zero before the first launch
// (each launch leaves it zero).
extern "C" int mlstm_scan_launch(const void* q, const void* k, const void* v,
                                 const void* i_pre, const void* f_pre,
                                 void* C, void* n, void* m, void* h,
                                 void* arrivals, int B, int S, int H, int hd,
                                 void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  const auto st = (cudaStream_t)stream;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  const auto* i = static_cast<const float*>(i_pre);
  const auto* f = static_cast<const float*>(f_pre);
  auto* Cf = static_cast<float*>(C);
  auto* nf = static_cast<float*>(n);
  auto* mf = static_cast<float*>(m);
  auto* hf = static_cast<float*>(h);
  auto* ar = static_cast<int*>(arrivals);
  switch (hd) {
    case 16:
      return launch<16>(qf, kf, vf, i, f, Cf, nf, mf, hf, ar, B, S, H, st);
    case 32:
      return launch<32>(qf, kf, vf, i, f, Cf, nf, mf, hf, ar, B, S, H, st);
    case 64:
      return launch<64>(qf, kf, vf, i, f, Cf, nf, mf, hf, ar, B, S, H, st);
    case 128:
      return launch<128>(qf, kf, vf, i, f, Cf, nf, mf, hf, ar, B, S, H, st);
    case 256:
      return launch<256>(qf, kf, vf, i, f, Cf, nf, mf, hf, ar, B, S, H, st);
    case 512:
      return launch<512>(qf, kf, vf, i, f, Cf, nf, mf, hf, ar, B, S, H, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
