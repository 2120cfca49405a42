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
// The exact-one gate. m' is one of log_f + m and i, so one of i - m' and
// (log_f + m) - m' is exactly 0 and its gate exactly 1: with
// d = (log_f + m) - i, the other gate is exp(-|d|) (i - (log_f + m) = -d
// exactly), i_g = 1 where d <= 0 and f_g = 1 where d >= 0. One exp a step,
// and the gates bit for bit the two exps'.
//
// Design. Row i of C depends only on v_i, on the whole of k and q and on
// the per-(b, head) scalars m, i_g, f_g. So a C warp owns RW = 4 rows of C
// of one (b, head) for the whole sequence and keeps them in registers: lane
// l holds columns l, l + 32, ... (HD / 32 of them, at least 1). A block is
// WARPS = 4 C warps (ROWS = 16 rows) and a producer warp; the grid is
// B x H x HD / ROWS blocks (128 at B = 1, H = 4, HD = 512: one an SM; two
// blocks fit an SM, so a 4-slot decode step's 512 run in two waves).
// - The producer: the q and k rows and the block's ROWS entries of v of
//   CHUNK = 8 steps a stage come into a two-stage shared-memory ring by bulk
//   copies (TMA, cp.async.bulk) that complete the stage's "full" mbarrier;
//   the C warps release a stage on its "empty" mbarrier. While the copies
//   fly the producer takes the gates, 32 steps at once, lane s step t0 + s
//   (its softplus and its one exp); only the m chain (an add and a max a
//   step) runs step by step, on values broadcast by shuffles. It writes
//   each step's (i_g, f_g) into the stage before it arrives on "full".
// - A C warp's step: C' = f_g C + i_g (v k^T), 6 rounded operations an
//   element with C' q, reading the step's q and k columns and v rows from
//   the stage where it uses them. Every C warp keeps all of n (the same
//   columns as its C) and updates it beside C, with n' . q: at HD 512, 80 of
//   a lane's 464 operations a step, but no C warp waits for another.
// - The sums C' q and n' . q, CHUNK steps at once: a step leaves each
//   lane's partial sums of its columns (in column order) in shared memory;
//   after the chunk lane j adds the 32 partials of row j % RW at step j / RW
//   in the tree of `kernel_order_dot` (pairs at distances 16, 8, 4, 2, 1),
//   lanes 4u..4u+3 the 8-leaf subtrees of n' . q at step u, joined by two
//   shuffles; lane j divides and writes h.
// At the end each C warp writes its rows of C back, and the last block of a
// (b, head) to finish (an arrival counter a (b, head), returned to zero)
// writes n and m: every other block has read them by then.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W): operations. The state
// must round as the plain loop's, so C's update is 3 unfused operations an
// element (v_i k_j, the gate that is not exactly 1 times it or C, the sum:
// a product with 1.0f is exact); h is held only within 1e-5 of max|h|, so
// C' q needs 1 FMA an element. At (B, S, H, HD) = (1, 4096, 4, 512) that
// is 4 instructions an element of C a step, 17.2 G with n's, on the FP32
// lanes at one a lane and clock (128 x 132 at 1.98 GHz: 33.4 T/s),
// 0.51 ms; q, k, v and h are 134 MB, C read and written 8.4 MB, 0.043 ms at
// 3.35 TB/s. The kernel issues the formula's 6 an element: skipping the
// product with the gate that is exactly 1 needs a second copy of the step
// behind a branch, and measured under 1% faster.
// What the step waits on (tools/bench_xlstm_scan.py): with one C warp a
// scheduler the update issues at ~0.6 of an instruction a clock, and the
// producer's work on one scheduler and the chunk's sums add ~15% to it.
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>

namespace {

constexpr int WARPS = 4;          // C warps a block, and a producer
constexpr int RW = 4;             // rows of C a C warp
constexpr int ROWS = WARPS * RW;  // rows of C a block
constexpr int CHUNK = 8;          // steps a stage of the ring, a batch of sums
constexpr int STAGES = 2;         // stages of the ring
constexpr int GSTEPS = 32;        // steps whose gates the producer takes at once
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;  // devices whose launch limit is kept
// a chunk's row sums are one a lane
static_assert(CHUNK * RW == 32 && GSTEPS % CHUNK == 0, "sums");

__device__ __forceinline__ float softplus(float x) {
  // logaddexp(x, 0) = max(x, 0) + log1p(exp(-|x|)), as torch's logaddexp
  return __fadd_rn(fmaxf(x, 0.f), log1pf(expf(-fabsf(x))));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// waits until the barrier's phase differs from `parity`
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
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

// entry `l` of row `row` (32 entries) of a partial-sum buffer, its 16-byte
// groups rotated by the row so that lanes reading a row each, 16 bytes at a
// time, and lanes writing one row, 4 bytes each, meet no bank twice
__device__ __forceinline__ int swz(int row, int l) {
  return row * 32 + ((((l >> 2) ^ row) & 7) << 2) + (l & 3);
}

// a[i] += a[i + W] for i < W, then at W / 2, ..., 1: the tree of
// `kernel_order_dot` (every index a constant: a stays in registers)
template <int W, int N>
__device__ __forceinline__ void tree(float (&a)[N]) {
#pragma unroll
  for (int i = 0; i < W; ++i) a[i] = __fadd_rn(a[i], a[i + W]);
  if constexpr (W > 1) tree<W / 2>(a);
}

// shared memory of a launch, in floats: barriers (2 x STAGES), each C
// warp's partial sums of a chunk (C' q: CHUNK x RW rows of 32 lanes; n' . q:
// CHUNK rows of 32 lanes), the ring; a stage holds st = min(S, CHUNK) steps
// of q rows, k rows, the block's ROWS entries of v and the gates (i_g, f_g)
template <int HD>
struct Layout {
  static constexpr int CPL = HD >= 32 ? HD / 32 : 1;  // columns a lane
  static constexpr int PART = 16;  // after the barriers
  static constexpr int WARP_FLOATS = CHUNK * RW * 32 + CHUNK * 32;
  static constexpr int RING = PART + WARPS * WARP_FLOATS;
  static_assert(2 * STAGES * 8 <= PART * 4, "barriers");
  __host__ __device__ static int steps(int S) { return S < CHUNK ? S : CHUNK; }
  __host__ __device__ static int stage_floats(int S) {
    return steps(S) * (2 * HD + ROWS) + 2 * CHUNK;
  }
  static size_t bytes(int S) {
    const int chunks = (S + CHUNK - 1) / CHUNK;
    const int stages = chunks < STAGES ? chunks : STAGES;
    return sizeof(float) * (RING + (size_t)stages * stage_floats(S));
  }
};

// One C warp's scan: rows row0 .. row0 + RW - 1 of C of one (b, head) and
// the whole of n in registers; writes h of its rows and, at the end, its
// rows of C
template <int HD>
__device__ __forceinline__ void c_warp(float* __restrict__ C,
                                       const float* __restrict__ n,
                                       float* __restrict__ h,
                                       float (&n_reg)[HD >= 32 ? HD / 32 : 1],
                                       float* smem, int warp, int bh, int b,
                                       int head, int row0, int S, int H) {
  using L = Layout<HD>;
  constexpr int CPL = L::CPL;
  const int lane = threadIdx.x % 32;
  const bool on = HD >= 32 || lane < HD;
  const uint32_t bars = smem_addr(smem);
  const int st = L::steps(S), sf = L::stage_floats(S);
  const int chunks = (S + CHUNK - 1) / CHUNK;
  float* part = smem + L::PART + warp * L::WARP_FLOATS;
  float* pdn = part + CHUNK * RW * 32;
  const float* ring = smem + L::RING;
  float c_reg[RW][CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
    n_reg[c] = on ? n[(size_t)bh * HD + j] : 0.f;
#pragma unroll
    for (int r = 0; r < RW; ++r)
      c_reg[r][c] = on ? C[((size_t)bh * HD + row0 + r) * HD + j] : 0.f;
  }
  for (int cc = 0; cc < chunks; ++cc) {
    const int stage = cc % STAGES;
    const int t0 = cc * CHUNK;
    const int steps = S - t0 < CHUNK ? S - t0 : CHUNK;
    mbar_wait(bars + 8 * stage, (uint32_t)((cc / STAGES) & 1));
    const float* qs = ring + stage * sf;
    const float* ks = qs + st * HD;
    const float* vs = ks + st * HD;
    const float2* gs = reinterpret_cast<const float2*>(vs + st * ROWS);
#pragma unroll 1
    for (int u = 0; u < steps; ++u) {
      const float2 g2 = gs[u];
      const float i_g = g2.x, f_g = g2.y;
      const float* qt = qs + u * HD + lane;
      const float* kt = ks + u * HD + lane;
      const float* vt = vs + u * ROWS + warp * RW;
      float dn = 0.f, acc[RW];
#pragma unroll
      for (int r = 0; r < RW; ++r) acc[r] = 0.f;
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const float kc = on ? kt[32 * c] : 0.f;
        const float qc = on ? qt[32 * c] : 0.f;
        n_reg[c] = __fadd_rn(__fmul_rn(f_g, n_reg[c]), __fmul_rn(i_g, kc));
        dn = __fadd_rn(dn, __fmul_rn(n_reg[c], qc));
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          c_reg[r][c] = __fadd_rn(__fmul_rn(f_g, c_reg[r][c]),
                                  __fmul_rn(i_g, __fmul_rn(vt[r], kc)));
          acc[r] = __fadd_rn(acc[r], __fmul_rn(c_reg[r][c], qc));
        }
      }
#pragma unroll
      for (int r = 0; r < RW; ++r) part[swz(u * RW + r, lane)] = acc[r];
      pdn[swz(u, lane)] = dn;
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (STAGES + stage));
    // n' . q at step u = lane / RW: lane RW u + q adds the leaves q,
    // q + RW, ..., q + 32 - RW (the tree's levels at distances 16 down to
    // RW), two shuffles the rest; C' q of row lane % RW at step u: the 32
    // partials, then the tree
    const int u = lane / RW;
    float s = 0.f, a[32];
    if (u < steps) {
      float d[CHUNK];
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) d[i] = pdn[swz(u, lane % RW + RW * i)];
      tree<CHUNK / 2>(d);
      s = d[0];
      const float* p = part + lane * 32;
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const float4 x =
            *reinterpret_cast<const float4*>(p + (((g ^ lane) & 7) << 2));
        a[4 * g] = x.x;
        a[4 * g + 1] = x.y;
        a[4 * g + 2] = x.z;
        a[4 * g + 3] = x.w;
      }
      tree<16>(a);
    }
#pragma unroll
    for (int w = RW / 2; w > 0; w /= 2)
      s = __fadd_rn(s, __shfl_xor_sync(FULL, s, w));
    if (u < steps)
      h[(((size_t)b * S + t0 + u) * H + head) * HD + row0 + lane % RW] =
          __fdiv_rn(a[0], fmaxf(fabsf(s), 1.f));
    __syncwarp();  // the partials are read before the next chunk's
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    const int j = lane + 32 * c;
#pragma unroll
    for (int r = 0; r < RW; ++r)
      if (on) C[((size_t)bh * HD + row0 + r) * HD + j] = c_reg[r][c];
  }
}

template <int HD>
__global__ void __launch_bounds__((WARPS + 1) * 32, 2)
mlstm_scan_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ ig,
                  const float* __restrict__ fg, float* __restrict__ C,
                  float* __restrict__ n, float* __restrict__ m,
                  float* __restrict__ h, int* __restrict__ arrivals, int S,
                  int H) {
  using L = Layout<HD>;
  constexpr int CPL = L::CPL;
  constexpr int TILES = HD / ROWS;  // blocks a (b, head)
  static_assert(HD % ROWS == 0 && (HD < 32 || HD % 32 == 0), "head width");
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int bh = blockIdx.x / TILES;  // b * H + head
  const int b = bh / H, head = bh % H;
  const int blk_row0 = (blockIdx.x % TILES) * ROWS;
  // full[s] at bars + 8 s: the producer's arrival and the copies' bytes;
  // empty[s] at bars + 8 (STAGES + s): one arrival a C warp
  const uint32_t bars = smem_addr(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (STAGES + s), WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float m_reg = 0.f;  // the producer's stabiliser
  float n_reg[CPL];    // a C warp's n
  if (warp == WARPS) {
    // the producer: each chunk's copies, then its gates (lane s of a gate
    // batch takes step t0 + s; only the m chain runs step by step)
    const int st = L::steps(S), sf = L::stage_floats(S);
    const int chunks = (S + CHUNK - 1) / CHUNK;
    float* ring = smem + L::RING;
    m_reg = m[bh];
    float xi = 0.f, xf = 0.f;  // lane s's pre-activations, next batch
    if (lane < S) {
      const size_t g = ((size_t)b * S + lane) * H + head;
      xi = __ldg(ig + g);
      xf = __ldg(fg + g);
    }
    float ig_l = 1.f, fg_l = 1.f;
    for (int cc = 0; cc < chunks; ++cc) {
      const int stage = cc % STAGES;
      const int t0 = cc * CHUNK;
      const int steps = S - t0 < CHUNK ? S - t0 : CHUNK;
      const uint32_t full = bars + 8 * stage;
      if (cc >= STAGES)
        mbar_wait(bars + 8 * (STAGES + stage),
                  (uint32_t)((cc / STAGES - 1) & 1));
      float* dst = ring + stage * sf;
      if (lane == 0)
        mbar_expect_tx(full, (uint32_t)(steps * (2 * HD + ROWS) * 4));
      __syncwarp();
      if (lane < steps) {
        const size_t g = ((size_t)b * S + t0 + lane) * H + head;
        bulk_load(smem_addr(dst + lane * HD), q + g * HD, HD * 4, full);
        bulk_load(smem_addr(dst + (st + lane) * HD), k + g * HD, HD * 4,
                  full);
        bulk_load(smem_addr(dst + 2 * st * HD + lane * ROWS),
                  v + g * HD + blk_row0, ROWS * 4, full);
      }
      if ((t0 & (GSTEPS - 1)) == 0) {
        const float log_f = -softplus(-xf);
        const int valid = S - t0 < GSTEPS ? S - t0 : GSTEPS;
        float my_lfm = 0.f;
#pragma unroll
        for (int s = 0; s < GSTEPS; ++s) {
          if (s >= valid) break;
          const float lf = __shfl_sync(FULL, log_f, s);
          const float is = __shfl_sync(FULL, xi, s);
          const float lfm = __fadd_rn(lf, m_reg);
          m_reg = fmaxf(lfm, is);
          if (lane == s) my_lfm = lfm;
        }
        // the exact-one form: one gate 1, the other exp(-|d|)
        const float d = __fsub_rn(my_lfm, xi);
        const float e = expf(-fabsf(d));
        ig_l = d > 0.f ? e : 1.f;
        fg_l = d > 0.f ? 1.f : e;
        const int tn = t0 + GSTEPS + lane;
        if (tn < S) {
          const size_t g = ((size_t)b * S + tn) * H + head;
          xi = __ldg(ig + g);
          xf = __ldg(fg + g);
        }
      }
      const float i_u = __shfl_sync(FULL, ig_l, (t0 + lane) & (GSTEPS - 1));
      const float f_u = __shfl_sync(FULL, fg_l, (t0 + lane) & (GSTEPS - 1));
      if (lane < steps)
        reinterpret_cast<float2*>(dst + 2 * st * HD + st * ROWS)[lane] =
            make_float2(i_u, f_u);
      __syncwarp();
      if (lane == 0) mbar_arrive(full);  // releases the gates' stores
    }
  } else {
    c_warp<HD>(C, n, h, n_reg, smem, warp, bh, b, head,
               blk_row0 + warp * RW, S, H);
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
    const bool on = HD >= 32 || lane < HD;
#pragma unroll
    for (int c = 0; c < CPL; ++c)
      if (on) n[(size_t)bh * HD + lane + 32 * c] = n_reg[c];
  }
  if (last && warp == WARPS && lane == 0) m[bh] = m_reg;
}

template <int HD>
int launch(const float* q, const float* k, const float* v, const float* ig,
           const float* fg, float* C, float* n, float* m, float* h,
           int* arrivals, int B, int S, int H, cudaStream_t stream) {
  const long long blocks = (long long)B * H * (HD / ROWS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  // the largest layout (two full stages) is allowed once a device, so a
  // decode step's launch makes no extra driver call and never lowers the
  // limit below what a prefill's launch needs
  static std::atomic<bool> allowed[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= MAX_DEVICES || !allowed[dev].load()) {
    err = cudaFuncSetAttribute(
        mlstm_scan_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)Layout<HD>::bytes(STAGES * CHUNK));
    if (err != cudaSuccess) return (int)err;
    if (dev < MAX_DEVICES) allowed[dev].store(true);
  }
  const size_t smem = Layout<HD>::bytes(S);
  mlstm_scan_kernel<HD><<<(unsigned)blocks, (WARPS + 1) * 32, smem,
                          stream>>>(q, k, v, ig, fg, C, n, m, h, arrivals, S,
                                    H);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` (PyTorch's current stream) and returns
// cudaGetLastError() (or cudaFuncSetAttribute's error) so the Python wrapper
// can raise on a refused launch. q, k, v, h (B, S, H, hd), i_pre, f_pre
// (B, S, H), C (B, H, hd, hd), n (B, H, hd), m (B, H): contiguous float32,
// q, k and v 16-byte aligned (they are copied by TMA); hd one of 16, 32, 64,
// 128, 256, 512. arrivals: int32, B x H entries, zero before the first
// launch (each launch leaves it zero).
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
