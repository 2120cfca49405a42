// bf16 flash-attention forward for Hopper's tensor cores (sm_90a): TMA
// loads, mbarrier pipeline, warp-specialized warpgroups, wgmma.
//
// Included by flash_attention.cu, whose C entry routes every bfloat16 call
// here (float32 calls take the split-TF32 kernel there). It computes what
// the Pallas `_flash_kernel` (src/repro/kernels/flash_attention.py:25)
// computes, with masks at the true key length T, `causal`, `window` and
// `q_offset`, the finite NEG_INF = -1e30 and acc / max(l, 1e-30) cast to
// bf16 with round-to-nearest-even.
//
// Design (one block per (batch x head, 128 query rows); 384 threads):
//   * warpgroup 0 is the producer: setmaxnreg drops it to 40 registers and
//     one thread issues the TMA loads. Q (128 rows) is loaded once; K and V
//     tiles of BK keys (128 for a padded head dim of 64 or 128, 64 for 256,
//     so shared memory stays under 227 KB) go through a ring of STAGES
//     stages, with a full barrier per stage for K and one for V (TMA
//     completes their transaction counts) and an empty barrier that the 8
//     consumer warps arrive on when the stage is read.
//   * warpgroups 1 and 2 are the consumers, 64 query rows each, raised to
//     232 registers. Per tile: S = Q K^T by wgmma m64nBKk16 from shared
//     memory (both operands K-major, f32 accumulators); the mask and the
//     online softmax in registers (row max and sum are quad shuffles; only
//     tiles on the causal diagonal, the window's lower edge or past T are
//     masked); then O += P V by wgmma with P from registers and V from
//     shared memory (MN-major: the transpose-B bit).
//   * every tile is stored with TMA's 128-byte swizzle, which the wgmma
//     descriptors name: a row of 64 bf16 is 128 bytes, 8 rows make a 1024-
//     byte swizzle atom, and a head dim of 128 or 256 is 2 or 4 such column
//     blocks, one box each. The head dim is zero-padded to 64, 128 or 256
//     by TMA's out-of-bounds fill, and so are rows past S or T.
//
// The log-sum-exp. Given a non-null `lse`, the epilogue also stores each
// row's m + log2(max(l, 1e-30)) (base 2, in the units of the scores times
// scale * log2 e that the softmax works in) for the gradient kernel of
// flash_attention_bwd_wgmma.cuh, in rows of lse_rows(S) floats per (batch,
// head), 0 in the rows from S on. Only the store is added, in a kernel
// instantiation of its own (LSE = true): O's arithmetic is the same with
// and without it, and the kernel without the store is the one it was.
//
// Numerics. The score is accumulated in f32 from exact bf16 products and
// multiplied by scale * log2(e) after the product (the Pallas kernel
// scales q first; q * scale rounded to bf16 would lose bits, so the two
// differ by a few f32 ULP); the softmax runs in base 2. P stays f32 in the
// Pallas kernel's P.V, and P rounded once to bf16 puts thousands of
// outputs more than two bf16 steps off (tests/test_torch_kernels.py pins
// this), so P is split into two bf16 terms, p_hi = bf16(p) and p_lo =
// bf16(p - p_hi), with two wgmmas into one f32 O: P carries 16 bits, at
// 1.5x the tensor work of one P.V. The denominator l sums the unrounded p.
// The accumulator layout of wgmma m64nN (thread t of a warp holds rows
// t/4 and t/4 + 8, columns 8i + 2(t%4) + {0, 1}) is the layout of its
// register A operand for k16, so P goes from accumulators to A fragments
// without any shuffle.
//
// Bound on an H100 SXM (data-sheet peaks, 700 W), at the qwen3-4b prefill
// S = T = 4096, H = 32, hd = 128, causal: 137 GFLOP counted at 4 FLOP per
// visible pair and head dim (0.139 ms at 989 TFLOP/s bf16) against 134 MB
// of q, k, v and o (0.040 ms at 3.35 TB/s): the operations bound it. The
// split P makes the tensor work 1.5x that count.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma_fa {

constexpr int BQ = 128;              // query rows per block
constexpr int STAGES = 2;            // K/V ring depth
constexpr int THREADS = 384;         // producer warpgroup + 2 consumers
constexpr int CONSUMER_WARPS = 8;
constexpr float NEG_INF = -1.0e30f;
constexpr unsigned FULL = 0xffffffffu;
// returned by the launch when cuTensorMapEncodeTiled refuses a tensor map
// (ENCODE_ERROR + its CUresult) or cannot be found (ENCODE_ERROR - 1)
constexpr int ENCODE_ERROR = 20000;

// the log-sum-exp rows of one (batch, head): S rounded up to the block's
// rows, so the gradient kernel reads whole 64- or 128-row tiles of them
__host__ __device__ __forceinline__ int lse_rows(int S) {
  return (S + BQ - 1) / BQ * BQ;
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
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
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

// one box (64 columns, rows, 1 head, 1 batch) of a 4-D tensor map into
// shared memory; completes `bytes` of the barrier's transaction count
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (16-byte units), layout type 1 in bits 62-63
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accesses of wgmma accumulators across the
// asynchronous wgmma and its wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// two f32 accumulator values as the hi and lo bf16 pairs of an A fragment:
// hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// D (64 x 64, f32) = or += A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 128, f32) = or += A (smem, K-major) . B (smem, K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 64, f32) += A (registers, bf16 fragments) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D (64 x 128, f32) += A (registers, bf16 fragments) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// D (64 x 256, f32) += A (registers, bf16 fragments) . B (smem, MN-major)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query, so the library needs no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess && p != nullptr)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The (hd, L, H, B) tensor map of a (B, H, L, hd) bf16 view with element
// strides (sb, sh, ss), boxes of 64 columns x `rows` rows, 128-byte
// swizzle, zero fill out of bounds. The wrapper has checked that the base
// and every stride of a dim longer than 1 are 16-byte multiples; a dim of
// length 1 gets a legal stride, which no box uses.
inline int make_map(CUtensorMap* map, const void* ptr, int B, int H, int L,
                    int hd, long long sb, long long sh, long long ss,
                    int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ENCODE_ERROR - 1;
  L = L > 0 ? L : 1;
  const cuuint64_t row_bytes = (static_cast<cuuint64_t>(hd) * 2 + 15) & ~15ull;
  const cuuint64_t st_l = L > 1 ? ss * 2 : row_bytes;
  const cuuint64_t st_h = H > 1 ? sh * 2 : st_l * L;
  const cuuint64_t st_b = B > 1 ? sb * 2 : st_h * H + st_l * L;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {st_l, st_h, st_b};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : ENCODE_ERROR + static_cast<int>(res);
}

// the gradient's library (flash_attention_bwd_wgmma.cuh) includes this
// header for the helpers above only
#ifndef WGMMA_FA_HELPERS_ONLY

// HD: the head dim padded to 64, 128 or 256; BK: keys per K/V tile; LSE:
// store the log-sum-exp rows (an instantiation of its own, so the kernel
// without the store compiles to the code it had before the store existed)
template <int HD, int BK, bool LSE>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o, int H, int S, int Tk,
                   int hd, long long osb, long long osh, long long oss,
                   int causal, int window, int q_offset, float scale_log2,
                   int pairs, float* __restrict__ lse) {
  constexpr int NB = HD / 64;             // 128-byte column blocks
  constexpr int Q_BYTES = BQ * HD * 2;
  constexpr int KV_BYTES = BK * HD * 2;   // one K or V tile
  constexpr int S_REGS = BK / 2;          // score accumulators per thread
  constexpr int O_REGS = HD / 2;          // output accumulators per thread
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms repeat every 1024 bytes: align every tile to that
  const uint32_t sq = (smem_addr(smem_raw) + 1023) & ~1023u;
  const uint32_t sk = sq + Q_BYTES;                 // STAGES K tiles
  const uint32_t sv = sk + STAGES * KV_BYTES;       // STAGES V tiles
  const uint32_t bars = sv + STAGES * KV_BYTES;
  const uint32_t q_full = bars;                     // then, per stage:
  const uint32_t full_k = bars + 8;                 //   K arrived
  const uint32_t full_v = full_k + 8 * STAGES;      //   V arrived
  const uint32_t empty = full_v + 8 * STAGES;       //   stage read

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int i0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // longest rows first
  // keys any real row of this block can see
  const int pos_lo = i0 + q_offset;
  const int pos_hi = min(i0 + BQ, S) - 1 + q_offset;
  const int k_end = causal ? min(Tk, pos_hi + 1) : Tk;
  int k_begin = window > 0 ? max(0, pos_lo - window + 1) : 0;
  k_begin -= k_begin % BK;
  const int n_tiles = k_end > k_begin ? (k_end - k_begin + BK - 1) / BK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      for (int c = 0; c < NB; ++c)
        tma_load(sq + c * BQ * 128, &tm_q, q_full, c * 64, i0, h, b);
      for (int n = 0; n < n_tiles; ++n) {
        const int s = n % STAGES;
        const uint32_t phase = (n / STAGES) & 1;
        const int j0 = k_begin + n * BK;
        mbar_wait(empty + 8 * s, phase ^ 1);  // round 0 passes at once
        mbar_expect_tx(full_k + 8 * s, KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(sk + s * KV_BYTES + c * BK * 128, &tm_k, full_k + 8 * s,
                   c * 64, j0, h, b);
        mbar_expect_tx(full_v + 8 * s, KV_BYTES);
        for (int c = 0; c < NB; ++c)
          tma_load(sv + s * KV_BYTES + c * BK * 128, &tm_v, full_v + 8 * s,
                   c * 64, j0, h, b);
      }
    }
  } else {
    // consumers: warpgroup wg - 1 owns query rows 64 (wg - 1) .. + 63
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = i0 + 64 * c + 16 * warp + g;  // rows row0, row0 + 8
    const int wpos_lo = i0 + 64 * c + q_offset, wpos_hi = wpos_lo + 63;
    const uint32_t q_rows = sq + 64 * c * 128;     // in each column block

    float acc[O_REGS];
#pragma unroll
    for (int e = 0; e < O_REGS; ++e) acc[e] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};
    mbar_wait(q_full, 0);

    for (int n = 0; n < n_tiles; ++n) {
      const int s = n % STAGES;
      const uint32_t phase = (n / STAGES) & 1;
      const int j0 = k_begin + n * BK;
      const uint32_t k_tile = sk + s * KV_BYTES, v_tile = sv + s * KV_BYTES;

      // S = Q K^T: 16 head dims per wgmma, 4 per 128-byte row, then the
      // next column block
      float sc[S_REGS];
#pragma unroll
      for (int e = 0; e < S_REGS; ++e) sc[e] = 0.0f;
      mbar_wait(full_k + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        const uint64_t da =
            desc_sw128(q_rows + (kk / 4) * BQ * 128 + col, 16, 1024);
        const uint64_t db =
            desc_sw128(k_tile + (kk / 4) * BK * 128 + col, 16, 1024);
        if constexpr (BK == 128)
          wgmma_ss_n128(sc, da, db, kk > 0);
        else
          wgmma_ss_n64(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // mask (edge tiles only), then the online softmax in base 2
      const bool edge = j0 + BK > Tk || (causal && j0 + BK - 1 > wpos_lo) ||
                        (window > 0 && j0 <= wpos_hi - window);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int e = 0; e < S_REGS; ++e) {
        const int r = (e % 4) / 2;
        float x = sc[e] * scale_log2;
        if (edge) {
          const int j = j0 + 8 * (e / 4) + 2 * t + (e % 2);
          const int pos = row0 + 8 * r + q_offset;
          bool vis = j < Tk;
          if (causal) vis = vis && pos >= j;
          if (window > 0) vis = vis && (pos - j) < window;
          x = vis ? x : NEG_INF;
        }
        sc[e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
        corr[r] = ex2(m[r] - mx[r]);
        m[r] = mx[r];
        l[r] *= corr[r];
      }
#pragma unroll
      for (int e = 0; e < S_REGS; ++e) {
        const int r = (e % 4) / 2;
        const float p = ex2(sc[e] - m[r]);
        l[r] += p;
        sc[e] = p;
      }
#pragma unroll
      for (int e = 0; e < O_REGS; ++e) acc[e] *= corr[(e % 4) / 2];

      // P as two bf16 A fragments per 16 keys: accumulator registers
      // 8kk .. 8kk + 7 are A's a0..a3 of keys 16kk .. 16kk + 15
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
          split2(sc[8 * kk + 2 * a], sc[8 * kk + 2 * a + 1], p_hi[kk][a],
                 p_lo[kk][a]);
      }

      // O += P_hi V + P_lo V: 16 keys per wgmma (16 rows of 128 bytes)
      mbar_wait(full_v + 8 * s, phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t db = desc_sw128(v_tile + kk * 2048, BK * 128, 1024);
        if constexpr (HD == 64) {
          wgmma_rs_n64(acc, p_hi[kk], db, 1);
          wgmma_rs_n64(acc, p_lo[kk], db, 1);
        } else if constexpr (HD == 128) {
          wgmma_rs_n128(acc, p_hi[kk], db, 1);
          wgmma_rs_n128(acc, p_lo[kk], db, 1);
        } else {
          wgmma_rs_n256(acc, p_hi[kk], db, 1);
          wgmma_rs_n256(acc, p_lo[kk], db, 1);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }

    // o = acc / max(l, 1e-30), rounded to bf16
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(FULL, l[r], 1);
      l[r] += __shfl_xor_sync(FULL, l[r], 2);
    }
    if (LSE && t == 0) {
      const int rows = lse_rows(S);
      float* lrow = lse + static_cast<long long>(blockIdx.y) * rows;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < S)
          lrow[row] = m[r] + log2f(fmaxf(l[r], 1e-30f));
        else if (row < rows)
          lrow[row] = 0.0f;
      }
    }
    __nv_bfloat16* op = o + b * osb + h * osh;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= S) continue;
      const float den = fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow = op + row * oss;
#pragma unroll
      for (int i = 0; i < HD / 8; ++i) {
        const int col = 8 * i + 2 * t;
        if (col >= hd) continue;
        const float v0 = acc[4 * i + 2 * r] / den;
        const float v1 = acc[4 * i + 2 * r + 1] / den;
        if (pairs && col + 1 < hd) {
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          orow[col] = __float2bfloat16_rn(v0);
          if (col + 1 < hd) orow[col + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

template <int HD, int BK, bool LSE>
int launch_as(const void* q, const void* k, const void* v, void* o, int B,
           int H, int S, int Tk, int hd, const long long* qst,
           const long long* kst, const long long* vst, const long long* ost,
           int causal, int window, int q_offset, float scale, float* lse,
           cudaStream_t stream) {
  constexpr int smem =
      1024 + BQ * HD * 2 + 2 * STAGES * BK * HD * 2 + 8 * (1 + 3 * STAGES);
  // a runtime call first: it makes the device's primary context current on
  // this thread (autograd's backward thread may not have it yet), which
  // cuTensorMapEncodeTiled needs
  cudaError_t cerr = cudaFuncSetAttribute(
      flash_wgmma_kernel<HD, BK, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (cerr != cudaSuccess) return (int)cerr;
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, H, S, hd, qst[0], qst[1], qst[2], BQ);
  if (err == 0) err = make_map(&tk, k, B, H, Tk, hd, kst[0], kst[1], kst[2], BK);
  if (err == 0) err = make_map(&tv, v, B, H, Tk, hd, vst[0], vst[1], vst[2], BK);
  if (err != 0) return err;
  // bf16x2 stores need every output row and batch/head offset even
  const int pairs = ((ost[0] | ost[1] | ost[2]) & 1) == 0;
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) *
                                              1.4426950408889634);
  const dim3 grid((S + BQ - 1) / BQ, B * H);
  flash_wgmma_kernel<HD, BK, LSE><<<grid, THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), H, S, Tk, hd, ost[0],
      ost[1], ost[2], causal, window, q_offset, scale_log2, pairs, lse);
  return (int)cudaGetLastError();
}

template <int HD, int BK>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int H, int S, int Tk, int hd, const long long* qst,
           const long long* kst, const long long* vst, const long long* ost,
           int causal, int window, int q_offset, float scale, float* lse,
           cudaStream_t stream) {
  return lse != nullptr
             ? launch_as<HD, BK, true>(q, k, v, o, B, H, S, Tk, hd, qst, kst,
                                       vst, ost, causal, window, q_offset,
                                       scale, lse, stream)
             : launch_as<HD, BK, false>(q, k, v, o, B, H, S, Tk, hd, qst,
                                        kst, vst, ost, causal, window,
                                        q_offset, scale, lse, stream);
}

// every bf16 head dim <= 256, zero-padded to 64, 128 or 256; `lse` null or
// B * H * lse_rows(S) floats
inline int dispatch(const void* q, const void* k, const void* v, void* o,
                    int B, int H, int S, int Tk, int hd, const long long* qst,
                    const long long* kst, const long long* vst,
                    const long long* ost, int causal, int window,
                    int q_offset, float scale, float* lse,
                    cudaStream_t stream) {
  if (hd <= 64)
    return launch<64, 128>(q, k, v, o, B, H, S, Tk, hd, qst, kst, vst, ost,
                           causal, window, q_offset, scale, lse, stream);
  if (hd <= 128)
    return launch<128, 128>(q, k, v, o, B, H, S, Tk, hd, qst, kst, vst, ost,
                            causal, window, q_offset, scale, lse, stream);
  if (hd <= 256)
    return launch<256, 64>(q, k, v, o, B, H, S, Tk, hd, qst, kst, vst, ost,
                           causal, window, q_offset, scale, lse, stream);
  return (int)cudaErrorInvalidValue;
}

#endif  // WGMMA_FA_HELPERS_ONLY

}  // namespace wgmma_fa
