// Float32 products on Hopper's tensor cores at float32-level accuracy:
// split TF32 (3xTF32) with mma.sync m16n8k8, for the flash kernels'
// float32 routes (flash_attention.cu's forward, flash_attention_bwd.cu's
// gradient).
//
// A float32 x is split into hi = tf32(x), rounded to nearest with ties away
// from zero (what cvt.rna.tf32.f32 does; here by integer operations on the
// bits: add half a TF32 ulp, 0x1000, and clear the 13 low mantissa bits),
// and lo = x - hi, exact in float32, which the tensor core reads as TF32 by
// ignoring its 13 low bits (CUTLASS's round_half_ulp_truncate relies on the
// same). A product a b is then lo_a hi_b + hi_a lo_b + hi_a hi_b, three
// mma.sync into one float32 accumulator (small terms first); lo_a lo_b is
// dropped. |lo| <= 2^-11 |x| and its truncation loses at most 2^-10 of it,
// so a product is good to about 2^-20.5 of |a b| against float32's 2^-24
// (the CPU tests emulate exactly this split). Each product of two TF32
// values is exact in the tensor core. 495 TFLOP/s of dense TF32 on an H100
// SXM make 165 TFLOP/s of such products, against 67 TFLOP/s on the float32
// pipe; a split costs three integer and float operations a value.
//
// Fragments of m16n8k8 (PTX ISA, "Matrix Fragments for mma.m16n8k8",
// .tf32). With g = lane / 4 and t = lane % 4:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k t, n g), b1 (k t + 4, n g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A product sums over k in any order, so k may be relabelled as long as A
// and B agree. The accumulator of one n8 tile becomes the A fragment of a
// k8 step with no shuffle when A's k = t stands for column 2t and k = t + 4
// for column 2t + 1 (a_of_acc); B is then read with the same relabelling
// (load_b_kn). Shared-memory tiles are float rows of ld floats with ld % 8
// == 4: then every fragment load below hits 32 distinct banks (the paired
// loads want ld % 32 in {8, 24} instead).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32x3 {

constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// x as hi + lo, the operands' bit patterns
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const uint32_t h = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  hi = h;
  lo = __float_as_uint(x - __uint_as_float(h));
}

struct FragA {  // an m16 x k8 A fragment, split
  uint32_t hi[4], lo[4];
};
struct FragB {  // a k8 x n8 B fragment, split
  uint32_t hi[2], lo[2];
};

// D += A B for one m16n8k8 tile, TF32 operands, float32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, "
      "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D += A B in 3xTF32
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi[0], b.hi[1]);
  mma(d, a.hi, b.lo[0], b.lo[1]);
  mma(d, a.hi, b.hi[0], b.hi[1]);
}

__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }

// A = X[r0.., k0..] of a tile stored split (hi and lo planes of ld words;
// hi = &X_hi[r0][k0], lo = &X_lo[r0][k0])
__device__ __forceinline__ FragA load_a_split(const uint32_t* hi,
                                              const uint32_t* lo, int ld) {
  const int g = lane_g(), t = lane_t();
  const int o[4] = {g * ld + t, (g + 8) * ld + t, g * ld + t + 4,
                    (g + 8) * ld + t + 4};
  FragA a;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    a.hi[e] = hi[o[e]];
    a.lo[e] = lo[o[e]];
  }
  return a;
}

// B(k, n) = X[n][k] times mul, X a float tile with n rows (p = &X[n0][k0]):
// the k-contiguous operand of a product with a transposed right side
// (q k^T, k q^T)
__device__ __forceinline__ FragB load_b_nk(const float* p, int ld,
                                           float mul) {
  const int g = lane_g(), t = lane_t();
  FragB b;
  split(p[g * ld + t] * mul, b.hi[0], b.lo[0]);
  split(p[g * ld + t + 4] * mul, b.hi[1], b.lo[1]);
  return b;
}

// The same two operands with the k8 step's dims relabelled as a_of_acc
// relabels columns (k = t is dim 2t, k = t + 4 dim 2t + 1), so each lane's
// two values of a row are one 8-byte load; the product is the same. Both
// operands of a product must use it. Free of bank conflicts for ld % 32 in
// {8, 24}.
__device__ __forceinline__ FragA load_a_split2(const uint32_t* hi,
                                               const uint32_t* lo, int ld) {
  const int g = lane_g(), t = lane_t();
  const uint2 h0 = *reinterpret_cast<const uint2*>(hi + g * ld + 2 * t);
  const uint2 h1 = *reinterpret_cast<const uint2*>(hi + (g + 8) * ld + 2 * t);
  const uint2 l0 = *reinterpret_cast<const uint2*>(lo + g * ld + 2 * t);
  const uint2 l1 = *reinterpret_cast<const uint2*>(lo + (g + 8) * ld + 2 * t);
  return FragA{{h0.x, h1.x, h0.y, h1.y}, {l0.x, l1.x, l0.y, l1.y}};
}
__device__ __forceinline__ FragB load_b_nk2(const float* p, int ld) {
  const int g = lane_g(), t = lane_t();
  const float2 x = *reinterpret_cast<const float2*>(p + g * ld + 2 * t);
  FragB b;
  split(x.x, b.hi[0], b.lo[0]);
  split(x.y, b.hi[1], b.lo[1]);
  return b;
}

// B(k, n) = X[k][n] times mul, X a float tile with k rows (p = &X[k0][n0]),
// with k relabelled as a_of_acc relabels it: b0 from row 2t, b1 from 2t + 1
__device__ __forceinline__ FragB load_b_kn(const float* p, int ld,
                                           float mul) {
  const int g = lane_g(), t = lane_t();
  FragB b;
  split(p[2 * t * ld + g] * mul, b.hi[0], b.lo[0]);
  split(p[(2 * t + 1) * ld + g] * mul, b.hi[1], b.lo[1]);
  return b;
}

// the accumulator of an m16n8 tile as the A fragment of a k8 step over its
// 8 columns (k = t is column 2t, k = t + 4 column 2t + 1), split
__device__ __forceinline__ FragA a_of_acc(const float (&c)[4]) {
  FragA a;
  split(c[0], a.hi[0], a.lo[0]);
  split(c[2], a.hi[1], a.lo[1]);
  split(c[1], a.hi[2], a.lo[2]);
  split(c[3], a.hi[3], a.lo[3]);
  return a;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// 16 or 4 bytes global -> shared; zeros where !valid (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows row0 .. row0 + ROWS - 1 of a (L, hd) float slice (row stride
// `stride` elements) into a [ROWS][ld] tile by cp.async, zeros past L and
// in columns hd .. hdp - 1. vec: 16-byte copies (the slice's base and
// stride are 16-byte multiples and hd % 4 == 0), else 4-byte ones.
template <int ROWS, int NT>
__device__ __forceinline__ void load_rows(float* dst, int ld,
                                          const float* src,
                                          long long stride, int row0, int L,
                                          int hd, int hdp, bool vec) {
  if (vec) {
    const int cpr = hdp / 4;
    for (int c = threadIdx.x; c < ROWS * cpr; c += NT) {
      const int r = c / cpr, ch = c - r * cpr, row = row0 + r;
      const bool ok = row < L && ch * 4 < hd;
      cp_async16(dst + r * ld + ch * 4,
                 ok ? src + row * stride + ch * 4 : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < ROWS * hdp; e += NT) {
      const int r = e / hdp, d = e - r * hdp, row = row0 + r;
      const bool ok = row < L && d < hd;
      cp_async4(dst + r * ld + d, ok ? src + row * stride + d : src, ok);
    }
  }
}

// n floats of a row vector from index i0 (zeros from L on) by cp.async
template <int N, int NT>
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int i0, int L) {
  for (int r = threadIdx.x; r < N; r += NT) {
    const bool ok = i0 + r < L;
    cp_async4(dst + r, ok ? src + i0 + r : src, ok);
  }
}

// rows row0 .. row0 + rows - 1 of a (L, hd) float slice, times mul, split
// into [rows][ld] hi and lo planes; zeros past L and in columns hd .. hdp-1
template <int NT>
__device__ __forceinline__ void stage_split(uint32_t* hi, uint32_t* lo,
                                            int ld, const float* src,
                                            long long stride, int row0,
                                            int rows, int L, int hd,
                                            int hdp, float mul) {
  for (int e = threadIdx.x; e < rows * hdp; e += NT) {
    const int r = e / hdp, d = e - r * hdp, row = row0 + r;
    const float x = (row < L && d < hd) ? src[row * stride + d] * mul : 0.0f;
    split(x, hi[r * ld + d], lo[r * ld + d]);
  }
}

// max and sum over the 4 lanes of a quad (the lanes that share C rows)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

__device__ __forceinline__ bool visible(int pos, int j, int Tk, int causal,
                                        int window) {
  bool vis = j < Tk;
  if (causal) vis = vis && pos >= j;
  if (window > 0) vis = vis && (pos - j) < window;
  return vis;
}

// element strides of a (batch, head, seq, dim) view; dim is contiguous
struct Strides {
  long long b, h, s;
};

// whether a view's rows can be copied 16 bytes at a time
inline bool rows_vec(const void* base, const Strides& st, int hd) {
  return reinterpret_cast<uintptr_t>(base) % 16 == 0 && hd % 4 == 0 &&
         st.b % 4 == 0 && st.h % 4 == 0 && st.s % 4 == 0;
}

// a block's shared memory on an H100
constexpr size_t MAX_SMEM = 232448;

}  // namespace tf32x3
