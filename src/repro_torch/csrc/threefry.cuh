// Bit-exact threefry2x32 and the normal draw of repro_torch/random.py, in
// device code on native uint32 (the Python module holds the same words in
// int64 tensors with 32-bit masking).
//
//   threefry2x32  random.py threefry2x32: 20 rounds of add / rotate / xor
//                 with a key injection every 4 rounds;
//   tf_fold_in    fold_in(key, data) = threefry2x32(key, (0, data));
//   tf_split      split(key, num)[i] = threefry2x32(key, (0, i));
//   tf_bits       random_bits(key, shape) at the element whose index in the
//                 untiled shape is `counter` (high count word 0);
//   tf_normal     normal(key, shape) at that element: uniform in
//                 [nextafter(-1, 0), 1), then sqrt(2) * erf_inv(u).
//
// Every floating-point step is one rounded operation of the eager PyTorch
// version, written with __f*_rn / __d*_rn intrinsics so that nvcc cannot
// contract two of them into one FMA. erf_inv's Horner steps are not fmaf:
// random.py forms each as a float64 product plus a float64 add, rounded
// once more to float32, and that double rounding can differ from a fused
// multiply-add, so the kernel does the same. log1pf and sqrtf are the CUDA
// math library's, which torch.log1p / torch.sqrt call on float32 CUDA
// tensors. Kernels that include this header must be built without
// --use_fast_math.
#pragma once

#include <cstdint>

struct TfKey {
  uint32_t k1, k2;
};

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// the threefry2x32 hash of the count pair (x1, x2); returns (b1, b2)
__device__ __forceinline__ TfKey threefry2x32(TfKey k, uint32_t x1,
                                              uint32_t x2) {
  const uint32_t ks[3] = {k.k1, k.k2, k.k1 ^ k.k2 ^ 0x1BD11BDAu};
  uint32_t a = x1 + k.k1, b = x2 + k.k2;
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i % 2) ? 17 : 13, r1 = (i % 2) ? 29 : 15;
    const int r2 = (i % 2) ? 16 : 26, r3 = (i % 2) ? 24 : 6;
    a += b; b = tf_rotl(b, r0) ^ a;
    a += b; b = tf_rotl(b, r1) ^ a;
    a += b; b = tf_rotl(b, r2) ^ a;
    a += b; b = tf_rotl(b, r3) ^ a;
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
  return TfKey{a, b};
}

__device__ __forceinline__ TfKey tf_fold_in(TfKey k, uint32_t data) {
  return threefry2x32(k, 0u, data);
}

__device__ __forceinline__ TfKey tf_split(TfKey k, uint32_t i) {
  return threefry2x32(k, 0u, i);
}

__device__ __forceinline__ uint32_t tf_bits(TfKey k, uint32_t counter) {
  const TfKey h = threefry2x32(k, 0u, counter);
  return h.k1 ^ h.k2;
}

// float32 constants of random.py: the lower bound of `normal`'s uniform,
// float32(sqrt(2)) and XLA's erf_inv polynomials (Giles), as hex floats
#define TF_NORMAL_LO (-0x1.fffffep-1f)
#define TF_SQRT2 (0x1.6a09e6p+0f)

__device__ __forceinline__ float tf_erfinv_coef(int i, bool lt) {
  const float lt5[9] = {0x1.e2cb10p-26f, 0x1.70966cp-22f, -0x1.d8e6aep-19f,
                        -0x1.26b582p-18f, 0x1.ca65b6p-13f, -0x1.48a810p-10f,
                        -0x1.11c9dep-8f, 0x1.f91ec6p-3f, 0x1.805c5ep+0f};
  const float ge5[9] = {-0x1.a3e136p-13f, 0x1.a76ad6p-14f, 0x1.61b8e4p-10f,
                        -0x1.e17bcep-9f, 0x1.7824f6p-8f, -0x1.f38baep-8f,
                        0x1.354afcp-7f, 0x1.006db6p+0f, 0x1.6a9efcp+1f};
  return lt ? lt5[i] : ge5[i];
}

// random.py erf_inv: w = -log1p(x * -x); w < 5 -> w - 2.5, else
// sqrt(w) - 3; p = Horner(w); x = +-1 -> x * inf, else p * x
__device__ __forceinline__ float tf_erf_inv(float x) {
  float w = -log1pf(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(sqrtf(w), 3.0f);
  const double wd = (double)w;
  float p = tf_erfinv_coef(0, lt);
#pragma unroll
  for (int i = 1; i < 9; ++i)
    p = __double2float_rn(__dadd_rn(__dmul_rn((double)p, wd),
                                    (double)tf_erfinv_coef(i, lt)));
  return fabsf(x) == 1.0f ? __fmul_rn(x, __int_as_float(0x7f800000))
                          : __fmul_rn(p, x);
}

// random.py uniform(key, shape, lo, 1) from its 32-bit word: the 23 high
// bits become the mantissa of a float in [1, 2), minus one, times
// float32(1 - lo), plus lo, clamped below at lo
__device__ __forceinline__ float tf_normal_of_bits(uint32_t bits) {
  const float one_two = __uint_as_float((bits >> 9) | 0x3F800000u);
  const float scale = __fsub_rn(1.0f, TF_NORMAL_LO);
  float u = __fadd_rn(__fmul_rn(__fsub_rn(one_two, 1.0f), scale),
                      TF_NORMAL_LO);
  u = fmaxf(u, TF_NORMAL_LO);
  return __fmul_rn(TF_SQRT2, tf_erf_inv(u));
}

__device__ __forceinline__ float tf_normal(TfKey k, uint32_t counter) {
  return tf_normal_of_bits(tf_bits(k, counter));
}
