// The signed mid-tread ADC every crossbar kernel of the port shares
// (device counterpart of repro_torch/kernels/adc.py):
//
//   delta = full_scale / 2^(bits - 1)
//   q(x)  = clip(rint(x / delta), -2^(bits-1), 2^(bits-1) - 1) * delta
//
// rintf rounds half to even, as torch.round does; the division is a true
// IEEE division (__fdiv_rn), never a multiplication by a rounded 1/delta,
// and the product uses __fmul_rn, so nvcc cannot contract it with a
// following add. When delta is a power of two (every registry row count at
// w_scale = 1) its reciprocal is exact, and x * (1/delta) is the same
// correctly rounded value of x / delta as the division, in every range
// (subnormal results and overflow included), at a tenth of the
// instructions; any other delta takes the division. Kernels that include
// this header must be built without --use_fast_math.
#pragma once

struct Adc {
  float delta;  // one code step at the analog scale
  float inv;    // 1 / delta when delta is a power of two (exact), else 0
  float lo;     // lowest code, -2^(bits-1)
  float hi;     // highest code, 2^(bits-1) - 1
};

__device__ __forceinline__ Adc adc_make(float full_scale, int adc_bits) {
  const float levels = (float)(1 << (adc_bits - 1));
  const float delta = __fdiv_rn(full_scale, levels);
  // a positive normal power of two whose reciprocal is normal too:
  // mantissa bits 0, biased exponent in [1, 253]
  const unsigned b = __float_as_uint(delta);
  const unsigned e = b >> 23;  // the sign bit makes a negative delta fail
  const bool pow2 = (b & 0x7fffffu) == 0 && e >= 1 && e <= 253;
  return Adc{delta, pow2 ? __fdiv_rn(1.0f, delta) : 0.0f, -levels,
             levels - 1.0f};
}

// the integer code of an analog column sum, as a float
__device__ __forceinline__ float adc_code(float x, const Adc& a) {
  const float q = a.inv != 0.0f ? __fmul_rn(x, a.inv) : __fdiv_rn(x, a.delta);
  return fminf(fmaxf(rintf(q), a.lo), a.hi);
}

// the quantized column sum at the analog scale
__device__ __forceinline__ float adc_quantize(float x, const Adc& a) {
  return __fmul_rn(adc_code(x, a), a.delta);
}
