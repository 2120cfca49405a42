// The signed mid-tread ADC every crossbar kernel of the port shares
// (device counterpart of repro_torch/kernels/adc.py):
//
//   delta = full_scale / 2^(bits - 1)
//   q(x)  = clip(rint(x / delta), -2^(bits-1), 2^(bits-1) - 1) * delta
//
// rintf rounds half to even, as torch.round does; the division is a true
// IEEE division (__fdiv_rn), never a multiplication by 1/delta, and the
// product uses __fmul_rn, so nvcc cannot contract it with a following add.
// Kernels that include this header must be built without --use_fast_math.
#pragma once

struct Adc {
  float delta;  // one code step at the analog scale
  float lo;     // lowest code, -2^(bits-1)
  float hi;     // highest code, 2^(bits-1) - 1
};

__device__ __forceinline__ Adc adc_make(float full_scale, int adc_bits) {
  const float levels = (float)(1 << (adc_bits - 1));
  return Adc{__fdiv_rn(full_scale, levels), -levels, levels - 1.0f};
}

// the integer code of an analog column sum, as a float
__device__ __forceinline__ float adc_code(float x, const Adc& a) {
  return fminf(fmaxf(rintf(__fdiv_rn(x, a.delta)), a.lo), a.hi);
}

// the quantized column sum at the analog scale
__device__ __forceinline__ float adc_quantize(float x, const Adc& a) {
  return __fmul_rn(adc_code(x, a), a.delta);
}
