// Predicated float32 adds that the crossbar kernels of the port share
// (imc_fused.cu, imc_matmul.cu) for their bit-plane sums.
//
// A bit-plane sum adds bit_b(x[k]) * w[k] over k. Every term is 0 or w
// exactly, so each term is one add.rn.f32 of w, predicated on the term's
// activation bit: a skipped term is an exact zero, and an accumulator that
// starts at +0.0 never becomes -0.0 under round-to-nearest (x + -x is +0),
// so skipping it changes no bit of a sum of finite weights. One bit test
// sets the predicate for all the columns a thread holds. add.rn is never
// contracted into an FMA, so no build flag can change the sums.
#pragma once

// adds w to p where `bit` is not 0
__device__ __forceinline__ void add_if(float4& p, const float4& w,
                                       unsigned bit) {
  asm("{\n\t.reg .pred b;\n\tsetp.ne.u32 b, %4, 0;\n\t"
      "@b add.rn.f32 %0, %0, %5;\n\t@b add.rn.f32 %1, %1, %6;\n\t"
      "@b add.rn.f32 %2, %2, %7;\n\t@b add.rn.f32 %3, %3, %8;\n\t}"
      : "+f"(p.x), "+f"(p.y), "+f"(p.z), "+f"(p.w)
      : "r"(bit), "f"(w.x), "f"(w.y), "f"(w.z), "f"(w.w));
}

// adds w0 to p0 and w1 to p1 where `bit` is not 0: 8 columns, one test
__device__ __forceinline__ void add_if(float4& p0, float4& p1,
                                       const float4& w0, const float4& w1,
                                       unsigned bit) {
  asm("{\n\t.reg .pred b;\n\tsetp.ne.u32 b, %8, 0;\n\t"
      "@b add.rn.f32 %0, %0, %9;\n\t@b add.rn.f32 %1, %1, %10;\n\t"
      "@b add.rn.f32 %2, %2, %11;\n\t@b add.rn.f32 %3, %3, %12;\n\t"
      "@b add.rn.f32 %4, %4, %13;\n\t@b add.rn.f32 %5, %5, %14;\n\t"
      "@b add.rn.f32 %6, %6, %15;\n\t@b add.rn.f32 %7, %7, %16;\n\t}"
      : "+f"(p0.x), "+f"(p0.y), "+f"(p0.z), "+f"(p0.w),
        "+f"(p1.x), "+f"(p1.y), "+f"(p1.z), "+f"(p1.w)
      : "r"(bit), "f"(w0.x), "f"(w0.y), "f"(w0.z), "f"(w0.w),
        "f"(w1.x), "f"(w1.y), "f"(w1.z), "f"(w1.w));
}
