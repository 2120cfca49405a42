"""Holds the fast paths of ``csrc/rglru_coeffs.cuh`` to the CUDA functions
they stand in for, bit for bit, on the GPU.

    python3 tools/check_fast_paths.py

``rcp_fast``, ``div_fast`` and ``sqrt_fast`` are the instruction sequences
nvcc emits for ``__frcp_rn``, ``__fdiv_rn`` and ``sqrtf`` without the
branch to the general routine, and the RG-LRU gradient kernel
(``csrc/rglru_scan_bwd.cu``) takes them only within stated operand
ranges. This compiles a test program against the header and compares:
``rcp_fast(y)`` with ``__frcp_rn(y)`` and ``__fdiv_rn(1, y)`` for every
float32 y in [1, 2^126) (the sigmoid's 1 + exp(-z) below the kernel's
bound), ``sqrt_fast(v)`` with ``sqrtf(v)`` for every v in [2^-30, 1]
(the kernel's operands lie in [1e-8, 1]), and ``div_fast(a, b)`` with
``__fdiv_rn(a, b)`` on 2^30 pseudo-random pairs, a 0 or |a| in [2^-100,
2^100] and b in [2^-13, 2) (the kernel's b = 2 s lies in [2e-4, 2]). It
prints the mismatch counts and exits 1 on any. The program is built
under the gitignored ``build/check_fast_paths/``. Needs a CUDA device
and nvcc.
"""
from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CSRC = os.path.join(ROOT, "src", "repro_torch", "csrc")

PROGRAM = r"""
#include <cstdio>
#include "rglru_coeffs.cuh"
using namespace rglru;
__device__ unsigned long long bad[3];
__global__ void t_rcp(unsigned base, unsigned n) {
  for (unsigned k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const float y = __uint_as_float(base + k);
    const unsigned a = __float_as_uint(rcp_fast(y));
    if (a != __float_as_uint(__frcp_rn(y)) ||
        a != __float_as_uint(__fdiv_rn(1.f, y)))
      atomicAdd(&bad[0], 1ull);
  }
}
__global__ void t_sqrt(unsigned base, unsigned n) {
  for (unsigned k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const float v = __uint_as_float(base + k);
    if (__float_as_uint(sqrt_fast(v)) != __float_as_uint(sqrtf(v)))
      atomicAdd(&bad[1], 1ull);
  }
}
__device__ unsigned mix(unsigned x) {
  x ^= x >> 16; x *= 0x7feb352du; x ^= x >> 15; x *= 0x846ca68bu;
  return x ^ (x >> 16);
}
__global__ void t_div(unsigned seed, unsigned n) {
  for (unsigned k = blockIdx.x * blockDim.x + threadIdx.x; k < n;
       k += gridDim.x * blockDim.x) {
    const unsigned h1 = mix(2 * k + seed), h2 = mix(2 * k + 1 + 7 * seed);
    float a = ldexpf(1.f + (h2 & 0x7fffff) * 0x1p-23f, (int)(h1 % 201) - 100);
    if (h1 >> 31) a = -a;
    if (k % 1024 == 0) a = (k & 1024) ? 0.f : -0.f;
    const float b = ldexpf(1.f + (mix(h1 ^ h2) & 0x7fffff) * 0x1p-23f,
                           (int)((h2 >> 27) % 14) - 13);
    if (__float_as_uint(div_fast(a, b)) != __float_as_uint(__fdiv_rn(a, b)))
      atomicAdd(&bad[2], 1ull);
  }
}
int main() {
  const unsigned rlo = 0x3f800000u, rhi = 0x7e800000u;   // [1, 2^126)
  const unsigned slo = 0x30800000u, shi = 0x3f800001u;   // [2^-30, 1]
  const unsigned chunk = 1u << 26;
  for (unsigned b = rlo; b < rhi; b += chunk)
    t_rcp<<<1024, 256>>>(b, rhi - b < chunk ? rhi - b : chunk);
  for (unsigned b = slo; b < shi; b += chunk)
    t_sqrt<<<1024, 256>>>(b, shi - b < chunk ? shi - b : chunk);
  for (unsigned s = 0; s < 4; ++s) t_div<<<1024, 256>>>(s * 1000003u, 1u << 28);
  const cudaError_t e = cudaDeviceSynchronize();
  unsigned long long h[3] = {0, 0, 0};
  cudaMemcpyFromSymbol(h, bad, sizeof(h));
  printf("rcp_fast: %llu mismatches over %u operands; sqrt_fast: %llu over "
         "%u; div_fast: %llu over %llu pairs (CUDA status %d)\n",
         h[0], rhi - rlo, h[1], shi - slo, h[2], 4ull << 28, (int)e);
  return e != cudaSuccess || h[0] || h[1] || h[2];
}
"""


def main() -> int:
    out = os.path.join(ROOT, "build", "check_fast_paths")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "check_fast_paths.cu")
    with open(src, "w") as f:
        f.write(PROGRAM)
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    exe = os.path.join(out, "check_fast_paths")
    build = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-I", CSRC, "-o", exe, src], capture_output=True, text=True)
    if build.returncode:
        print(build.stdout + build.stderr, file=sys.stderr)
        return 1
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    raise SystemExit(main())
