"""The port's kernel module (repro_torch/kernels): the ADC model bit
for bit, the fused crossbar kernel's plain version against the JAX
Pallas kernel (interpret mode) and its oracle at the tests/test_kernels.py
shape families and tolerance, and the wrapper's CPU rule. The CUDA
kernel itself runs only on a card: tests/test_torch_gpu.py holds it
against the plain version there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adc import adc_quantize as jax_adc_quantize
from repro.kernels.imc_fused import imc_fused_gemm as jax_imc_fused_gemm
from repro.kernels.imc_fused import ir_drop_factor as jax_ir_drop_factor
from repro.kernels.imc_fused import sigma_of_g as jax_sigma_of_g
from repro.kernels.ref import imc_fused_ref
from repro_torch.kernels import build
from repro_torch.kernels.adc import adc_full_scale, adc_quantize
from repro_torch.kernels.imc_fused import (imc_fused_gemm, imc_fused_plain,
                                           ir_drop_factor, sigma_of_g)

torch.set_num_threads(1)

FAMILIES = [
    # the accuracy model's own shape family
    (3, 4, 256, 8, 64, (64.0, 128.0, 256.0)),
    # odd tilings: 3 sub-tiles per crossbar
    (2, 2, 96, 4, 32, (32.0, 64.0, 96.0)),
    # K not a multiple of sub -> zero-padded trailing sub-tile
    (2, 3, 200, 5, 64, (64.0, 128.0)),
    # whole-K crossbar (one group), single design
    (1, 2, 48, 4, 16, (48.0,)),
]


def _inputs(seed, P, B, K, N, rows):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, K)).astype(np.int32),
            rng.uniform(-1.0, 1.0, (K, N)).astype(np.float32),
            rng.standard_normal((P, K, N)).astype(np.float32),
            rng.standard_normal((P, K, N)).astype(np.float32),
            rng.integers(0, len(rows), (P,)).astype(np.int32),
            np.asarray(rows, np.float32))


@pytest.mark.parametrize("bits", [8, 6, 4])
@pytest.mark.parametrize("full_scale", [16.0, 24.0, 32.0, 128.0, 12.0])
def test_adc_quantize_bitwise(bits, full_scale):
    """Codes and levels equal to the reference, including inputs exactly
    on a .5 code boundary (half to even) and the saturated ends."""
    delta = np.float32(full_scale) / np.float32(2.0 ** (bits - 1))
    halves = (np.arange(-300, 300, dtype=np.float32) + 0.5) * delta
    rng = np.random.default_rng(bits)
    x = np.concatenate([halves, rng.standard_normal(5000).astype(np.float32)
                        * full_scale]).astype(np.float32)
    want = np.asarray(jax_adc_quantize(jnp.asarray(x), full_scale, bits))
    got = adc_quantize(torch.from_numpy(x), full_scale, bits).numpy()
    assert np.array_equal(got, want)
    assert adc_full_scale(256.0) == 64.0


def test_sigma_and_ir_drop_match_reference():
    g = np.linspace(0.0, 1.0, 4097, dtype=np.float32)
    np.testing.assert_allclose(sigma_of_g(torch.from_numpy(g)).numpy(),
                               np.asarray(jax_sigma_of_g(jnp.asarray(g))),
                               rtol=2e-7, atol=1e-9)
    rows = np.array([16, 48, 64, 96, 128, 256, 512], np.float32)
    np.testing.assert_array_equal(
        ir_drop_factor(torch.from_numpy(rows)).numpy(),
        np.asarray(jax_ir_drop_factor(jnp.asarray(rows))))


@pytest.mark.parametrize("P,B,K,N,sub,rows", FAMILIES)
def test_plain_matches_pallas_kernel(P, B, K, N, sub, rows):
    """imc_fused_plain vs the Pallas kernel (interpret mode) and its
    oracle, at the tests/test_kernels.py bound (rtol 1e-5, atol 1e-4)."""
    args = _inputs(P + K, P, B, K, N, rows)
    want = np.asarray(jax_imc_fused_gemm(*map(jnp.asarray, args), sub=sub,
                                         interpret=True))
    got = imc_fused_plain(*map(torch.from_numpy, args), sub=sub).numpy()
    assert got.shape == (P, B, N)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    x_q, w, ep, en, ri, rt = args
    for p in range(P):
        ref = np.asarray(imc_fused_ref(jnp.asarray(x_q), jnp.asarray(w),
                                       jnp.asarray(ep[p]), jnp.asarray(en[p]),
                                       rt[ri[p]], sub=sub))
        np.testing.assert_allclose(got[p], ref, rtol=1e-5, atol=1e-4)


def test_plain_adc_bits_and_main_shape():
    """A non-default ADC width, and the accuracy model's main-path shape
    (B=32, K=256, N=32, sub=64) for a few designs."""
    args = _inputs(9, 2, 3, 128, 6, (64.0, 128.0))
    want = np.asarray(jax_imc_fused_gemm(*map(jnp.asarray, args), sub=64,
                                         adc_bits=6, interpret=True))
    got = imc_fused_plain(*map(torch.from_numpy, args), sub=64,
                          adc_bits=6).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    args = _inputs(3, 4, 32, 256, 32, (64.0, 128.0, 256.0, 512.0))
    want = np.asarray(jax_imc_fused_gemm(*map(jnp.asarray, args), sub=64,
                                         interpret=True))
    got = imc_fused_plain(*map(torch.from_numpy, args), sub=64).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_wrapper_on_cpu_runs_plain_version():
    args = [torch.from_numpy(a) for a in _inputs(1, 2, 3, 64, 4, (64.0,))]
    before = imc_fused_gemm.launches
    out = imc_fused_gemm(*args, sub=64)
    assert imc_fused_gemm.launches == before  # no kernel launched
    assert torch.equal(out, imc_fused_plain(*args, sub=64))


def test_build_paths_stay_in_checkout():
    """Kernels build into build/kernels of the checkout under a name
    keyed by the source hash; nothing is compiled at import time."""
    path = build._library_path("imc_fused")
    assert path.parent == build.BUILD_DIR
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert (build.CSRC / "imc_fused.cu").exists()
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS
