"""The port's kernel modules (repro_torch/kernels): the ADC model bit
for bit; the fused crossbar kernel's, the bit-serial crossbar GEMM's and
the flash attention kernel's plain versions against the JAX Pallas
kernels (interpret mode) and their oracles at the tests/test_kernels.py
shapes and tolerances; the
wrappers' CPU rule, ``ops.imc_gemm``'s padding, and the build's
library naming. The CUDA kernels themselves run only on a card:
tests/test_torch_gpu.py holds them against the plain versions there."""
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.adc import adc_quantize as jax_adc_quantize
from repro.kernels.flash_attention import flash_attention as jax_pallas_flash
from repro.kernels.imc_fused import imc_fused_gemm as jax_imc_fused_gemm
from repro.kernels.imc_fused import ir_drop_factor as jax_ir_drop_factor
from repro.kernels.imc_fused import sigma_of_g as jax_sigma_of_g
from repro.kernels.imc_matmul import imc_matmul as jax_imc_matmul
from repro.kernels.ops import flash_mha as jax_flash_mha
from repro.kernels.ops import imc_gemm as jax_imc_gemm
from repro.kernels.ref import attention_ref, imc_fused_ref, imc_matmul_ref
from repro.models.attention import blockwise_attention
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import imc_matmul as matmul_mod
from repro_torch.kernels.adc import adc_full_scale, adc_quantize
from repro_torch import random as jr
from repro_torch.kernels.imc_fused import (crossbar_sums, imc_fused_gemm,
                                           imc_fused_gemm_keyed,
                                           imc_fused_keyed_plain,
                                           imc_fused_plain, noisy_weights,
                                           ir_drop_factor, sigma_of_g)
from repro_torch.kernels.imc_matmul import imc_matmul, imc_matmul_plain
from repro_torch.kernels.ops import flash_mha, imc_gemm

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


# the keyed route: the four families and the accuracy model's main shape
KEYED_SHAPES = FAMILIES + [(24, 32, 256, 32, 64, (64.0, 128.0, 256.0, 512.0))]


def _keyed_inputs(seed, P, B, K, N, rows):
    """Seeded x_q, w, rows_idx, row_table, a key seed and P flat design
    indices below 2^31."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (B, K)).astype(np.int32),
            rng.uniform(-1.0, 1.0, (K, N)).astype(np.float32),
            rng.integers(0, len(rows), (P,)).astype(np.int32),
            np.asarray(rows, np.float32), int(rng.integers(0, 2 ** 31)),
            rng.integers(0, 2 ** 31, (P,)).astype(np.int64))


def _keyed_torch(x_q, w, ri, rt, seed, flat):
    return (torch.from_numpy(x_q), torch.from_numpy(w), jr.PRNGKey(seed),
            torch.from_numpy(flat), torch.from_numpy(ri), torch.from_numpy(rt))


def _jax_keyed_draws(seed, flat, K, N, B):
    """eps_pos, eps_neg (P, K, N) and z (P, B, N) as jax.random draws
    them from split(fold_in(key, flat[p]), 3)."""
    def one(d):
        k = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed), d),
                             3)
        return (jax.random.normal(k[0], (K, N)),
                jax.random.normal(k[1], (K, N)),
                jax.random.normal(k[2], (B, N)))
    return [np.asarray(a) for a in
            jax.vmap(one)(jnp.asarray(flat.astype(np.int32)))]


@pytest.mark.parametrize("P,B,K,N,sub,rows", KEYED_SHAPES)
def test_keyed_plain_matches_pallas_kernel(P, B, K, N, sub, rows):
    """imc_fused_keyed_plain vs the reference: the eps fields drawn with
    jax.random.fold_in/split/normal and run through the Pallas kernel in
    interpret mode, at the tests/test_kernels.py bound (rtol 1e-5, atol
    1e-4); z_out vs jax.random.normal within 4 ULP."""
    x_q, w, ri, rt, seed, flat = _keyed_inputs(P * K + B, P, B, K, N, rows)
    ep, en, z = _jax_keyed_draws(seed, flat, K, N, B)
    want = np.asarray(jax_imc_fused_gemm(
        *map(jnp.asarray, (x_q, w, ep, en, ri, rt)), sub=sub,
        interpret=True))
    raw, z_out = imc_fused_keyed_plain(
        *_keyed_torch(x_q, w, ri, rt, seed, flat), sub=sub)
    assert raw.shape == z_out.shape == (P, B, N)
    np.testing.assert_allclose(raw.numpy(), want, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(z_out.numpy(), z, rtol=4 * 2 ** -23,
                               atol=1e-30)


def _kernel_order_model(x_q, w, eps_pos, eps_neg, rows_idx, row_table, *,
                        sub, adc_bits=8):
    """The summation order of csrc/imc_fused.cu, in float32 tensor adds
    over (P, N) lanes: the sub-tiles split over a cluster of C CTAs (the
    largest power of two up to min(sub-tiles, 8)) in rounds; each CTA's
    sub-tile partial sums per row and bit plane add only the terms whose
    bit is set, in ascending k; the round's partial sums then go into
    the crossbar-group sums in sub-tile order, the ADC at each group
    end. Returns (out (P, B, N), the crossbar sums before the ADC as
    ``crossbar_sums`` lays them out, adds made)."""
    P, K, N = eps_pos.shape
    B = x_q.shape[0]
    n_sub = -(-K // sub)
    C = 1
    while C * 2 <= min(n_sub, 8):
        C *= 2
    rows = row_table[rows_idx.long().clamp(0, row_table.shape[0] - 1)]
    w_eff = torch.nn.functional.pad(
        noisy_weights(w, eps_pos, eps_neg, rows), (0, 0, 0, n_sub * sub - K))
    fs = adc_full_scale(rows)[:, None]
    r_np = rows.numpy()
    x = torch.nn.functional.pad(x_q.long(), (0, n_sub * sub - K)).tolist()
    grp = [[torch.zeros(P, N)] * 8 for _ in range(B)]
    acc = [torch.zeros(P, N) for _ in range(B)]
    sums = torch.zeros((P, 8, B, n_sub, N))
    adds = 0
    for r0 in range(0, n_sub, C):
        # each CTA of the round: its sub-tile's partial sums, set bits only
        part = {}
        for s in range(r0, min(r0 + C, n_sub)):
            for b in range(B):
                for q in range(8):
                    acc_q = torch.zeros(P, N)
                    for kr in range(sub):
                        if (x[b][s * sub + kr] >> q) & 1:
                            acc_q = acc_q + w_eff[:, s * sub + kr]
                            adds += 1
                    part[s, b, q] = acc_q
        # the round's partial sums in sub-tile order, per output
        for s in range(r0, min(r0 + C, n_sub)):
            g = np.floor(np.float32(s * sub) / r_np)
            end = torch.from_numpy(
                (s == n_sub - 1)
                | (np.floor(np.float32((s + 1) * sub) / r_np) != g))
            for b in range(B):
                for q in range(8):
                    grp[b][q] = grp[b][q] + part[s, b, q]
                    sums[end, q, b, g[end.numpy()]] = grp[b][q][end]
                    code = adc_quantize(grp[b][q], fs, adc_bits)
                    acc[b] = torch.where(end[:, None],
                                         acc[b] + code * float(1 << q),
                                         acc[b])
                    grp[b][q] = torch.where(end[:, None], torch.zeros(()),
                                            grp[b][q])
    return torch.stack(acc, dim=1), sums, adds


@pytest.mark.parametrize("P,B,K,N,sub,rows", KEYED_SHAPES)
def test_kernel_summation_order_is_bitwise_plain(P, B, K, N, sub, rows):
    """The kernel's order (set bits only) gives imc_fused_plain's bits,
    in the crossbar sums before the ADC as well as after it: every
    skipped term is a zero added to an accumulator that is never -0.0.
    (The ADC alone would hide most order changes; the sums do not.)
    The inputs are the keyed route's own draws."""
    x_q, w, ri, rt, seed, flat = _keyed_inputs(P * K + B, P, B, K, N, rows)
    x_q, w, key, flat, ri, rt = _keyed_torch(x_q, w, ri, rt, seed, flat)
    k = jr.split(jr.fold_in(key, flat), 3)
    ep, en = jr.normal(k[:, 0], (K, N)), jr.normal(k[:, 1], (K, N))
    got, sums, adds = _kernel_order_model(x_q, w, ep, en, ri, rt, sub=sub)
    rows_p = rt[ri.long()]
    assert torch.equal(sums, crossbar_sums(
        x_q, noisy_weights(w, ep, en, rows_p), rows_p, sub=sub))
    want = imc_fused_plain(x_q, w, ep, en, ri, rt, sub=sub)
    assert torch.equal(got, want)
    assert torch.equal(want, imc_fused_keyed_plain(x_q, w, key, flat, ri, rt,
                                                   sub=sub)[0])
    # only the set bits are added: about half of the plain version's terms
    set_bits = sum(int(((x_q >> q) & 1).sum()) for q in range(8))
    assert adds == set_bits
    assert adds < 0.6 * 8 * B * K


def test_keyed_wrapper_on_cpu_runs_plain_version():
    x_q, w, ri, rt, seed, flat = _keyed_inputs(5, 3, 4, 96, 6, (32.0, 64.0))
    args = _keyed_torch(x_q, w, ri, rt, seed, flat)
    before = imc_fused_gemm_keyed.launches
    raw, z = imc_fused_gemm_keyed(*args, sub=32)
    assert imc_fused_gemm_keyed.launches == before  # no kernel launched
    want_raw, want_z = imc_fused_keyed_plain(*args, sub=32)
    assert torch.equal(raw, want_raw) and torch.equal(z, want_z)


def test_build_paths_stay_in_checkout():
    """Kernels build into build/kernels of the checkout under a name
    keyed by the source hash; nothing is compiled at import time. The
    two crossbar kernels share the ADC device code of csrc/adc.cuh and
    the predicated bit-plane adds of csrc/predicated_add.cuh, and the
    fused one draws its noise with csrc/threefry.cuh; the flash
    attention kernel includes its bfloat16 tensor-core route,
    csrc/flash_attention_wgmma.cuh, and the split-TF32 helpers of its
    float32 route, csrc/tf32x3.cuh; its gradient,
    csrc/flash_attention_bwd.cu, includes its own tensor-core route,
    csrc/flash_attention_bwd_wgmma.cuh, which includes the forward's
    header for its PTX helpers, and csrc/tf32x3.cuh. The RG-LRU scan and
    its gradient share csrc/rglru_coeffs.cuh (loads and stores, the
    parameters, a step's coefficients, the carry flags). The decode
    attention and the mLSTM and sLSTM scan kernels and their backward
    kernels include no header of their own."""
    assert set(build.SIGNATURES) == {"imc_fused", "imc_matmul",
                                     "flash_attention", "flash_attention_bwd",
                                     "decode_attention", "rglru_scan",
                                     "rglru_scan_bwd", "mlstm_scan",
                                     "slstm_scan", "mlstm_scan_bwd",
                                     "slstm_scan_bwd"}
    for name in build.SIGNATURES:
        path = build._library_path(name)
        assert path.parent == build.BUILD_DIR
        src = (build.CSRC / f"{name}.cu").read_text()
        assert build._INCLUDE.findall(src) == {
            "decode_attention": [], "rglru_scan": ["rglru_coeffs.cuh"],
            "rglru_scan_bwd": ["rglru_coeffs.cuh"],
            "mlstm_scan": [], "slstm_scan": [], "mlstm_scan_bwd": [],
            "slstm_scan_bwd": [],
            "flash_attention": ["flash_attention_wgmma.cuh", "tf32x3.cuh"],
            "flash_attention_bwd": ["flash_attention_bwd_wgmma.cuh",
                                    "tf32x3.cuh"],
            "imc_fused": ["adc.cuh", "predicated_add.cuh", "threefry.cuh"],
            "imc_matmul": ["adc.cuh", "predicated_add.cuh"]}[name]
        assert build._headers(src) == {
            "decode_attention": [], "rglru_scan": ["rglru_coeffs.cuh"],
            "rglru_scan_bwd": ["rglru_coeffs.cuh"],
            "mlstm_scan": [], "slstm_scan": [], "mlstm_scan_bwd": [],
            "slstm_scan_bwd": [],
            "flash_attention": ["flash_attention_wgmma.cuh", "tf32x3.cuh"],
            "flash_attention_bwd": ["flash_attention_bwd_wgmma.cuh",
                                    "flash_attention_wgmma.cuh",
                                    "tf32x3.cuh"],
            "imc_fused": ["adc.cuh", "predicated_add.cuh", "threefry.cuh"],
            "imc_matmul": ["adc.cuh", "predicated_add.cuh"]}[name]
    assert build.BUILD_DIR.parts[-2:] == ("build", "kernels")
    assert "sm_90a" in " ".join(build.NVCC_FLAGS)
    assert "--use_fast_math" not in build.NVCC_FLAGS


def test_library_name_tracks_included_headers(tmp_path, monkeypatch):
    """An edit to a shared header (the ADC, the predicated adds)
    renames (so rebuilds) both crossbar kernels' libraries; an edit to
    one source renames only its own; an edit to the threefry header
    renames only imc_fused's library, one to the flash kernel's
    tensor-core header both flash libraries (the gradient's header
    includes it), one to the gradient's tensor-core header only the
    gradient's library."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("imc_fused", "imc_matmul")
    before = {n: build._library_path(n) for n in names}
    assert before == {n: build._library_path(n) for n in names}
    with open(csrc / "adc.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build._library_path(n) for n in names}
    assert all(after[n] != before[n] for n in names)
    flash = build._library_path("flash_attention")
    with open(csrc / "predicated_add.cuh", "a") as f:
        f.write("// edited\n")
    added = {n: build._library_path(n) for n in names}
    assert all(added[n] != after[n] for n in names)
    assert build._library_path("flash_attention") == flash
    after = added
    with open(csrc / "imc_matmul.cu", "a") as f:
        f.write("// edited\n")
    again = {n: build._library_path(n) for n in names}
    assert again["imc_fused"] == after["imc_fused"]
    assert again["imc_matmul"] != after["imc_matmul"]
    with open(csrc / "threefry.cuh", "a") as f:
        f.write("// edited\n")
    keyed = {n: build._library_path(n) for n in names}
    assert keyed["imc_fused"] != again["imc_fused"]
    assert keyed["imc_matmul"] == again["imc_matmul"]
    again = keyed
    flash = build._library_path("flash_attention")
    bwd = build._library_path("flash_attention_bwd")
    with open(csrc / "flash_attention_wgmma.cuh", "a") as f:
        f.write("// edited\n")
    assert build._library_path("flash_attention") != flash
    assert build._library_path("flash_attention_bwd") != bwd
    assert {n: build._library_path(n) for n in names} == again
    flash = build._library_path("flash_attention")
    bwd = build._library_path("flash_attention_bwd")
    with open(csrc / "flash_attention_bwd_wgmma.cuh", "a") as f:
        f.write("// edited\n")
    assert build._library_path("flash_attention") == flash
    assert build._library_path("flash_attention_bwd") != bwd
    assert {n: build._library_path(n) for n in names} == again


def test_rglru_header_renames_both_scan_libraries(tmp_path, monkeypatch):
    """An edit to csrc/rglru_coeffs.cuh renames (so rebuilds) the RG-LRU
    scan's library and its gradient's, and no other kernel's."""
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    before = {n: build._library_path(n) for n in build.SIGNATURES}
    with open(csrc / "rglru_coeffs.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: build._library_path(n) for n in build.SIGNATURES}
    assert {n for n in before if after[n] != before[n]} == {
        "rglru_scan", "rglru_scan_bwd"}


# ---------------------------------------------------------------------------
# imc_matmul: the bit-serial crossbar GEMM
# ---------------------------------------------------------------------------

# tests/test_kernels.py's shapes (M, K, N, R) and ADC widths
MATMUL_SHAPES = [(8, 128, 16, 128), (16, 256, 32, 128), (32, 512, 64, 256),
                 (8, 384, 8, 128), (8, 512, 8, 512)]


def _matmul_inputs(seed, M, K, N, scale=0.3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (M, K)).astype(np.int32),
            (rng.standard_normal((K, N)) * scale).astype(np.float32))


def _check_against_reference(x, w, R, adc_bits=8):
    """imc_matmul_plain vs the Pallas kernel in interpret mode (through
    the JAX ops.imc_gemm) and vs imc_matmul_ref, at the bound of
    tests/test_kernels.py (rtol 1e-6, atol 1e-4)."""
    got = imc_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                           xbar_rows=R, adc_bits=adc_bits).numpy()
    kern = np.asarray(jax_imc_gemm(jnp.asarray(x), jnp.asarray(w),
                                   xbar_rows=R, adc_bits=adc_bits))
    ref = np.asarray(imc_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                    xbar_rows=R, adc_bits=adc_bits))
    assert got.shape == kern.shape == (x.shape[0], w.shape[1])
    np.testing.assert_allclose(got, kern, rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-4)
    return got, kern


@pytest.mark.parametrize("M,K,N,R", MATMUL_SHAPES)
def test_imc_matmul_plain_matches_pallas_kernel(M, K, N, R):
    _check_against_reference(*_matmul_inputs(M + K + N, M, K, N), R)


@pytest.mark.parametrize("adc_bits", [4, 6, 8, 12])
def test_imc_matmul_plain_adc_bits(adc_bits):
    _check_against_reference(*_matmul_inputs(adc_bits, 8, 256, 16), 128,
                             adc_bits=adc_bits)


@pytest.mark.parametrize("R", [64, 128, 256, 512])
def test_imc_matmul_plain_at_oracle_shape(R):
    """The host oracle's calibration GEMM (32 x 256 codes, 256 x 32
    weights at the accuracy model's 0.3 scale), K padded to R where R
    exceeds it, against the direct Pallas call in interpret mode."""
    x, w = _matmul_inputs(R, 32, 256, 32)
    pad = (-256) % R
    xp, wp = np.pad(x, ((0, 0), (0, pad))), np.pad(w, ((0, pad), (0, 0)))
    got, _ = _check_against_reference(xp, wp, R)
    direct = np.asarray(jax_imc_matmul(jnp.asarray(xp), jnp.asarray(wp),
                                       xbar_rows=R, block_m=32, block_n=32,
                                       interpret=True))
    np.testing.assert_allclose(got, direct, rtol=1e-6, atol=1e-4)


def test_imc_gemm_pads_k_and_masks_ragged_m_n():
    """ops.imc_gemm takes any (M, K): K is zero-padded to whole
    crossbars and equals the plain version on explicitly padded
    operands; ragged M and N need no padding. Against the JAX ops."""
    x, w = _matmul_inputs(5, 5, 200, 7)
    got = imc_gemm(torch.from_numpy(x), torch.from_numpy(w),
                   xbar_rows=64).numpy()
    padded = imc_matmul_plain(
        torch.from_numpy(np.pad(x, ((0, 0), (0, 56)))),
        torch.from_numpy(np.pad(w, ((0, 56), (0, 0)))), xbar_rows=64)
    assert np.array_equal(got, padded.numpy())
    want = np.asarray(jax_imc_gemm(jnp.asarray(x), jnp.asarray(w),
                                   xbar_rows=64))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="multiple"):
        imc_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                         xbar_rows=64)


def test_imc_matmul_wrapper_on_cpu_runs_plain_version():
    x, w = map(torch.from_numpy, _matmul_inputs(1, 4, 128, 8))
    before = imc_matmul.launches
    out = imc_matmul(x, w, xbar_rows=64, adc_bits=6)
    assert imc_matmul.launches == before  # no kernel launched
    assert torch.equal(out, imc_matmul_plain(x, w, xbar_rows=64,
                                             adc_bits=6))


def test_imc_matmul_plain_column_chunks_keep_the_arithmetic(monkeypatch):
    """Wide products run in column chunks; the columns are independent,
    so the result is bit for bit the unchunked one."""
    x, w = map(torch.from_numpy, _matmul_inputs(2, 6, 256, 40))
    whole = imc_matmul_plain(x, w, xbar_rows=64, w_scale=0.7)
    monkeypatch.setattr(matmul_mod, "_PLAIN_MAX_ELEMENTS", 8 * 6 * 4 * 3)
    assert torch.equal(imc_matmul_plain(x, w, xbar_rows=64, w_scale=0.7),
                       whole)


def _tile_outputs(x, w, R, adc_bits, w_scale):
    """imc_matmul_plain of each R-row crossbar tile alone, (T, M, N)."""
    return torch.stack([
        imc_matmul_plain(x[:, t:t + R], w[t:t + R], xbar_rows=R,
                         adc_bits=adc_bits, w_scale=w_scale)
        for t in range(0, x.shape[1], R)])


@pytest.mark.parametrize("adc_bits", [8, 12])
def test_imc_matmul_tile_order_changes_bits(adc_bits):
    """The tests have the power to see a kernel that combines crossbar
    tiles out of order: at w_scale=0.7 the ADC step is not a power of two
    and the tile values round when added, so the per-tile outputs summed
    in tile order give the plain version's bits and summed in reverse
    order do not."""
    x, w = map(torch.from_numpy, _matmul_inputs(adc_bits, 4, 2560, 64))
    want = imc_matmul_plain(x, w, xbar_rows=64, adc_bits=adc_bits,
                            w_scale=0.7)
    tiles = _tile_outputs(x, w, 64, adc_bits, 0.7)
    assert tiles.shape[0] == 40
    fwd, rev = torch.zeros_like(want), torch.zeros_like(want)
    for t in range(40):
        fwd += tiles[t]
        rev += tiles[39 - t]
    assert torch.equal(fwd, want)
    assert int((rev != want).sum()) >= 1


def _matmul_kernel_order_model(x_q, w, R, adc_bits, w_scale):
    """The summation order of csrc/imc_matmul.cu in float32 tensor ops
    over the columns of one slab: the T crossbar tiles over a cluster of
    C = ceil(T / ceil(T / 8)) CTAs in rounds (CTA rank s computes tile
    j * C + s in round j); each tile's bit-plane sums for every row add
    w[k] to all of a thread's columns only where the term's bit is set,
    in ascending k (a predicated add per set bit, the bit test shared by
    the columns); the ADC, the bits 0..7 in order; then the round's tile
    values into the outputs in rank order. Returns (out (M, N), the
    bit-plane sums before the ADC (8, M, T, N), predicated adds made)."""
    M, K = x_q.shape
    T = K // R
    rounds = -(-T // 8)
    C = -(-T // rounds)
    fs = adc_full_scale(float(R), w_scale)
    sums = torch.zeros((8, M, T, w.shape[1]))
    out = torch.zeros((M, w.shape[1]))
    adds = 0
    for j in range(rounds):
        tiles = []
        for s in range(min(C, T - j * C)):
            t = j * C + s
            part = torch.zeros((8, M, w.shape[1]))
            for k in range(t * R, (t + 1) * R):
                bit = torch.stack([(x_q[:, k] >> q) & 1 for q in range(8)])
                part = torch.where(bit[..., None] == 1, part + w[k], part)
                adds += int(bit.sum())
            sums[:, :, t] = part
            tile = torch.zeros_like(out)
            for q in range(8):
                tile = tile + adc_quantize(part[q], fs, adc_bits) * float(
                    1 << q)
            tiles.append(tile)
        for tile in tiles:  # after cluster.sync(), in rank order
            out = out + tile
    return out, sums, adds


@pytest.mark.parametrize("M,K,N,R,adc_bits", [
    (4, 2560, 64, 64, 8),     # 40 tiles: 5 rounds of 8 CTAs
    (4, 2560, 64, 64, 12),
    (5, 704, 70, 64, 12),     # 11 tiles: rounds of 6 and 5 CTAs
    (20, 640, 40, 128, 8),    # 5 tiles: one round of 5
    (3, 300, 9, 100, 8),      # R not a multiple of the 32-row chunks
])
def test_imc_matmul_kernel_order_is_bitwise_plain(monkeypatch, M, K, N, R,
                                                  adc_bits):
    """The kernel's order (set bits only, tiles combined in order across
    cluster ranks and rounds) gives imc_matmul_plain's bits at
    w_scale=0.7, in the bit-plane sums before the ADC as well as after
    it, and makes one predicated add per set bit. The plain version's
    sums are read at its ADC call."""
    x, w = map(torch.from_numpy, _matmul_inputs(M * K + N, M, K, N))
    seen = []

    def adc_spy(part, fs, bits):
        seen.append(part.clone())
        return adc_quantize(part, fs, bits)
    monkeypatch.setattr(matmul_mod, "adc_quantize", adc_spy)
    want = imc_matmul_plain(x, w, xbar_rows=R, adc_bits=adc_bits,
                            w_scale=0.7)
    monkeypatch.undo()
    got, sums, adds = _matmul_kernel_order_model(x, w, R, adc_bits, 0.7)
    assert torch.equal(sums, torch.cat(seen, dim=3))
    assert torch.equal(got, want)
    set_bits = sum(int(((x >> q) & 1).sum()) for q in range(8))
    assert adds == set_bits
    assert adds < 0.6 * 8 * M * K


# tests/test_kernels.py's flash shapes: (B, S, T, H, hd, causal, window, dtype)
FLASH_SHAPES = [
    (2, 32, 32, 2, 16, True, 0, np.float32),
    (1, 64, 64, 4, 32, True, 0, np.float32),
    (2, 48, 48, 2, 16, False, 0, np.float32),
    (1, 64, 64, 2, 16, True, 16, np.float32),
    (1, 40, 40, 2, 16, True, 0, np.float32),    # non-multiple of block
    (2, 32, 32, 2, 16, True, 0, "bfloat16"),
]


def _flash_inputs(seed, B, S, T, H, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, hd), (B, T, H, hd), (B, T, H, hd))]


def _fold(x):
    B, L, H, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, L, hd)


@pytest.mark.parametrize("B,S,T,H,hd,causal,win,dt", FLASH_SHAPES)
def test_flash_plain_matches_pallas_kernel(B, S, T, H, hd, causal, win, dt):
    """``ops.flash_mha`` (the plain version on CPU tensors) vs the JAX
    ``flash_mha`` (Pallas, interpret mode) with its 16-row blocks, at
    tests/test_kernels.py's bounds: atol 2e-5 in float32, 2e-2 in
    bfloat16 (both round the same float32 result to bfloat16)."""
    q, k, v = _flash_inputs(S + H, B, S, T, H, hd)
    jdt = jnp.bfloat16 if dt == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dt == "bfloat16" else torch.float32
    want = jax_flash_mha(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                         causal=causal, window=win, block_q=16, block_k=16)
    got = flash_mha(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                    causal=causal, window=win, block_q=16, block_k=16)
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=2e-2 if dt == "bfloat16" else 2e-5)
    ref = attention_ref(*(jnp.asarray(_fold(a), jdt) for a in (q, k, v)),
                        causal=causal, window=win)
    np.testing.assert_allclose(
        _fold(got.float().numpy()), np.asarray(ref, np.float32),
        atol=2e-2 if dt == "bfloat16" else 2e-5)


def test_flash_plain_masks_true_key_length():
    """Non-causal with T not a multiple of the block: the reference's
    ``flash_mha`` pads T to 16 and lets the zero keys into the softmax
    (off by 0.096 from ``attention_ref`` here, ROADMAP Queue 3); the port masks
    at the true T and matches ``attention_ref``."""
    B, S, T, H, hd = 1, 40, 40, 2, 16
    q, k, v = _flash_inputs(7, B, S, T, H, hd)
    got = flash_mha(*(torch.from_numpy(a) for a in (q, k, v)),
                    causal=False, block_q=16, block_k=16)
    ref = np.asarray(attention_ref(*(jnp.asarray(_fold(a))
                                     for a in (q, k, v)), causal=False))
    np.testing.assert_allclose(_fold(got.numpy()), ref, atol=2e-5)
    padded = np.asarray(jax_flash_mha(*(jnp.asarray(a) for a in (q, k, v)),
                                      causal=False, block_q=16, block_k=16))
    assert np.abs(_fold(padded) - ref).max() > 1e-2  # the reference's fault


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, 0, 0), (True, 300, 0), (False, 0, 0), (True, 0, 700)])
def test_flash_plain_chunking_matches_reference_oracle(causal, window,
                                                       q_offset):
    """Across several 512-row chunks (skipped chunks above the diagonal
    and below the window), the reference's (BH, S, hd) fold as a
    (BH, 1, S, hd) view, and a query offset, against
    ``attention_ref`` on the same positions (its keys extended by
    ``q_offset`` unseen rows: the oracle has no offset)."""
    BH, S, hd = 2, 1100, 8
    T = S + q_offset
    rng = np.random.default_rng(window + q_offset)
    q, k, v = (rng.standard_normal((BH, L, hd)).astype(np.float32)
               for L in (S, T, T))
    got = flash_mod.flash_attention(
        *(torch.from_numpy(a).unsqueeze(1) for a in (q, k, v)),
        causal=causal, window=window, q_offset=q_offset)[:, 0]
    # the oracle's query i sits at position i: prepend q_offset dummies
    qx = np.concatenate([np.zeros((BH, q_offset, hd), np.float32), q], 1)
    ref = np.asarray(attention_ref(jnp.asarray(qx), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window))[:, q_offset:]
    np.testing.assert_allclose(got.numpy(), ref, atol=2e-5)


def test_flash_wrapper_on_cpu_runs_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _flash_inputs(0, 1, 8, 8, 2, 8))
    before = flash_mod.flash_attention.launches
    got = flash_mha(q, k, v)
    assert flash_mod.flash_attention.launches == before  # no kernel launched
    want = flash_mod.flash_attention_plain(q.transpose(1, 2),
                                           k.transpose(1, 2),
                                           v.transpose(1, 2))
    assert torch.equal(got, want.transpose(1, 2))


def _emulate_bf16_kernel_pv(q, k, v, split, block_k=128):
    """The bfloat16 kernel's P.V arithmetic on (BH, S, hd) bf16 inputs,
    causal, from the plain version's float32 scores: an online softmax
    over key tiles of ``block_k`` whose p feeds the product either rounded
    once to bf16 or split as bf16(p) + bf16(p - bf16(p)); the denominator
    sums the unrounded p. The products of bf16 terms and the f32 sums are
    what the tensor cores compute, up to f32 summation order."""
    BH, S, hd = q.shape
    s = (q.float() * (1.0 / hd ** 0.5)) @ k.float().transpose(1, 2)
    pos = torch.arange(S)
    s = torch.where(pos[:, None] >= pos[None, :], s,
                    flash_mod.NEG_INF)
    vf = v.float()
    m = torch.full((BH, S, 1), flash_mod.NEG_INF)
    l = torch.zeros((BH, S, 1))
    acc = torch.zeros((BH, S, hd))
    for j0 in range(0, S, block_k):
        st = s[:, :, j0:j0 + block_k]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        p = torch.exp(st - m_new)
        corr = torch.exp(m - m_new)
        hi = p.to(torch.bfloat16).float()
        pv = hi @ vf[:, j0:j0 + block_k]
        if split:
            lo = (p - hi).to(torch.bfloat16).float()
            pv = pv + lo @ vf[:, j0:j0 + block_k]
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + pv
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


def test_bf16_kernel_needs_p_split_in_two():
    """Why the bfloat16 kernel runs P.V twice: with P rounded once to
    bf16 (the usual tensor-core shortcut) thousands of outputs fall
    outside the bf16 limit the card's checks hold the kernel to (each
    element within two bf16 steps of the plain version plus 1e-4; the
    float32 P of the Pallas kernel and the plain version differ by one
    step at most); with P as bf16(p) + bf16(p - bf16(p)) none does."""
    rng = np.random.default_rng(14)
    BH, S, hd = 4, 300, 128
    q, k, v = (torch.from_numpy(rng.standard_normal((BH, S, hd)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(3))
    want = flash_mod.flash_attention_plain(q, k, v, causal=True).float()
    limit = 1e-4 + 2.0 ** -6 * want.abs()
    once = _emulate_bf16_kernel_pv(q, k, v, split=False).float()
    split = _emulate_bf16_kernel_pv(q, k, v, split=True).float()
    over_once = int(((once - want).abs() > limit).sum())
    over_split = int(((split - want).abs() > limit).sum())
    assert over_once > 0.01 * want.numel()  # the shortcut breaks the limit
    assert (once - want).abs().max() <= 2e-2  # which atol 2e-2 alone misses
    assert over_split == 0
    assert (split - want).abs().max() <= 2.0 ** -7


# the gradient's tensor-core route (csrc/flash_attention_bwd_wgmma.cuh):
# (B, S, T, H, hd, causal, window, q_offset) of a training-like shape, a
# window across several 64-row tiles, a query offset with S != T; then the
# hd-256 layout (recurrentgemma's head width): a window with S off the
# tiles, and a head dim of 200 zero-padded to 256
BWD_EMULATED = [(2, 128, 128, 4, 128, True, 0, 0),
                (1, 300, 300, 2, 128, True, 100, 0),
                (2, 37, 120, 3, 64, True, 0, 83),
                (1, 300, 300, 2, 256, True, 100, 0),
                (1, 200, 200, 2, 200, True, 0, 0)]
# the products whose A operand (P or dS) the kernel splits into hi + lo
BWD_SPLIT = ("p_do", "ds_q", "ds_k")


def _emulate_bf16_kernel_bwd(q, k, v, o, do, causal, window, q_offset,
                             split=BWD_SPLIT):
    """The tensor-core gradient's arithmetic on (BH, L, hd) bf16 inputs,
    in plain torch: scores from exact bf16 products in float32, times
    scale * log2 e; the forward's log-sum-exp in base 2 by its online
    max and sum over its key tiles (128 keys, 64 at a head dim padded to
    256); P = exp2(x - lse) under the mask and dS = P (dP - D) in float32
    with D = rowsum(dO o) (at hd 256 P^T and dP^T cross from one
    warpgroup to the other as float32, so the same); dV and dK summed
    over 64-row query tiles, dQ over the dq kernel's key tiles (64 keys,
    32 at 256), each product's A operand (P^T for dV, dS^T for dK, dS
    for dQ) rounded once to bf16, or, for the products named in
    ``split``, as bf16(x) + bf16(x - bf16(x)); gradients rounded to bf16.
    Up to float32 summation order this is what the kernel computes."""
    BH, S, hd = q.shape
    T = k.shape[1]
    fwd_keys, dq_keys = (64, 32) if hd > 128 else (128, 64)
    scale = 1.0 / hd ** 0.5
    c = float(np.float32(scale * flash_mod.LOG2E))
    vis = flash_mod._visible(torch.arange(S) + q_offset, torch.arange(T),
                             T, causal, window)[None]
    x = torch.where(vis, (q.float() @ k.float().transpose(1, 2)) * c,
                    flash_mod.NEG_INF)
    m = torch.full((BH, S), flash_mod.NEG_INF)
    l = torch.zeros((BH, S))
    for j0 in range(0, T, fwd_keys):
        xt = x[:, :, j0:j0 + fwd_keys]
        m_new = torch.maximum(m, xt.amax(-1))
        l = l * torch.exp2(m - m_new) + torch.exp2(
            xt - m_new[..., None]).sum(-1)
        m = m_new
    lse = m + torch.log2(torch.clamp(l, min=1e-30))
    dd = (do.float() * o.float()).sum(-1)
    p = torch.where(vis, torch.exp2(x - lse[..., None]), 0.0)
    ds = p * (do.float() @ v.float().transpose(1, 2) - dd[..., None])

    def product(a, b, name):
        hi = a.to(torch.bfloat16).float()
        out = hi @ b
        if name in split:
            out = out + (a - hi).to(torch.bfloat16).float() @ b
        return out

    dq, dk, dv = (torch.zeros((BH, L, hd)) for L in (S, T, T))
    for i0 in range(0, S, 64):
        rows = slice(i0, i0 + 64)
        dv += product(p[:, rows].transpose(1, 2), do[:, rows].float(),
                      "p_do")
        dk += product(ds[:, rows].transpose(1, 2), q[:, rows].float(),
                      "ds_q")
    for j0 in range(0, T, dq_keys):
        keys = slice(j0, j0 + dq_keys)
        dq += product(ds[:, :, keys], k[:, keys].float(), "ds_k")
    return tuple(g.to(torch.bfloat16) for g in (dq * scale, dk * scale, dv))


def _bwd_emulation_case(B, S, T, H, hd, causal, window, q_offset):
    """Seeded bf16 inputs folded to (BH, L, hd), the bf16 forward output
    of the plain version, and the float32 plain gradient on them."""
    rng = np.random.default_rng(S + T + hd)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (B * H, L, hd)).astype(np.float32)).to(torch.bfloat16)
        for L in (S, T, T, S))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    o = flash_mod.flash_attention_plain(
        *(x.unsqueeze(1) for x in (q, k, v)), **kw)[:, 0]
    want = flash_mod.flash_attention_bwd_plain(
        *(x.float().unsqueeze(1) for x in (q, k, v, o, do)), **kw)
    return (q, k, v, o, do), kw, [w[:, 0] for w in want]


def _over_bf16_limit(got, want):
    """Elements outside the card's bf16 limit, 2^-6 |want| + 1e-4."""
    return int(((got.float() - want).abs() >
                1e-4 + 2.0 ** -6 * want.abs()).sum())


@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset", BWD_EMULATED)
def test_bf16_gradient_with_split_products_stays_in_the_limit(
        B, S, T, H, hd, causal, window, q_offset):
    """The tensor-core gradient's arithmetic, each of P^T dO, dS^T Q and
    dS K with its A operand split in two, puts no element of dq, dk or
    dv outside the bf16 limit the card's checks hold the kernel to
    (chip_smoke.py ``bf16_over``) around the float32 plain version."""
    ins, kw, want = _bwd_emulation_case(B, S, T, H, hd, causal, window,
                                        q_offset)
    got = _emulate_bf16_kernel_bwd(*ins, **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g.float()).all()
        assert _over_bf16_limit(g, w) == 0
        assert (g.float() - w).abs().max() <= 2.0 ** -5


@pytest.mark.parametrize("name,grad", [("p_do", 2), ("ds_q", 1),
                                       ("ds_k", 0)])
@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset", BWD_EMULATED)
def test_bf16_gradient_needs_each_product_split(
        B, S, T, H, hd, causal, window, q_offset, name, grad):
    """Why the kernel splits all three: with one product's A operand
    rounded once to bf16 (the others split), the gradient it feeds (dv
    for P^T dO, dk for dS^T Q, dq for dS K) has hundreds to thousands of
    elements outside the bf16 limit (1.1-3.4% of them at these shapes),
    while the other two gradients stay inside: no product may drop its
    split. With all three split the largest error is ~0.24 of the limit
    (the bf16 rounding of the gradients)."""
    ins, kw, want = _bwd_emulation_case(B, S, T, H, hd, causal, window,
                                        q_offset)
    got = _emulate_bf16_kernel_bwd(
        *ins, **kw, split=tuple(n for n in BWD_SPLIT if n != name))
    over = [_over_bf16_limit(g, w) for g, w in zip(got, want)]
    assert over[grad] > 0.005 * want[grad].numel()
    assert [o for i, o in enumerate(over) if i != grad] == [0, 0]


# the float32 route (csrc/flash_attention.cu, csrc/flash_attention_bwd.cu,
# csrc/tf32x3.cuh): (B, S, T, H, hd, causal, window, q_offset) of hubert's
# bidirectional head of 80, the widest head (16-key tiles), a window, a
# query offset with S != T, S != T not causal, and a head dim the kernels
# zero-pad (to 32)
TF32_CASES = [(1, 128, 128, 2, 80, False, 0, 0),
              (1, 96, 96, 2, 256, True, 0, 0),
              (1, 160, 160, 2, 80, True, 48, 0),
              (2, 37, 120, 3, 64, True, 0, 83),
              (1, 64, 96, 2, 80, False, 0, 0),
              (1, 40, 40, 2, 20, True, 0, 0)]
# the head dims the float32 kernels are instantiated at (a head dim runs at
# the first that holds it)
TF32_WIDTHS = (16, 32, 64, 80, 96, 128, 256)


def _tf32(x, rounded=True):
    """``x`` (float32) as TF32, by bit operations: rounded as the kernels
    round hi (add half a TF32 ulp, then clear the 13 low mantissa bits:
    nearest, ties away from zero), or with the low bits cleared alone, as
    the tensor core reads lo."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + (0x1000 if rounded else 0)) & -0x2000).view(
        torch.float32)


def _mm_tf32x3(a, b, terms=3):
    """``a @ b`` ((..., M, K) x (..., K, N), float32) as the kernels'
    mma.sync m16n8k8 products: each operand split into hi = tf32(x)
    and lo = x - hi, which the tensor core reads truncated to TF32; per
    k-step of 8, lo_a hi_b, hi_a lo_b and hi_a hi_b (each exact in the
    tensor core: float64 here), added to the float32 accumulator in that
    order. ``terms=1`` keeps hi_a hi_b alone (plain TF32)."""
    ahi, bhi = _tf32(a), _tf32(b)
    pairs = [(ahi, bhi)]
    if terms == 3:
        pairs = [(_tf32(a - ahi, False), bhi), (ahi, _tf32(b - bhi, False)),
                 (ahi, bhi)]
    out = torch.zeros((*a.shape[:-1], b.shape[-1]))
    for k0 in range(0, a.shape[-1], 8):
        for x, y in pairs:
            out = out + (x[..., k0:k0 + 8].double()
                         @ y[..., k0:k0 + 8, :].double()).float()
    return out


def _emulate_tf32x3(q, k, v, do, causal, window, q_offset, terms=3):
    """The float32 kernels' arithmetic on (BH, L, hd) float32 inputs, in
    plain torch. Forward: the head dim zero-padded to the kernels' width
    (``TF32_WIDTHS``), q scaled before the product, an online softmax
    over key tiles of 32 (16 at 256) with S = q K^T and P V as split
    TF32 (``_mm_tf32x3``), o = acc / max(l, 1e-30) and the base-2
    log-sum-exp (m + log(max(l, 1e-30))) * log2 e. Gradient (given
    ``do``): D = rowsum(dO o), S and dP as split TF32, P = exp2(S log2 e
    - lse) under the mask, dS = P (dP - D), then dq = scale dS K, dk =
    dS^T (q scale), dv = P^T dO as split TF32, their k-steps over 8 keys
    or 8 query rows in order. Up to float32 summation order inside an
    mma this is what the kernels compute. Returns (o, lse) or, with
    ``do``, (o, lse, (dq, dk, dv))."""
    BH, S, hd = q.shape
    T = k.shape[1]
    hdp = next(w for w in TF32_WIDTHS if hd <= w)
    pad = (lambda x: torch.nn.functional.pad(x, (0, hdp - hd)))
    scale = 1.0 / hd ** 0.5
    qs, kp, vp = pad(q) * scale, pad(k), pad(v)
    bk = 32 if hdp <= 128 else 16
    vis = flash_mod._visible(torch.arange(S) + q_offset, torch.arange(T),
                             T, causal, window)[None]
    m = torch.full((BH, S), flash_mod.NEG_INF)
    l = torch.zeros((BH, S))
    acc = torch.zeros((BH, S, hdp))
    for j0 in range(0, T, bk):
        keys = slice(j0, j0 + bk)
        s = torch.where(vis[..., keys], _mm_tf32x3(
            qs, kp[:, keys].transpose(1, 2), terms), flash_mod.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mm_tf32x3(p, vp[:, keys], terms)
        m = m_new
    den = torch.clamp(l, min=1e-30)
    o = (acc / den[..., None])[..., :hd]
    lse = (m + torch.log(den)) * flash_mod.LOG2E
    if do is None:
        return o, lse
    dd = (do * o).sum(-1)
    s = _mm_tf32x3(qs, kp.transpose(1, 2), terms)
    dp = _mm_tf32x3(pad(do), vp.transpose(1, 2), terms)
    x = (s.double() * flash_mod.LOG2E - lse[..., None].double()).float()
    p = torch.where(vis, torch.exp2(x), 0.0)
    ds = p * (dp - dd[..., None])
    dq = _mm_tf32x3(ds, kp, terms) * scale
    dk = _mm_tf32x3(ds.transpose(1, 2), qs, terms)
    dv = _mm_tf32x3(p.transpose(1, 2), pad(do), terms)
    return o, lse, tuple(g[..., :hd] for g in (dq, dk, dv))


def _tf32_case(B, S, T, H, hd, seed):
    """Seeded (B, L, H, hd) float32 q, k, v and dO as numpy arrays."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, L, H, hd)).astype(np.float32)
            for L in (S, T, T, S)]


@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset", TF32_CASES)
def test_tf32x3_forward_matches_jax(B, S, T, H, hd, causal, window,
                                   q_offset):
    """The float32 forward kernel's arithmetic (split TF32) against the
    JAX package on the same seeded inputs at the float32 bound, atol
    2e-5: against ``blockwise_attention`` always, and against the Pallas
    kernel (interpret mode, 32-row blocks, through the reference's
    ``flash_mha`` padding) where that pads correctly (no query offset;
    causal, or T a whole number of blocks). With one TF32 product (no
    split) the error is well above the bound: the split is needed."""
    q, k, v, _ = _tf32_case(B, S, T, H, hd, S + T + hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    ins = [torch.from_numpy(_fold(a)) for a in (q, k, v)]
    got, _ = _emulate_tf32x3(*ins, None, **kw)
    want = _fold(np.asarray(blockwise_attention(
        *(jnp.asarray(a) for a in (q, k, v)), **kw)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)
    if q_offset == 0 and (causal or T % 32 == 0):
        pallas = jax_flash_mha(*(jnp.asarray(a) for a in (q, k, v)),
                               causal=causal, window=window, block_q=32,
                               block_k=32)
        np.testing.assert_allclose(got.numpy(), _fold(np.asarray(pallas)),
                                   rtol=0, atol=2e-5)
    once, _ = _emulate_tf32x3(*ins, None, **kw, terms=1)
    assert np.abs(once.numpy() - want).max() > 1e-4


def test_tf32x3_forward_matches_pallas_kernel_unpadded():
    """The Pallas ``flash_attention`` itself (interpret mode, no wrapper)
    on a (BH, S, hd) fold whose S and T are whole 32-row blocks, at
    hubert's head of 80, not causal: the emulated float32 kernel within
    2e-5."""
    q, k, v, _ = _tf32_case(1, 128, 128, 2, 80, 3)
    folded = [_fold(a) for a in (q, k, v)]
    want = np.asarray(jax_pallas_flash(*(jnp.asarray(a) for a in folded),
                                       causal=False, block_q=32,
                                       block_k=32, interpret=True))
    got, _ = _emulate_tf32x3(*(torch.from_numpy(a) for a in folded), None,
                             causal=False, window=0, q_offset=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset", TF32_CASES)
def test_tf32x3_gradient_matches_jax(B, S, T, H, hd, causal, window,
                                    q_offset):
    """The float32 gradient kernels' arithmetic (split TF32, reading the
    emulated forward's output and log-sum-exp) against ``jax.vjp`` of
    the JAX package's ``blockwise_attention`` on the same seeded inputs:
    each gradient within 1e-4 of its largest entry (chip_smoke.py's
    FLASH_BWD_REL)."""
    q, k, v, do = _tf32_case(B, S, T, H, hd, S + T + hd + 1)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, vjp = jax.vjp(lambda a, b, c: blockwise_attention(a, b, c, **kw),
                     *(jnp.asarray(a) for a in (q, k, v)))
    want = [_fold(np.asarray(g)) for g in vjp(jnp.asarray(do))]
    _, _, got = _emulate_tf32x3(*(torch.from_numpy(_fold(a))
                                  for a in (q, k, v, do)), **kw)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset",
                         TF32_CASES[:4])
def test_float32_lse_on_cpu_is_the_kernels_convention(
        B, S, T, H, hd, causal, window, q_offset):
    """``flash_attention(..., return_lse=True)`` on float32 CPU tensors
    (the plain version) returns what the float32 kernel stores and its
    gradient reads: (B, H, S) float32, base 2, (m + log(max(l, 1e-30)))
    * log2 e of the scaled scores; the emulated kernel's lse agrees
    within 2e-5."""
    q, k, v, _ = (torch.from_numpy(a).transpose(1, 2) for a in
                  _tf32_case(B, S, T, H, hd, S + hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    _, lse = flash_mod.flash_attention(q, k, v, return_lse=True, **kw)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    _, emulated = _emulate_tf32x3(*(x.reshape(B * H, -1, hd)
                                    for x in (q, k, v)), None, **kw)
    np.testing.assert_allclose(lse.reshape(B * H, S).numpy(),
                               emulated.numpy(), rtol=0, atol=2e-5)


def test_flash_plain_lse_matches_logsumexp():
    """``flash_attention_plain``'s log-sum-exp in base 2 (what the bf16
    kernel stores for the gradient) against ``jax.nn.logsumexp`` of the
    masked scaled scores times log2 e, across 512-row chunks, a window
    and a query offset; the output with and without it is the same."""
    B, H, S, hd, window, q_offset = 1, 2, 700, 16, 300, 40
    T = S + q_offset
    rng = np.random.default_rng(9)
    q, k, v = (rng.standard_normal((B, H, L, hd)).astype(np.float32)
               for L in (S, T, T))
    kw = dict(causal=True, window=window, q_offset=q_offset)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out, lse = flash_mod.flash_attention_plain(tq, tk, tv, return_lse=True,
                                               **kw)
    assert torch.equal(out, flash_mod.flash_attention_plain(tq, tk, tv,
                                                            **kw))
    pos = np.arange(S)[:, None] + q_offset
    j = np.arange(T)[None, :]
    vis = (pos >= j) & (pos - j < window)
    s = jnp.einsum("bhsd,bhtd->bhst", q, k) / np.sqrt(hd)
    want = jax.nn.logsumexp(jnp.where(vis, s, -jnp.inf), axis=-1) * np.log2(
        np.e)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), rtol=0,
                               atol=2e-5)


def test_flash_wrappers_on_cpu_return_lse_and_take_it():
    """On CPU tensors ``flash_attention(..., return_lse=True)`` is the
    plain version's pair and launches nothing; ``flash_attention_bwd``
    takes an lse and returns the plain gradient (which computes its
    own), without a launch or a route."""
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2) for a in
                   _flash_inputs(3, 1, 40, 40, 2, 16) + _flash_inputs(
                       4, 1, 40, 40, 2, 16)[:1])
    launches = flash_mod.flash_attention.launches
    out, lse = flash_mod.flash_attention(q, k, v, return_lse=True)
    want_out, want_lse = flash_mod.flash_attention_plain(q, k, v,
                                                         return_lse=True)
    assert torch.equal(out, want_out) and torch.equal(lse, want_lse)
    assert flash_mod.flash_attention.launches == launches
    bwd = flash_mod.flash_attention_bwd
    before, routes = bwd.launches, dict(bwd.routes)
    got = bwd(q, k, v, out, do, lse=lse)
    want = flash_mod.flash_attention_bwd_plain(q, k, v, out, do)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bwd.launches == before and bwd.routes == routes


def test_every_signature_is_a_c_entry_of_its_source():
    """Each launch function ``build.SIGNATURES`` declares is an ``extern
    "C"`` entry of its library's source with as many parameters as
    argtypes: the gradient has one entry a route
    (``flash_attention_bwd_launch`` for float32 as split TF32,
    ``flash_attention_bwd_wgmma_launch`` for bf16), so the
    route the wrapper records is the entry it called."""
    assert set(build.SIGNATURES["flash_attention_bwd"]) == {
        "flash_attention_bwd_launch", "flash_attention_bwd_wgmma_launch"}
    for name, fns in build.SIGNATURES.items():
        src = (build.CSRC / f"{name}.cu").read_text()
        for fn, argtypes in fns.items():
            m = re.search(r'extern "C" int ' + fn + r'\(([^)]*)\)', src)
            assert m is not None, fn
            assert len(m.group(1).split(",")) == len(argtypes), fn


def test_bwd_route_by_type_and_head_dim():
    """The gradient's route is chosen by type alone, at every head dim up
    to 256: bfloat16 on the tensor cores in bf16, float32 on the tensor
    cores as split TF32; the forward's route is the same."""
    route = flash_mod.bwd_route
    assert route(torch.bfloat16, 128) == "wgmma"
    assert route(torch.bfloat16, 8) == "wgmma"
    assert route(torch.bfloat16, 129) == "wgmma"
    assert route(torch.bfloat16, 256) == "wgmma"
    assert route(torch.float32, 64) == "tf32x3"
    assert route(torch.float32, 256) == "tf32x3"
    assert flash_mod.route(torch.float32) == "tf32x3"
    assert set(flash_mod.flash_attention.routes) == set(
        flash_mod.flash_attention_bwd.routes) == {"wgmma", "tf32x3"}
    assert [flash_mod.lse_rows(S) for S in (1, 128, 129, 4096)] == [
        128, 128, 256, 4096]


def test_check_lse_takes_the_forward_view_only():
    """The tensor-core route reads the lse as whole aligned rows of
    ``lse_rows(S)``: the forward's (B, H, S) view at the base of such a
    buffer passes; another layout, an offset view, a wrong shape or type
    raises before any launch."""
    B, H, S = 2, 3, 130
    rows = flash_mod.lse_rows(S)
    buf = torch.randn((B, H, rows))
    flash_mod._check_lse(buf[..., :S], B, H, S)
    for bad in (torch.randn((B, H, S)), buf[:, :, 1:S + 1],
                buf[..., :S].double(), buf[..., :S - 1]):
        with pytest.raises(ValueError):
            flash_mod._check_lse(bad, B, H, S)


def test_tma_ready_pads_rows_tma_cannot_read():
    """A gradient view TMA cannot read (here 14-byte rows of hd 7) is
    copied into 16-byte rows and handed on as a view of the same
    values; a view TMA reads goes through untouched."""
    t = torch.randn((1, 2, 16, 7)).to(torch.bfloat16)
    assert flash_mod.tma_alignment_error(t) == "sequence stride"
    got = flash_mod._tma_ready(t)
    assert flash_mod.tma_alignment_error(got) is None
    assert got.shape == t.shape and torch.equal(got, t)
    ok = torch.randn((1, 2, 16, 8)).to(torch.bfloat16)
    assert flash_mod._tma_ready(ok) is ok


def test_tma_alignment_error_names_what_the_bf16_route_cannot_take():
    """The bfloat16 kernel's TMA loads need a 16-byte-aligned base and
    16-byte batch, head and sequence strides (dims of length 1 aside):
    the serving layout, the (B, H, S, hd) view of a contiguous
    (B, S, H, hd) tensor, passes; the wrapper raises on the rest."""
    err = flash_mod.tma_alignment_error

    def view(B, S, H, hd):
        return torch.zeros((B, S, H, hd), dtype=torch.bfloat16
                           ).transpose(1, 2)

    assert err(view(2, 300, 32, 128)) is None
    assert err(view(1, 1, 1, 4)) is None        # no stride is used
    assert err(view(1, 16, 2, 4)) == "head stride"
    assert err(view(1, 16, 1, 4)) == "sequence stride"
    assert err(torch.zeros((1, 2, 16, 4), dtype=torch.bfloat16)
               ) == "sequence stride"
    buf = torch.zeros(1 + 2 * 16 * 8, dtype=torch.bfloat16)
    assert err(buf[1:].view(1, 2, 16, 8)) == "base address"
    assert err(torch.zeros((3, 2, 16, 8), dtype=torch.bfloat16)) is None
