"""Tests of the port that need an NVIDIA GPU: the hand-written Hopper
kernels against their plain versions, the wrappers' input checks, the
accuracy model's 'cuda' backend, the host accuracy oracle through the
bit-serial GEMM kernel, one scenario on the card, and the LM serving
engine on the card (through the flash attention kernel) against the
CPU, the Table 3 engine's draws and stochastic ranking, and the
co-design service's lane batching on the card (a two-request bucket
against the solo runs, its default device). They
carry the ``gpu`` marker and skip without a CUDA device. This file
imports neither JAX nor the reference package, so it also runs where
JAX is not installed:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch import random as jr
from repro_torch.core import get_space, get_workload_set, pack
from repro_torch.core.baselines import stochastic_rank
from repro_torch.core.nonideal import accuracy_proxy_host, make_accuracy_model
from repro_torch.core.sampling import uniform_genomes
from repro_torch.experiments import get_scenario, run_scenario
from repro_torch.kernels.imc_fused import (imc_fused_gemm,
                                           imc_fused_gemm_keyed,
                                           imc_fused_keyed_plain,
                                           imc_fused_plain, normal_of_bits)
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.imc_matmul import imc_matmul, imc_matmul_plain
from repro_torch.kernels.ops import flash_mha, imc_gemm
from repro_torch.models import init_params
from repro_torch.serve import LMRequest, ServeEngine

pytestmark = pytest.mark.gpu

SHAPES = [
    (3, 4, 256, 8, 64, (64.0, 128.0, 256.0)),
    (2, 2, 96, 4, 32, (32.0, 64.0, 96.0)),       # odd tiling
    (2, 3, 200, 5, 64, (64.0, 128.0)),           # ragged K
    (1, 2, 48, 4, 16, (48.0,)),                  # single group
    (120, 32, 256, 32, 64, (64.0, 128.0, 256.0, 512.0)),  # main path
    (5, 40, 100, 70, 32, (32.0, 96.0)),          # ragged B and N tiles
    (3, 70, 300, 40, 16, (16.0, 48.0, 96.0)),    # 3 rounds, 3 row groups
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    return torch.device("cuda")


def _inputs(seed, P, B, K, N, rows, dev):
    rng = np.random.default_rng(seed)
    arrs = (rng.integers(0, 256, (B, K)).astype(np.int32),
            rng.uniform(-1.0, 1.0, (K, N)).astype(np.float32),
            rng.standard_normal((P, K, N)).astype(np.float32),
            rng.standard_normal((P, K, N)).astype(np.float32),
            rng.integers(0, len(rows), (P,)).astype(np.int32),
            np.asarray(rows, np.float32))
    return [torch.from_numpy(a).to(dev) for a in arrs]


@pytest.mark.parametrize("P,B,K,N,sub,rows", SHAPES)
def test_kernel_matches_plain(cuda, P, B, K, N, sub, rows):
    """The kernel sums the plain version's terms in its order, skipping
    only zeros: the bound of tests/test_kernels.py holds, and they agree
    bit for bit."""
    args = _inputs(P + K, P, B, K, N, rows, cuda)
    before = imc_fused_gemm.launches
    got = imc_fused_gemm(*args, sub=sub)
    assert imc_fused_gemm.launches == before + 1
    want = imc_fused_plain(*args, sub=sub)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    assert torch.equal(got, want)
    cpu = imc_fused_plain(*[a.cpu() for a in args], sub=sub)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-4)


# the keyed kernel: the accuracy model's main shape at three population
# sizes, the families and the ragged B/N shape of SHAPES, and 19 sub-tiles
# (3 rounds of a cluster of 8) over 3 groups of 32 batch rows
KEYED_SHAPES = [(P, 32, 256, 32, 64, (64.0, 128.0, 256.0, 512.0))
                for P in (24, 120, 480)] + SHAPES[:4] + SHAPES[5:]


def _keyed_inputs(seed, P, B, K, N, rows, dev):
    rng = np.random.default_rng(seed)
    x_q, w, _, _, ri, rt = _inputs(seed, P, B, K, N, rows, dev)
    flat = torch.from_numpy(rng.integers(0, 2 ** 31, (P,))).to(dev)
    return x_q, w, jr.PRNGKey(int(rng.integers(0, 2 ** 31)), dev), flat, \
        ri, rt


@pytest.mark.parametrize("P,B,K,N,sub,rows", KEYED_SHAPES)
def test_keyed_kernel_equals_plain(cuda, P, B, K, N, sub, rows):
    """The keyed kernel draws the noise with random.py's threefry and
    normal bit for bit and sums as the plain version does: raw and
    z_out torch.equal to imc_fused_keyed_plain on the card (one launch),
    and raw within the test_kernels.py bound of the CPU plain route."""
    args = _keyed_inputs(P + K + B, P, B, K, N, rows, cuda)
    before = imc_fused_gemm_keyed.launches
    raw, z = imc_fused_gemm_keyed(*args, sub=sub)
    assert imc_fused_gemm_keyed.launches == before + 1
    want_raw, want_z = imc_fused_keyed_plain(*args, sub=sub)
    torch.cuda.synchronize()
    assert raw.shape == z.shape == (P, B, N)
    assert torch.equal(z, want_z)
    assert torch.equal(raw, want_raw)
    cpu_raw, _ = imc_fused_keyed_plain(*[a.cpu() for a in args], sub=sub)
    torch.testing.assert_close(raw.cpu(), cpu_raw, rtol=1e-5, atol=1e-4)


def test_keyed_wrapper_rejects_bad_inputs(cuda):
    x_q, w, key, flat, ri, rt = _keyed_inputs(0, 3, 4, 64, 8, (64.0,), cuda)
    with pytest.raises(TypeError):
        imc_fused_gemm_keyed(x_q, w, key.int(), flat, ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm_keyed(x_q, w, key.repeat(2), flat, ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm_keyed(x_q, w, key[None], flat, ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm_keyed(x_q, w, key, flat[:2], ri, rt, sub=64)
    with pytest.raises(TypeError):
        imc_fused_gemm_keyed(x_q, w, key, flat.int(), ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm_keyed(x_q, w, key.cpu(), flat, ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm_keyed(x_q, w, key, flat.cpu(), ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm_keyed(x_q, w.cpu(), key, flat, ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm_keyed(x_q, w[:32], key, flat, ri, rt, sub=64)
    before = imc_fused_gemm_keyed.launches
    imc_fused_gemm_keyed(x_q, w, key, flat, ri, rt, sub=64)
    assert imc_fused_gemm_keyed.launches == before + 1


def test_normal_of_bits_equals_plain_on_every_uniform(cuda):
    """The device draw's transform (threefry.cuh) against random.py's on
    the card on all 2^23 uniforms it can make: bit for bit, log1pf and
    torch.log1p included."""
    bits = torch.arange(1 << 23, dtype=torch.int64, device=cuda) << 9
    got = normal_of_bits(bits)
    want = normal_of_bits(bits.cpu()).to(cuda)
    assert torch.equal(got, jr.normal_of_bits(bits))
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=4 * 2 ** -23, atol=1e-30)


def test_wrapper_rejects_bad_inputs(cuda):
    x_q, w, ep, en, ri, rt = _inputs(0, 2, 3, 64, 4, (64.0,), cuda)
    with pytest.raises(TypeError):
        imc_fused_gemm(x_q.long(), w, ep, en, ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm(x_q, w[:32], ep, en, ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm(x_q, w.t(), ep, en, ri, rt, sub=64)
    with pytest.raises(ValueError):
        imc_fused_gemm(x_q, w.cpu(), ep, en, ri, rt, sub=64)


def test_accuracy_model_cuda_matches_ref_and_cpu(cuda):
    space = get_space("rram")
    wa = pack(get_workload_set(("resnet18", "vgg16", "alexnet",
                                "mobilenetv3")))
    cards = torch.as_tensor(space.cardinalities, dtype=torch.float32)
    g = uniform_genomes(jr.PRNGKey(3)[None], cards, 40)[0]
    before = imc_fused_gemm_keyed.launches
    acc = make_accuracy_model(space, wa, backend="auto", device=cuda)
    assert acc.backend == "cuda"
    got = acc(g.to(cuda))
    assert imc_fused_gemm_keyed.launches == before + 1
    ref = make_accuracy_model(space, wa, backend="ref", device=cuda)(
        g.to(cuda))
    cpu = make_accuracy_model(space, wa, backend="jnp", device="cpu")(g)
    assert torch.equal(got, ref)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=0.0)


def test_rram_accuracy_smoke_on_card(cuda, tmp_path):
    sc = get_scenario("rram_accuracy")
    sc = dataclasses.replace(sc, budget=sc.smoke_budget)
    before = imc_fused_gemm_keyed.launches
    res = run_scenario(sc, out_dir=str(tmp_path), device=cuda)
    assert imc_fused_gemm_keyed.launches > before
    assert res["backend"] == "cuda" and res["device"]["type"] == "cuda"
    assert math.isfinite(res["best_score"]) and res["best_score"] < 1e29
    cpu = run_scenario(dataclasses.replace(sc, backend="ref"),
                       write=False, device="cpu")
    assert cpu["generalized"]["design"] == res["generalized"]["design"]
    assert math.isclose(cpu["best_score"], res["best_score"], rel_tol=1e-4)


MATMUL_SHAPES = [  # (M, K, N, R, adc_bits)
    (8, 128, 16, 128, 8), (16, 256, 32, 128, 8), (32, 512, 64, 256, 8),
    (8, 384, 8, 128, 8), (8, 512, 8, 512, 8),      # tests/test_kernels.py
    (8, 256, 16, 128, 4), (8, 256, 16, 128, 12),   # ADC widths
    (32, 512, 32, 512, 8),                         # host oracle, K padded
    (5, 320, 70, 64, 8),                           # ragged M and N tiles
    (16, 2560, 12288, 256, 8),                     # qwen3-4b QKV projection
]


def _matmul_inputs(seed, M, K, N, dev):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (M, K)).astype(np.int32))
            .to(dev),
            torch.from_numpy((rng.standard_normal((K, N)) * 0.25)
                             .astype(np.float32)).to(dev))


@pytest.mark.parametrize("M,K,N,R,adc_bits", MATMUL_SHAPES)
def test_imc_matmul_kernel_matches_plain_bitwise(cuda, M, K, N, R, adc_bits):
    """Both add the R terms of a bit-plane sum in k order and shift-
    accumulate bits within a tile, then tiles: bit for bit equal, on the
    card and against the CPU plain version."""
    x_q, w = _matmul_inputs(M + K + N, M, K, N, cuda)
    before = imc_matmul.launches
    got = imc_matmul(x_q, w, xbar_rows=R, adc_bits=adc_bits)
    assert imc_matmul.launches == before + 1
    want = imc_matmul_plain(x_q, w, xbar_rows=R, adc_bits=adc_bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if M * N <= 4096:
        cpu = imc_matmul_plain(x_q.cpu(), w.cpu(), xbar_rows=R,
                               adc_bits=adc_bits)
        assert torch.equal(got.cpu(), cpu)


MATMUL_ORDER_SHAPES = [  # (M, K, N, R, adc_bits, w_scale)
    # w_scale=0.7: the ADC step is not a power of two, so a change in the
    # order the tiles are combined would change bits; 40 and 5 tiles, the
    # wide variant (the projection) and the narrow one
    (16, 2560, 12288, 64, 8, 0.7), (16, 2560, 12288, 64, 12, 0.7),
    (16, 2560, 12288, 512, 8, 0.7), (16, 2560, 12288, 512, 12, 0.7),
    (4, 2560, 64, 64, 8, 0.7), (4, 2560, 64, 64, 12, 0.7),
    (4, 2560, 64, 512, 12, 0.7),
    # M and N off the 16-row, 128- and 32-column tiles and off whole
    # float4s (the 4-byte copy route); 11 tiles in rounds of 6 and 5
    (20, 704, 70, 64, 8, 0.7), (21, 2560, 12290, 256, 12, 0.7),
    (37, 1280, 1001, 128, 12, 0.7),
    # R not a multiple of the 32-row chunks, and below one chunk
    (8, 300, 40, 100, 8, 0.7), (3, 40, 5, 8, 6, 0.7),
    # M=256 (a whole seq=256 prefill's rows)
    (256, 2560, 2048, 128, 8, 0.7), (256, 2560, 12288, 512, 8, 1.0),
]


@pytest.mark.parametrize("M,K,N,R,adc_bits,w_scale", MATMUL_ORDER_SHAPES)
def test_imc_matmul_kernel_bitwise_at_any_w_scale(cuda, M, K, N, R, adc_bits,
                                                  w_scale):
    """The kernel spreads the crossbar tiles over a cluster and combines
    them in tile order: bit for bit the plain version's result where the
    ADC step is not a power of two, one launch a call."""
    x_q, w = _matmul_inputs(M * N + K, M, K, N, cuda)
    before = imc_matmul.launches
    got = imc_matmul(x_q, w, xbar_rows=R, adc_bits=adc_bits, w_scale=w_scale)
    assert imc_matmul.launches == before + 1
    want = imc_matmul_plain(x_q, w, xbar_rows=R, adc_bits=adc_bits,
                            w_scale=w_scale)
    torch.cuda.synchronize()
    assert got.shape == (M, N) and torch.equal(got, want)
    if M * N <= 4096:
        cpu = imc_matmul_plain(x_q.cpu(), w.cpu(), xbar_rows=R,
                               adc_bits=adc_bits, w_scale=w_scale)
        assert torch.equal(got.cpu(), cpu)


def test_imc_matmul_misaligned_weights(cuda):
    """Contiguous weights that do not start on a 16-byte boundary take
    the 4-byte copy route and give the same bits."""
    x_q, w = _matmul_inputs(3, 16, 256, 64, cuda)
    wm = torch.empty(w.numel() + 1, device=cuda)[1:].view_as(w)
    wm.copy_(w)
    assert wm.is_contiguous() and wm.data_ptr() % 16
    got = imc_matmul(x_q, wm, xbar_rows=64, w_scale=0.7)
    assert torch.equal(got, imc_matmul_plain(x_q, w, xbar_rows=64,
                                             w_scale=0.7))


def test_imc_matmul_wrapper_rejects_bad_inputs(cuda):
    x_q, w = _matmul_inputs(0, 4, 128, 8, cuda)
    with pytest.raises(TypeError):
        imc_matmul(x_q.long(), w, xbar_rows=64)
    with pytest.raises(TypeError):
        imc_matmul(x_q, w.double(), xbar_rows=64)
    with pytest.raises(ValueError):
        imc_matmul(x_q, w[:64], xbar_rows=64)       # K does not chain
    with pytest.raises(ValueError):
        imc_matmul(x_q, w, xbar_rows=96)            # K % R != 0
    with pytest.raises(ValueError):
        imc_matmul(x_q, w.t().contiguous().t(), xbar_rows=64)
    with pytest.raises(ValueError):
        imc_matmul(x_q, w.cpu(), xbar_rows=64)
    with pytest.raises(ValueError):
        imc_matmul(x_q[None], w, xbar_rows=64)
    # ops.imc_gemm pads a ragged K and launches once
    before = imc_matmul.launches
    y = imc_gemm(x_q[:, :100].contiguous(), w[:100].contiguous(),
                 xbar_rows=64)
    assert imc_matmul.launches == before + 1 and y.shape == (4, 8)


def test_accuracy_proxy_host_kernel_matches_model(cuda):
    """The host oracle through the imc_matmul kernel (one launch per
    genome) against the batched imc_fused model, at the atol 5e-3 of
    tests/test_nonideal.py, and against its own plain route."""
    space = get_space("rram")
    wa = pack(get_workload_set(("resnet18", "vgg16", "alexnet",
                                "mobilenetv3")))
    cards = torch.as_tensor(space.cardinalities, dtype=torch.float32)
    g = uniform_genomes(jr.PRNGKey(5)[None], cards, 8)[0]
    before = imc_matmul.launches
    host = accuracy_proxy_host(space, g.numpy(), wa, use_kernel=True,
                               device=cuda)
    assert imc_matmul.launches == before + 8
    plain = accuracy_proxy_host(space, g.numpy(), wa, device=cuda)
    np.testing.assert_array_equal(host, plain)
    model = make_accuracy_model(space, wa, backend="cuda", device=cuda)(
        g.to(cuda)).cpu().numpy()
    np.testing.assert_allclose(host, model, atol=5e-3)


FLASH_SHAPES = [  # (B, S, T, H, hd, causal, window, q_offset, dtype)
    (2, 32, 32, 2, 16, True, 0, 0, torch.float32),   # tests/test_kernels.py
    (1, 64, 64, 4, 32, True, 0, 0, torch.float32),
    (2, 48, 48, 2, 16, False, 0, 0, torch.float32),
    (1, 64, 64, 2, 16, True, 16, 0, torch.float32),
    (1, 40, 40, 2, 16, True, 0, 0, torch.float32),
    (2, 32, 32, 2, 16, True, 0, 0, torch.bfloat16),
    (1, 40, 40, 2, 16, False, 0, 0, torch.float32),  # ragged, not causal
    (1, 300, 300, 4, 128, True, 0, 0, torch.bfloat16),  # serving head dim
    (1, 257, 257, 2, 128, True, 100, 0, torch.float32),  # window
    (2, 37, 120, 3, 64, True, 0, 83, torch.float32),     # q_offset
    (1, 70, 70, 2, 256, True, 0, 0, torch.float32),      # widest head
    (1, 33, 33, 2, 8, True, 0, 0, torch.float32),        # narrow head
    # bfloat16 on the tensor-core route: head dims 8..256 zero-padded to
    # 64, 128 or 256; S and T off the 128-row and 64/128-key tiles
    (1, 1, 1, 2, 128, True, 0, 0, torch.bfloat16),       # one row
    (1, 129, 129, 2, 64, True, 0, 0, torch.bfloat16),
    (1, 1000, 1000, 2, 128, True, 0, 0, torch.bfloat16),
    (1, 1000, 1000, 2, 128, True, 100, 0, torch.bfloat16),  # window
    (2, 37, 120, 3, 64, True, 0, 83, torch.bfloat16),    # q_offset, S != T
    (1, 129, 300, 2, 128, False, 0, 0, torch.bfloat16),  # ragged T
    (2, 129, 129, 3, 128, True, 0, 0, torch.bfloat16),   # B = 2, H = 3
    (1, 300, 300, 2, 256, True, 0, 0, torch.bfloat16),   # widest head
    (1, 33, 33, 2, 8, True, 0, 0, torch.bfloat16),       # narrow head
]


@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset,dt",
                         FLASH_SHAPES)
def test_flash_kernel_matches_plain(cuda, B, S, T, H, hd, causal, window,
                                    q_offset, dt):
    """``ops.flash_mha`` on the card (the kernel reads the transposed
    (B, H, S, hd) views through their strides) vs the plain version on
    the same inputs: atol 2e-5 in float32; in bfloat16 atol 2e-2 and
    every element within two bf16 steps of the plain value plus 1e-4."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S + T + hd)
    q, k, v = (torch.randn((B, L, H, hd), generator=gen, device=cuda
                           ).to(dt) for L in (S, T, T))
    before = flash_attention.launches
    got = flash_mha(q, k, v, causal=causal, window=window,
                    q_offset=q_offset)
    assert flash_attention.launches == before + 1
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 window=window, q_offset=q_offset
                                 ).transpose(1, 2)
    torch.cuda.synchronize()
    assert got.dtype == dt and got.shape == (B, S, H, hd)
    assert got.is_contiguous()
    atol = 2e-2 if dt == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0,
                               atol=atol)
    if dt == torch.bfloat16:  # and each element within two bf16 steps
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -6, atol=1e-4)
    # contiguous (B, H, S, hd) tensors: the same result as the views
    dense = flash_attention(*(x.transpose(1, 2).contiguous()
                              for x in (q, k, v)),
                            causal=causal, window=window, q_offset=q_offset)
    torch.testing.assert_close(dense.transpose(1, 2), got, rtol=0.0,
                               atol=0.0)


def test_flash_wrapper_rejects_bad_inputs(cuda):
    q = torch.randn((1, 2, 16, 8), device=cuda)
    with pytest.raises(TypeError):
        flash_attention(q, q.double(), q)
    with pytest.raises(TypeError):
        flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        flash_attention(q, q[..., :4], q)               # head dims differ
    with pytest.raises(ValueError):
        flash_attention(q, q.transpose(2, 3), q.transpose(2, 3))
    with pytest.raises(ValueError):
        flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        flash_attention(q[0], q[0], q[0])               # not 4-D
    big = torch.zeros((1, 1, 4, 260), device=cuda)
    with pytest.raises(ValueError):
        flash_attention(big, big, big)                  # head dim > 256


def test_flash_bf16_rejects_views_tma_cannot_take(cuda):
    """The bfloat16 route loads through TMA, which needs 16-byte-aligned
    bases and strides: a view without them raises (no fallback) before
    any launch; float32 takes the same view on the CUDA cores."""
    q = torch.randn((1, 2, 16, 4), device=cuda)  # 8-byte rows in bf16
    before = flash_attention.launches
    with pytest.raises(ValueError, match="sequence stride"):
        flash_attention(*(q.to(torch.bfloat16),) * 3)
    buf = torch.zeros(1 + 2 * 16 * 8, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(1, 2, 16, 8)  # base 2 bytes off
    with pytest.raises(ValueError, match="base address"):
        flash_attention(shifted, shifted, shifted)
    assert flash_attention.launches == before
    flash_attention(q, q, q)
    assert flash_attention.launches == before + 1


def test_flash_bf16_odd_head_dim_slice(cuda):
    """An odd head dim read from slices of wider tensors: TMA loads the 7
    columns through the 8-wide rows' strides and zero-fills the rest of
    the padded head dim; the output (contiguous, odd row stride) is
    stored one element at a time. Same limits as the shapes above."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(7)
    q, k, v = (torch.randn((1, 200, 2, 8), generator=gen, device=cuda
                           ).to(torch.bfloat16)[..., :7] for _ in range(3))
    got = flash_mha(q, k, v)
    want = flash_attention_plain(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2)).transpose(1, 2)
    torch.cuda.synchronize()
    assert got.shape == (1, 200, 2, 7)
    torch.testing.assert_close(got.float(), want.float(), rtol=0.0,
                               atol=2e-2)
    torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -6,
                               atol=1e-4)


def test_engine_on_card_matches_cpu(cuda):
    """The reduced qwen3-4b served on the card (the flash kernel in every
    prefill) and on the CPU (its plain version), the same weights and
    requests: the same greedy tokens, one kernel launch per layer per
    request."""
    cfg = get_config("qwen3_4b", reduced=True)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 17, 70)]
    outs = []
    for dev in ("cpu", cuda):
        eng = ServeEngine(model.to(dev), cfg, n_slots=2, max_len=96,
                          device=dev)
        for i, p in enumerate(prompts):
            eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=6))
        before = flash_attention.launches
        done = eng.run()
        outs.append({i: r.output for i, r in done.items()})
    assert flash_attention.launches - before == cfg.n_layers * len(prompts)
    assert outs[0] == outs[1]


def test_permutation_and_stochastic_rank_on_card_match_cpu(cuda):
    """The Table 3 engine's draws and SRES's ranking with CUDA tensors:
    ``permutation``/``choice`` and ``stochastic_rank`` (coin flips drawn
    on the card, ranked on the host) equal the CPU's bit for bit."""
    keys = torch.stack([jr.PRNGKey(s) for s in range(8)])
    for n in (1, 2, 23, 24, 300, 1700):
        want = jr.permutation(keys, n)
        got = jr.permutation(keys.to(cuda), n)
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
        assert torch.equal(jr.choice(keys.to(cuda), n, 1).cpu(),
                           jr.choice(keys, n, 1))
    rng = np.random.default_rng(0)
    for n in (2, 32):
        f = torch.from_numpy(rng.integers(0, 6, (8, n)).astype(np.float32))
        phi = torch.from_numpy(
            (rng.integers(0, 3, (8, n)) * 0.5).astype(np.float32))
        for p_f in (0.0, 0.45, 1.0):
            want = stochastic_rank(keys, f, phi, p_f)
            got = stochastic_rank(keys.to(cuda), f.to(cuda), phi.to(cuda),
                                  p_f)
            assert got.device.type == "cuda"
            assert torch.equal(got.cpu(), want)


def test_two_lane_bucket_matches_solo_runs_on_card(cuda, tmp_path):
    """``rram_accuracy`` at the smoke budget, seeds 0 and 1 submitted as
    two requests to the co-design service on the card: one bucket of 2
    main + 8 specific lanes through the keyed ``imc_fused`` kernel, each
    result.json equal (modulo timing fields) to the sequential card run
    of its seed alone."""
    from repro_torch.api import CodesignService, SearchRequest
    timing = {"wall_time_s", "search_wall_time_s", "sampling_time_s",
              "cached"}
    imc_fused_gemm_keyed.launches = 0
    svc = CodesignService(write=False, window_s=0.0, autostart=False)
    try:
        assert svc.device.type == "cuda"
        rids = [svc.submit(SearchRequest("rram_accuracy", seed=s,
                                         smoke=True)) for s in (0, 1)]
        svc.start()
        got = [svc.result(rid, timeout=600) for rid in rids]
    finally:
        svc.close()
    st = svc.stats()
    assert (st.batches, st.buckets, st.lanes_total) == (1, 1, 10)
    assert imc_fused_gemm_keyed.launches > 0
    sc = get_scenario("rram_accuracy")
    for s, r in zip((0, 1), got):
        want = run_scenario(dataclasses.replace(sc, seed=s,
                                                budget=sc.smoke_budget),
                            write=False)
        assert r.status == "completed"
        assert {k: v for k, v in r.result.items() if k not in timing} == \
            {k: v for k, v in want.items() if k not in timing}


def test_codesign_service_defaults_to_cuda(cuda):
    """The service's device defaults to the current CUDA device, and its
    worker thread runs there."""
    from repro_torch.api import CodesignService
    svc = CodesignService(write=False, autostart=False)
    assert svc.device == torch.device("cuda", torch.cuda.current_device())
    svc.close()


def test_launch_audit_on_card(cuda):
    """The launch audit of ``rram_smoke`` and ``rram_accuracy`` on the
    card: the same ids as on the CPU, every host-sync site it finds
    (dispatched syncs and ``set_sync_debug_mode`` copies) suppressed for
    the card in analysis/torch_suppressions.txt, the counts within the
    ``cuda`` block of analysis/torch_baseline.json, and the keyed
    ``imc_fused`` kernel launched by ``rram_accuracy``'s calls."""
    from pathlib import Path

    from repro_torch.analysis import apply_suppressions, load_suppressions
    from repro_torch.analysis import launch_audit as la

    root = str(Path(__file__).resolve().parents[1])
    imc_fused_gemm_keyed.launches = 0
    findings, report = la.run_launch_audit(
        root, cuda, names=["rram_smoke", "rram_accuracy"])
    assert imc_fused_gemm_keyed.launches > 0
    assert sorted(report["kernels"]) == [
        "rram_accuracy::kernel", "rram_accuracy::scorer",
        "rram_smoke::kernel", "rram_smoke::scorer"]
    sups, problems = load_suppressions(root)
    sups = [s for s in sups if s.applies("J", "cuda")]
    kept, suppressed, _ = apply_suppressions(findings, sups)
    assert problems == []
    errors = [f for f in kept if f.severity == "error"]
    assert errors == [], "\n".join(f.format() for f in errors)
    assert any(f.rule == "J001" for f in suppressed)
