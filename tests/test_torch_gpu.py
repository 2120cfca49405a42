"""Tests of the port that need an NVIDIA GPU: the hand-written Hopper
kernels against their plain versions, the wrappers' input checks, the
accuracy model's 'cuda' backend, the host accuracy oracle through the
bit-serial GEMM kernel, one scenario on the card, and the LM serving
engine on the card (through the flash attention kernel) against the
CPU, the Table 3 engine's draws and stochastic ranking, and the
co-design service's lane batching on the card (a two-request bucket
against the solo runs, its default device), the attention gradient
kernel against its plain version, a train step repeated bit for bit,
the decode attention and RG-LRU scan kernels and the scan's gradient
kernel against their plain versions, and the decode path (reduced recurrentgemma-9b, reduced
qwen3-4b on the int8 cache) on the card against the CPU, the mLSTM and
sLSTM scan kernels and their backward kernels against their plain
versions and reduced xlstm-350m served and trained on the card against
the CPU. They
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
from repro_torch.kernels.flash_attention import (bwd_route, flash_attention,
                                                 flash_attention_bwd,
                                                 flash_attention_bwd_plain,
                                                 flash_attention_plain,
                                                 lse_rows)
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
    # not causal, S != T: llama-3.2-vision's cross prefill (prompt queries
    # against 1600 image keys); hubert's bidirectional hd 80, padded into
    # the 128-wide bf16 instantiation, and on the float32 route that a
    # bf16 hubert fed float32 frames takes
    (1, 2048, 1600, 32, 128, False, 0, 0, torch.bfloat16),
    (1, 1024, 1024, 16, 80, False, 0, 0, torch.bfloat16),
    (2, 300, 300, 4, 80, False, 0, 0, torch.float32),
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


@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset,dt",
                         [x for x in FLASH_SHAPES if x[-1] == torch.bfloat16])
def test_flash_forward_lse_is_bitwise_and_matches_plain(
        cuda, B, S, T, H, hd, causal, window, q_offset, dt):
    """The bfloat16 forward asked for its log-sum-exp: the output is
    bit for bit the one without the store, and the lse (base 2, rows of
    ``lse_rows(S)``, 0 past S) is within 5e-5 of the plain version's
    ``(m + log l) * log2 e`` in float32 (the scores summed in another
    order, ex2/log2 on the card against exp/log: float32 rounding of
    values of a few units)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S + T + hd + 3)
    q, k, v = (torch.randn((B, H, L, hd), generator=gen, device=cuda
                           ).to(dt) for L in (S, T, T))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    before = flash_attention.launches
    plain_out = flash_attention(q, k, v, **kw)
    out, lse = flash_attention(q, k, v, return_lse=True, **kw)
    assert flash_attention.launches == before + 2
    _, want = flash_attention_plain(q.float(), k.float(), v.float(),
                                    return_lse=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    rows = lse_rows(S)
    assert lse.stride() == (H * rows, rows, 1)
    torch.testing.assert_close(lse, want, rtol=0.0, atol=5e-5)
    pad = torch.as_strided(lse, (B, H, rows - S), (H * rows, rows, 1),
                           lse.storage_offset() + S)
    assert torch.equal(pad, torch.zeros_like(pad))


@pytest.mark.parametrize("B,S,T,H,hd,causal,window,q_offset,dt",
                         FLASH_SHAPES)
def test_flash_backward_kernel_matches_plain(cuda, B, S, T, H, hd, causal,
                                             window, q_offset, dt):
    """The gradient through ``flash_mha`` on the card (the backward
    kernel, one launch, on the route its type and head dim pick: the
    tensor cores for bfloat16 with hd <= 128, the CUDA cores otherwise)
    vs ``flash_attention_bwd_plain`` in float32 on the same inputs:
    float32 within 1e-4 of each gradient's largest entry; bfloat16 every
    element within two bf16 steps of the plain value plus 1e-4. A second
    launch on the same inputs (the tensor-core route getting its
    log-sum-exp from one more forward launch) is bitwise equal (no
    atomics)."""
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S + T + hd + 1)
    q, k, v, do = (torch.randn((B, L, H, hd), generator=gen, device=cuda
                               ).to(dt) for L in (S, T, T, S))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = flash_mha(q, k, v, causal=causal, window=window,
                    q_offset=q_offset)
    route = "wgmma" if dt == torch.bfloat16 and hd <= 128 else "cuda_cores"
    assert bwd_route(dt, hd) == route
    before = flash_attention_bwd.launches
    routed = dict(flash_attention_bwd.routes)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert flash_attention_bwd.launches == before + 1
    assert flash_attention_bwd.routes == {
        r: n + (r == route) for r, n in routed.items()}
    views = [x.detach().transpose(1, 2) for x in (q, k, v, out)]
    want = flash_attention_bwd_plain(
        *(x.float() for x in views), do.transpose(1, 2).float(),
        causal=causal, window=window, q_offset=q_offset)
    again = flash_attention_bwd(*views, do.transpose(1, 2), causal=causal,
                                window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    for g, w, a, x in zip(got, want, again, (q, k, v)):
        assert g.dtype == dt and g.shape == x.shape
        w = w.transpose(1, 2)
        if dt == torch.float32:
            torch.testing.assert_close(g, w, rtol=0.0,
                                       atol=1e-4 * float(w.abs().max()))
        else:
            torch.testing.assert_close(g.float(), w, rtol=2.0 ** -6,
                                       atol=1e-4)
        assert torch.equal(a.transpose(1, 2), g)


def test_train_step_repeats_bitwise_on_card(cuda):
    """Two runs of three train steps from the same seed on the card: the
    same losses, parameters and AdamW moments bit for bit."""
    from repro_torch.data import SyntheticTokenPipeline
    from repro_torch.train.loop import init_train_state, make_train_step

    def run():
        cfg = get_config("qwen3_4b", reduced=True)
        gen = torch.Generator(device=cuda)
        gen.manual_seed(0)
        state = init_train_state(init_params(gen, cfg))
        step = make_train_step(cfg, warmup=1, total_steps=3)
        pipe = SyntheticTokenPipeline(cfg, 4, 32)
        losses = []
        for _ in range(3):
            state, m = step(state, pipe.next_batch())
            losses.append(m["loss"])
        return state, torch.stack(losses)
    a, la = run()
    b, lb = run()
    assert torch.equal(la, lb) and torch.isfinite(la).all()
    for (n, x), (_, y) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert torch.equal(x, y), n
    for n in a.opt.m:
        assert torch.equal(a.opt.m[n], b.opt.m[n]), n
        assert torch.equal(a.opt.v[n], b.opt.v[n]), n


def test_mesh_step_on_one_card_is_the_plain_step(cuda):
    """Reduced qwen3-4b, three steps through ``launch.train.setup`` with
    ``--model-shards 1`` (the state placed on the 1 x 1 host mesh, the
    step over it) and three of the plain step from the same seed: the
    same losses, parameters and AdamW moments bit for bit; every leaf a
    plain tensor on the card."""
    from repro_torch.launch import train as launch_train
    from repro_torch.parallel.sharding import is_placed
    from repro_torch.train.loop import init_train_state, make_train_step
    argv = ["--arch", "qwen3_4b", "--reduced", "--steps", "3", "--batch",
            "4", "--seq", "32", "--model-shards", "1"]
    args = launch_train.parse_args(argv)
    cfg, state, step, pipe = launch_train.setup(args, cuda)
    runs = []
    for _ in range(2):
        losses = []
        for _ in range(3):
            state, m = step(state, pipe.next_batch())
            losses.append(m["loss"])
        runs.append((state, torch.stack(losses)))
        gen = torch.Generator(device=cuda)
        gen.manual_seed(args.seed)
        state = init_train_state(init_params(gen, cfg))
        step = make_train_step(cfg, peak_lr=args.lr, total_steps=3,
                               warmup=5)
        pipe.seek(0)
    (a, la), (b, lb) = runs
    assert torch.equal(la, lb) and torch.isfinite(la).all()
    assert not any(is_placed(x) for x in a.params.parameters())
    for (n, x), (_, y) in zip(a.params.named_parameters(),
                              b.params.named_parameters()):
        assert x.device.type == cuda.type and torch.equal(x, y), n
    for n in a.opt.m:
        assert torch.equal(a.opt.m[n], b.opt.m[n]), n
        assert torch.equal(a.opt.v[n], b.opt.v[n]), n


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


# the decode kernel: (B, T, KV, G, hd, cache, window): qwen3-4b's serving
# shape on both caches, recurrentgemma-9b's ring, the reduced configs'
# float32 head dims 8 and 16, and int8 under a float32 q; the GQA groups
# of qwen2.5-3b (2 KV heads of 8: two head groups of the kernel's 4),
# glm4-9b (2 of 16: four) and phi4-mini (8 of 3: one partly filled) at the
# serving shape on both caches, and groups of 3 and 7 (a full head group
# and a partly filled one) at small shapes
DECODE_GPU_SHAPES = [
    (4, 4352, 8, 4, 128, "bfloat16", 0),
    (4, 4352, 8, 4, 128, "int8", 0),
    (4, 4352, 2, 8, 128, "bfloat16", 0),
    (4, 4352, 2, 8, 128, "int8", 0),
    (4, 4352, 2, 16, 128, "bfloat16", 0),
    (4, 4352, 2, 16, 128, "int8", 0),
    (4, 4352, 8, 3, 128, "bfloat16", 0),
    (4, 4352, 8, 3, 128, "int8", 0),
    (3, 40, 2, 3, 16, "float32", 6),
    (2, 300, 2, 7, 32, "bfloat16", 0),
    (4, 2048, 1, 16, 256, "bfloat16", 2048),
    (3, 40, 2, 2, 16, "float32", 6),
    (2, 33, 2, 1, 8, "float32", 0),
    (3, 70, 2, 4, 64, "int8", 0),
    (2, 300, 1, 16, 256, "float32", 0),
]


def _decode_case(seed, B, T, KV, G, hd, cache, window, dev):
    """q, the cache (int8 through the model's quantiser, float32 q for
    the int8 case of head dim 64) and positions: a ragged prefix, a
    wrapped ring, a prefix with slots past the query."""
    from repro_torch.models.transformer import _kv_quantize
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    qdt = torch.float32 if cache == "float32" or hd == 64 else \
        torch.bfloat16
    q = torch.randn((B, 1, KV * G, hd), generator=gen, device=dev).to(qdt)
    k, v = (torch.randn((B, T, KV, hd), generator=gen, device=dev)
            for _ in range(2))
    ks = vs = None
    if cache == "int8":
        (k, ks), (v, vs) = _kv_quantize(k), _kv_quantize(v)
    else:
        k, v = k.to(qdt), v.to(qdt)
    pos = torch.full((B, T), -1, dtype=torch.long, device=dev)
    q_pos = torch.zeros((B,), dtype=torch.long, device=dev)
    for b in range(B):
        n = max(1, (b + 1) * T // (B + 1))
        if b == 1:
            q_pos[b] = T + n
            p = torch.arange(q_pos[b] - T + 1, q_pos[b] + 1, device=dev)
            pos[b, p % T] = p
        else:
            pos[b, :n] = torch.arange(n, device=dev)
            q_pos[b] = max(0, n - 1 - (2 if b == B - 1 else 0))
    return q, k, v, ks, vs, pos, q_pos


@pytest.mark.parametrize("B,T,KV,G,hd,cache,window", DECODE_GPU_SHAPES)
def test_decode_kernel_matches_plain(cuda, B, T, KV, G, hd, cache, window):
    """The decode kernel against ``decode_attention_plain`` on the same
    card tensors: float32 within 1e-5 x max|out|, bf16 every element
    within two bf16 steps plus 1e-4; one launch on the cache type's
    route; a second launch bitwise equal."""
    from repro_torch.kernels.decode_attention import (decode_attention_kernel,
                                                      decode_attention_plain)
    args = _decode_case(B + T + hd, B, T, KV, G, hd, cache, window, cuda)
    q, k, v, ks, vs, pos, q_pos = args
    kern = decode_attention_kernel
    before, routes = kern.launches, dict(kern.routes)
    got = kern(q, k, v, pos, q_pos, window, ks, vs)
    assert kern.launches == before + 1
    assert kern.routes[cache] == routes[cache] + 1
    again = kern(q, k, v, pos, q_pos, window, ks, vs)
    want = decode_attention_plain(q, k, v, pos, q_pos, window, ks, vs)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == q.dtype
    assert torch.equal(got, again)
    if q.dtype == torch.float32:
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -6, atol=1e-4)


@pytest.mark.parametrize("B,T,KV,G,hd,dt", [
    (4, 1600, 8, 4, 128, "bfloat16"),   # llama-3.2-vision's cross cache
    (3, 37, 2, 3, 16, "float32"), (2, 1, 1, 5, 80, "bfloat16")])
def test_cross_decode_route_matches_plain(cuda, B, T, KV, G, hd, dt):
    """The decode kernel's cross route (every slot visible, the scores
    times float32(1 / sqrt(hd)), p kept in float32) against
    ``cross_decode_attention_plain`` on the same card tensors: float32
    within 1e-5 x max|out|; bfloat16 every element between the bf16
    roundings of the plain float32 value minus and plus that; one launch
    a call, counted by the cross wrapper alone; a second launch bitwise
    equal; the other routes' counts unchanged."""
    from repro_torch.kernels import decode_attention as dk
    gen = torch.Generator(device=cuda)
    gen.manual_seed(T + hd)
    tdt = getattr(torch, dt)
    q = torch.randn((B, 1, KV * G, hd), generator=gen, device=cuda).to(tdt)
    k, v = (torch.randn((B, T, KV, hd), generator=gen, device=cuda).to(tdt)
            for _ in range(2))
    kern = dk.cross_decode_attention_kernel
    before = kern.launches
    others = (dk.decode_attention_kernel.launches,
              dict(dk.decode_attention_kernel.routes))
    got = kern(q, k, v)
    again = kern(q, k, v)
    want = dk.cross_decode_attention_plain(q.float(), k.float(), v.float())
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert (dk.decode_attention_kernel.launches,
            dk.decode_attention_kernel.routes) == others
    assert got.shape == q.shape and got.dtype == tdt
    assert torch.equal(got, again)
    tol = 1e-5 * float(want.abs().max())
    if dt == "float32":
        assert float((got - want).abs().max()) <= tol
    else:
        lo, hi = (want - tol).to(tdt), (want + tol).to(tdt)
        assert not ((got < lo) | (got > hi)).any()


def test_decode_wrapper_rejects_bad_inputs_on_card(cuda):
    """Nothing of the cache is copied on the card: a non-contiguous cache
    or int32 positions raise before any launch."""
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    q, k, v, _, _, pos, q_pos = _decode_case(0, 2, 33, 2, 1, 8, "float32",
                                             0, cuda)
    before = decode_attention_kernel.launches
    wide = torch.zeros((2, 33, 2, 16), device=cuda)[..., :8]
    with pytest.raises(ValueError, match="not contiguous"):
        decode_attention_kernel(q, wide, v, pos, q_pos)
    with pytest.raises(TypeError, match="int64"):
        decode_attention_kernel(q, k, v, pos.int(), q_pos)
    with pytest.raises(ValueError, match="on cpu"):
        decode_attention_kernel(q, k.cpu(), v, pos, q_pos)
    assert decode_attention_kernel.launches == before


@pytest.mark.parametrize("B,S,W,dt", [(1, 4096, 4096, "bfloat16"),
                                      (2, 37, 4096, "float32"),
                                      (3, 5, 40, "bfloat16"),
                                      (1, 1, 7, "float32"),
                                      (3, 300, 1000, "float32"),
                                      (2, 257, 4100, "bfloat16"),
                                      (1, 512, 64, "float32")])
def test_rglru_scan_kernel_matches_plain(cuda, B, S, W, dt):
    """The scan kernel against ``rglru_scan_plain`` on the same card
    tensors (float32 within 1e-5 x max|h|, bf16 within two bf16 steps),
    one launch, a second one bitwise equal; the tile's edges (32
    channels x 256 steps): S off the tile with B > 1 and W off the
    channel tile, S one step past a tile, S two whole tiles, and S and W
    below one tile."""
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain
    gen = torch.Generator(device=cuda)
    gen.manual_seed(S + W)
    x = (torch.randn((B, S, W), generator=gen, device=cuda) * 2).to(
        getattr(torch, dt))
    u = [torch.rand((W,), generator=gen, device=cuda) for _ in range(5)]
    p = (u[0] * 28 - 3, u[1] + 0.5, u[2] - 0.5, u[3] + 0.5, u[4] - 0.5)
    before = rglru_scan.launches
    got = rglru_scan(x, *p)
    assert rglru_scan.launches == before + 1
    again = rglru_scan(x, *p)
    want = rglru_scan_plain(x, *p)
    torch.cuda.synchronize()
    assert got.shape == x.shape and got.dtype == x.dtype
    assert torch.equal(got, again)
    if dt == "float32":
        err = float((got - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max())
    else:
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=2.0 ** -6, atol=1e-4)


def test_decode_kernel_row_that_sees_no_slot(cuda):
    """A row whose every slot lies past its query: the softmax over all
    NEG_INF gives p = 1 / T on every slot, as the plain version; the
    other row as usual."""
    from repro_torch.kernels.decode_attention import (decode_attention_kernel,
                                                      decode_attention_plain)
    q, k, v, ks, vs, pos, q_pos = _decode_case(5, 2, 70, 2, 4, 64, "int8",
                                               0, cuda)
    pos[0] = torch.arange(70, device=cuda) + 1
    q_pos[0] = 0
    got = decode_attention_kernel(q, k, v, pos, q_pos, 0, ks, vs)
    want = decode_attention_plain(q, k, v, pos, q_pos, 0, ks, vs)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max())


def _graph_replays(fn):
    """One ``fn()`` call captured in a CUDA graph and replayed twice."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(out.clone())
    return replays


def _graph_kernel_nodes(fn):
    """(kernel nodes, all nodes) of a CUDA graph of one ``fn()`` call,
    read through the CUDA runtime (the profiler can drop the device
    events of a short window)."""
    import ctypes
    rt = None
    for name in ("libcudart.so.12", "libcudart.so"):
        try:
            rt = ctypes.CDLL(name)
            break
        except OSError:
            continue
    assert rt is not None, "libcudart not found"
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert rt.cudaGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * max(1, n.value))()
    assert rt.cudaGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    kinds = []
    for i in range(n.value):
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(nodes[i]),
                                       ctypes.byref(kind)) == 0
        kinds.append(kind.value)
    return sum(k == 0 for k in kinds), len(kinds)   # 0: a kernel node


@pytest.mark.parametrize("kernel", ["decode", "scan"])
def test_kernels_replay_in_a_cuda_graph(cuda, kernel):
    """The decode kernel's arrival counters and the scan's tile counter
    and flags are zero after every launch: a CUDA graph of one call
    replays bitwise the eager launch, twice; a call launches 2 device
    kernels (decode) or 1 (scan)."""
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan
    if kernel == "decode":
        args = _decode_case(3, 4, 4352, 8, 4, 128, "bfloat16", 0, cuda)
        q, k, v, ks, vs, pos, q_pos = args

        def fn():
            return decode_attention_kernel(q, k, v, pos, q_pos, 0, ks, vs)
        launches = 2     # scores_kernel, values_kernel
    else:
        gen = torch.Generator(device=cuda)
        gen.manual_seed(4)
        x = torch.randn((1, 1000, 4096), generator=gen,
                        device=cuda).bfloat16()
        p = [torch.rand((4096,), generator=gen, device=cuda) + 0.5
             for _ in range(5)]

        def fn():
            return rglru_scan(x, *p)
        launches = 1     # rglru_scan_kernel
    with torch.no_grad():
        want = fn()
        for got in _graph_replays(fn):
            assert torch.equal(got, want)
        assert _graph_kernel_nodes(fn) == (launches, launches)


@pytest.mark.parametrize("B,S,W,dt", [(1, 600, 64, "float32"),
                                      (3, 300, 1000, "float32"),
                                      (2, 37, 40, "bfloat16"),
                                      (1, 1, 7, "float32"),
                                      (2, 263, 1036, "float32")])
def test_rglru_scan_gradient_kernel_matches_plain(cuda, B, S, W, dt):
    """A CUDA ``rglru_scan`` call that needs a gradient launches the
    forward kernel once and, in the backward, ``csrc/rglru_scan_bwd.cu``
    once; its gradients against ``rglru_scan_backward_plain`` on the same
    inputs: float32 dx within 1e-5 of max|dx|, bf16 dx within two bf16
    steps of |dx| plus that, each parameter gradient within 1e-4 of its
    largest entry; a second backward launch bitwise equal, and the
    kernel's workspace zero after it."""
    from repro_torch.kernels import build
    from repro_torch.kernels import rglru_scan as rs
    gen = torch.Generator(device=cuda)
    gen.manual_seed(B * S + W)
    x = (torch.randn((B, S, W), generator=gen, device=cuda) * 2).to(
        getattr(torch, dt))
    u = [torch.rand((W,), generator=gen, device=cuda) for _ in range(5)]
    p = [u[0] * 28.0 - 3.0, u[1] + 0.5, u[2] - 0.5, u[3] + 0.5, u[4] - 0.5]
    dh = torch.randn((B, S, W), generator=gen, device=cuda).to(x.dtype)
    leaves = [t.clone().requires_grad_(True) for t in (x, *p)]
    f0, b0 = rs.rglru_scan.launches, rs.rglru_scan_backward.launches
    got = torch.autograd.grad(rs.rglru_scan(*leaves), leaves, dh)
    assert (rs.rglru_scan.launches - f0,
            rs.rglru_scan_backward.launches - b0) == (1, 1)
    want = rs.rglru_scan_backward_plain(x, *p, dh)
    scale = float(want[0].float().abs().max())
    diff = (got[0].float() - want[0].float()).abs()
    if dt == "float32":
        assert float(diff.max()) <= 1e-5 * scale
    else:
        assert not bool((diff > 2.0 ** -7 * want[0].float().abs()
                         + 1e-5 * scale).any())
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        assert float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
    _, carry = rs._forward_kernel(x, p)
    again = rs.rglru_scan_backward(x, *p, dh, carry)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert torch.equal(a, b)
    work = build.workspace("rglru_scan_bwd", cuda,
                           rs.backward_tiles(B, S, W)[1])
    assert int(work.abs().sum()) == 0


@pytest.mark.parametrize("arch,kv_quant", [("recurrentgemma_9b", False),
                                           ("qwen3_4b", True),
                                           ("phi3_5_moe", False),
                                           ("mixtral_8x22b", False)])
def test_decode_path_on_card_matches_cpu(cuda, arch, kv_quant):
    """Reduced recurrentgemma-9b (scan and decode kernels beside the
    flash kernel), reduced qwen3-4b on the int8 cache and the reduced
    MoE archs (capacity routing in prefill, drop-free in decode; mixtral's
    16-slot window ring) served on the card and on the CPU, the same weights and requests (prompts longer
    than the local window among them): the same greedy tokens; the
    kernels launched once a layer of their kind per prefill and decode
    step."""
    from repro_torch.kernels.decode_attention import decode_attention_kernel
    from repro_torch.kernels.rglru_scan import rglru_scan
    cfg = dataclasses.replace(get_config(arch, reduced=True),
                              kv_quant=kv_quant)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 17, 70)]
    outs = []
    for dev in ("cpu", cuda):
        eng = ServeEngine(model.to(dev), cfg, n_slots=2, max_len=96,
                          device=dev)
        for i, p in enumerate(prompts):
            eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=6))
        counts = [c.launches for c in (flash_attention, rglru_scan,
                                       decode_attention_kernel)]
        done = eng.run()
        outs.append({i: r.output for i, r in done.items()})
    n_attn = sum(k != "rglru" for k in cfg.layout())
    n_rec = cfg.n_layers - n_attn
    steps = eng.stats["decode_steps"]
    assert [c.launches - b for c, b in zip(
        (flash_attention, rglru_scan, decode_attention_kernel), counts)] == \
        [n_attn * len(prompts), n_rec * len(prompts), n_attn * steps]
    assert outs[0] == outs[1]


def _mlstm_case(seed, B, S, H, hd, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    q, k, v = (torch.randn((B, S, H, hd), generator=gen, device=dev)
               for _ in range(3))
    k = k / math.sqrt(hd)
    i_pre, f_pre = (torch.randn((B, S, H), generator=gen, device=dev) * 2
                    for _ in range(2))
    state = (torch.randn((B, H, hd, hd), generator=gen, device=dev) * 0.3,
             torch.randn((B, H, hd), generator=gen, device=dev),
             torch.randn((B, H), generator=gen, device=dev))
    return (q, k, v, i_pre, f_pre), state


def _slstm_case(seed, B, S, w, dt, dev):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    gates = (torch.randn((B, S, w, 4), generator=gen, device=dev) * 2).to(
        getattr(torch, dt))
    r = torch.randn((w, 4), generator=gen, device=dev) * 0.5
    c, m, h = (torch.randn((B, w), generator=gen, device=dev)
               for _ in range(3))
    n = torch.randn((B, w), generator=gen, device=dev).abs() + 0.5
    return (gates, r), (c, n, m, h)


def _within(got, want, rel=1e-5):
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


def _tie_gates(seed, B, S, H, m, dev):
    """i_pre, f_pre (B, S, H) for the stabiliser m (B, H), every entry at
    least 1: i_pre wins the max at t % 3 == 0, log_f + m at t % 3 == 1
    and ties it exactly at t % 3 == 2 (f_pre = 30 there: log_f ~ -9.4e-14
    leaves log_f + m = m bit for bit, so m is known at every step)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    u = torch.rand((B, S, H), generator=gen, device=dev)
    f_pre = torch.randn((B, S, H), generator=gen, device=dev) * 2
    i_pre = torch.empty((B, S, H), device=dev)
    for t in range(S):
        if t % 3 == 0:
            i_pre[:, t] = m + 1 + u[:, t]
            m = i_pre[:, t].clone()
        else:
            f_pre[:, t] = 30.0
            i_pre[:, t] = m - 1 - u[:, t] if t % 3 == 1 else m
    return i_pre, f_pre


@pytest.mark.parametrize("B,S,H,hd,ties", [
    (2, 37, 4, 16, False), (1, 300, 4, 512, False), (4, 1, 4, 512, False),
    (1, 50, 2, 32, False), (3, 20, 4, 64, False), (1, 40, 2, 128, False),
    (2, 9, 4, 256, False), (1, 5, 4, 512, False), (2, 45, 2, 128, False),
    (1, 67, 4, 512, True), (2, 13, 2, 16, True)])
def test_mlstm_scan_kernel_matches_plain(cuda, B, S, H, hd, ties):
    """The mLSTM scan kernel against ``mlstm_scan_plain`` from the same
    random state: h and the final C, n, m within 1e-5 of their largest
    entry, one launch on the route of its head width, a second launch
    bitwise equal (h and state); every instantiated width, xlstm-350m's
    512 (prefill and 4-slot decode) and the reduced 16; S under one
    staged chunk of 8 steps and off it and off the gate batch of 32; and
    gates where i_pre wins the max on some steps, log_f + m on others,
    and ties it exactly on the rest."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan, mlstm_scan_plain
    args, state = _mlstm_case(S + hd, B, S, H, hd, cuda)
    if ties:
        m = state[2].abs() + 1
        state = (state[0], state[1], m)
        args = args[:3] + _tie_gates(S, B, S, H, m, cuda)
    one, two, ref = ([t.clone() for t in state] for _ in range(3))
    before, routed = mlstm_scan.launches, mlstm_scan.routes[f"hd{hd}"]
    got = mlstm_scan(*args, *one)
    assert mlstm_scan.launches == before + 1
    assert mlstm_scan.routes[f"hd{hd}"] == routed + 1
    again = mlstm_scan(*args, *two)
    want = mlstm_scan_plain(*args, *ref)
    torch.cuda.synchronize()
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert _within(got, want)
    assert all(_within(a, b) for a, b in zip(one, ref))


@pytest.mark.parametrize("B,S,w,dt", [(2, 37, 32, "float32"),
                                      (1, 4096, 1024, "bfloat16"),
                                      (4, 1, 1024, "bfloat16"),
                                      (3, 100, 1000, "float32"),
                                      (1, 5, 7, "bfloat16"),
                                      (1, 300, 1000, "bfloat16"),
                                      (3, 70, 7, "float32")])
def test_slstm_scan_kernel_matches_plain(cuda, B, S, w, dt):
    """The sLSTM scan kernel against ``slstm_scan_plain`` from the same
    random state: hs and the final c, n, m, h within 1e-5 of their
    largest entry, one launch on the route of the gates' type, a second
    launch bitwise equal; the reduced width, xlstm-350m's 1024 (prefill
    and 4-slot decode) and widths off the warp's 32 channels, with S
    under and off the staged chunk of 32 steps."""
    from repro_torch.kernels.slstm_scan import slstm_scan, slstm_scan_plain
    args, state = _slstm_case(S + w, B, S, w, dt, cuda)
    one, two, ref = ([t.clone() for t in state] for _ in range(3))
    before, routed = slstm_scan.launches, slstm_scan.routes[dt]
    got = slstm_scan(*args, *one)
    assert slstm_scan.launches == before + 1
    assert slstm_scan.routes[dt] == routed + 1
    again = slstm_scan(*args, *two)
    want = slstm_scan_plain(*args, *ref)
    torch.cuda.synchronize()
    assert got.shape == (B, S, w) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    assert _within(got, want)
    assert all(_within(a, b) for a, b in zip(one, ref))


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_xlstm_scans_split_and_replay_bitwise(cuda, kind):
    """A scan over S steps equals, bit for bit, the scan over S - 1 steps
    followed by one step from the state it left (a prefill and its decode
    step); a CUDA graph of one call, its state restored before each of
    two replays, replays the eager launch bitwise; one device kernel a
    call."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan
    from repro_torch.kernels.slstm_scan import slstm_scan
    if kind == "mlstm":
        args, state = _mlstm_case(7, 1, 65, 4, 512, cuda)

        def run(st, t0, t1):
            return mlstm_scan(*(a[:, t0:t1] for a in args), *st)
    else:
        args, state = _slstm_case(7, 2, 65, 1024, "bfloat16", cuda)

        def run(st, t0, t1):
            return slstm_scan(args[0][:, t0:t1], args[1], *st)
    with torch.no_grad():
        one, two = ([t.clone() for t in state] for _ in range(2))
        whole = run(one, 0, 65)
        run(two, 0, 64)
        last = run(two, 64, 65)
        assert torch.equal(whole[:, 64:], last)
        assert all(torch.equal(a, b) for a, b in zip(one, two))
        static = [t.clone() for t in state]
        graph = torch.cuda.CUDAGraph()
        run([t.clone() for t in state], 0, 65)
        torch.cuda.synchronize()
        with torch.cuda.graph(graph):
            out = run(static, 0, 65)
        for _ in range(2):
            for t, s in zip(static, state):
                t.copy_(s)
            graph.replay()
            torch.cuda.synchronize()
            assert torch.equal(out, whole)
            assert all(torch.equal(a, b) for a, b in zip(static, one))
        scratch = [t.clone() for t in state]
        assert _graph_kernel_nodes(lambda: run(scratch, 0, 65)) == (1, 1)


def test_xlstm_scan_kernels_refuse_a_gradient(cuda):
    """A CUDA scan call that needs a gradient launches the forward kernel
    once and, in the backward, its backward kernel once (``MLSTMScan``,
    ``SLSTMScan``), with nothing given way to the plain loop: the
    gradients equal the backward wrappers' on the same inputs bitwise;
    under no_grad the same call launches the forward alone; a state that
    requires a gradient is refused."""
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import slstm_scan as ss
    args, state = _mlstm_case(1, 1, 4, 2, 16, cuda)
    sargs, sstate = _slstm_case(1, 1, 4, 8, "float32", cuda)
    mleaves = [a.clone().requires_grad_() for a in args]
    sleaves = [a.clone().requires_grad_() for a in sargs]
    counters = (ms.mlstm_scan, ms.mlstm_scan_backward, ss.slstm_scan,
                ss.slstm_scan_backward)
    before = [c.launches for c in counters]
    h = ms.mlstm_scan(*mleaves, *[t.clone() for t in state])
    hs = ss.slstm_scan(*sleaves, *[t.clone() for t in sstate])
    dh, dhs = torch.ones_like(h), torch.ones_like(hs)
    mg = torch.autograd.grad(h, mleaves, dh)
    sg = torch.autograd.grad(hs, sleaves, dhs)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 1, 1, 1]
    want_m = ms.mlstm_scan_backward(*args, *state, dh)
    hs_again, saved = ss._forward_kernel(*sargs, *[t.clone() for t in sstate],
                                         save=True)
    want_s = ss.slstm_scan_backward(*sargs, *sstate, dhs, hs_again, saved)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(mg, want_m))
    assert all(torch.equal(a, b) for a, b in zip(sg, want_s))
    before = [c.launches for c in counters]
    with torch.no_grad():
        ms.mlstm_scan(*mleaves, *state)
        ss.slstm_scan(*sleaves, *sstate)
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 0, 1, 0]
    # the state is not differentiated: a state asking for a gradient is
    # refused before any launch, not given none
    with pytest.raises(ValueError, match="state is not differentiated"):
        ms.mlstm_scan(*mleaves, state[0].clone().requires_grad_(),
                      *state[1:])
    with pytest.raises(ValueError, match="state is not differentiated"):
        ss.slstm_scan(*sleaves, sstate[0].clone().requires_grad_(),
                      *sstate[1:])
    assert [c.launches - b for c, b in zip(counters, before)] == [1, 0, 1, 0]


@pytest.mark.parametrize("B,S,H,hd,ties", [
    (2, 37, 4, 16, False), (1, 1, 2, 16, False), (1, 300, 4, 512, False),
    (4, 1, 4, 512, False), (2, 45, 2, 128, False), (3, 20, 4, 64, False),
    (2, 9, 4, 256, False), (1, 67, 4, 512, True)])
def test_mlstm_scan_backward_kernel_matches_plain(cuda, B, S, H, hd, ties):
    """``csrc/mlstm_scan_bwd.cu`` against ``mlstm_scan_backward_plain`` on
    the same inputs: dq, dk, dv within 1e-5 of their largest entry, the
    gate pre-activations' gradients within 1e-4 (from the zero state, or
    from a random one with the stabiliser's planted ties); seven kernels a
    call counted once; a second call bitwise equal."""
    from repro_torch.kernels import mlstm_scan as ms
    args, state = _mlstm_case(S + hd, B, S, H, hd, cuda)
    if ties:
        m = state[2].abs() + 1
        state = (state[0], state[1], m)
        args = args[:3] + _tie_gates(S, B, S, H, m, cuda)
    else:
        state = ms.init_state(B, H, hd, cuda)
    dh = torch.randn((B, S, H, hd), device=cuda)
    before = ms.mlstm_scan_backward.launches
    got = ms.mlstm_scan_backward(*args, *state, dh)
    again = ms.mlstm_scan_backward(*args, *state, dh)
    assert ms.mlstm_scan_backward.launches == before + 2
    want = ms.mlstm_scan_backward_plain(*args, *state, dh)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(g, again[i])
        assert _within(g, w, 1e-5 if i < 3 else 1e-4)


@pytest.mark.parametrize("B,S,w,dt", [(2, 37, 32, "float32"),
                                      (1, 1, 7, "float32"),
                                      (3, 70, 7, "float32"),
                                      (1, 300, 1000, "bfloat16"),
                                      (4, 128, 1024, "bfloat16")])
def test_slstm_scan_backward_kernel_matches_plain(cuda, B, S, w, dt):
    """``csrc/slstm_scan_bwd.cu`` against ``slstm_scan_backward_plain``
    from a random state, given the forward's saving launch's hs and
    states as ``SLSTMScan.backward`` gives them: float32 dgates within
    1e-5 of its largest entry (bf16: two bf16 steps of each entry plus
    that), dr within 1e-4; a second launch bitwise equal and the arrival
    counters zero after it; widths off a block's channels, S off the
    32-step chunk, S = 1."""
    from repro_torch.kernels import build
    from repro_torch.kernels import slstm_scan as ss
    args, state = _slstm_case(S + w, B, S, w, dt, cuda)
    dhs = torch.randn((B, S, w), device=cuda)
    hs, saved = ss._forward_kernel(*args, *[t.clone() for t in state],
                                   save=True)
    got = ss.slstm_scan_backward(*args, *state, dhs, hs, saved)
    again = ss.slstm_scan_backward(*args, *state, dhs, hs, saved)
    want = ss.slstm_scan_backward_plain(*args, *state, dhs)
    torch.cuda.synchronize()
    assert got[0].dtype == args[0].dtype and got[1].dtype == torch.float32
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    wf = want[0].float()
    over = (got[0].float() - wf).abs() > 1e-5 * float(wf.abs().max()) + (
        2.0 ** -7 * wf.abs() if dt == "bfloat16" else 0.0)
    assert not bool(over.any())
    assert _within(got[1], want[1], 1e-4)
    work = build.workspace("slstm_scan_bwd", cuda,
                           -(-w // ss.SCAN_BWD_CHANNELS))
    assert int(work.abs().sum()) == 0


@pytest.mark.parametrize("B,S,w,dt", [(2, 37, 32, "float32"),
                                      (1, 1, 7, "float32"),
                                      (1, 300, 1000, "bfloat16")])
def test_slstm_saving_forward_is_the_forward_bitwise(cuda, B, S, w, dt):
    """The forward kernel's saving launch (``SLSTMScan``'s forward) from a
    random state: hs and the final state bitwise those of the launch
    without saving, the saved state at step 0 bitwise the starting state
    and at step t bitwise the final state of a launch over the first t
    steps; the saved states within 1e-5 of the plain loop's."""
    from repro_torch.kernels import slstm_scan as ss
    args, state = _slstm_case(S * w + 1, B, S, w, dt, cuda)
    one, two = ([t.clone() for t in state] for _ in range(2))
    before = ss.slstm_scan.launches
    hs, saved = ss._forward_kernel(*args, *one, save=True)
    with torch.no_grad():
        want = ss.slstm_scan(*args, *two)
    assert ss.slstm_scan.launches == before + 2
    assert torch.equal(hs, want)
    assert all(torch.equal(a, b) for a, b in zip(one, two))
    for got, start in zip(saved, state):
        assert torch.equal(got[:, 0], start)
    t = S // 2
    if t:
        part = [x.clone() for x in state]
        with torch.no_grad():
            ss.slstm_scan(args[0][:, :t], args[1], *part)
        for got, end in zip(saved, part):
            assert torch.equal(got[:, t], end)
    _, plain = ss.slstm_scan_plain(*args, *[x.clone() for x in state],
                                   save=True)
    for got, ref in zip(saved, plain):
        assert _within(got, ref)


def test_xlstm_train_on_card_matches_cpu(cuda):
    """Reduced xlstm-350m (float32) trains on the card through the scan
    kernels and their backward kernels: the loss (rtol 1e-5) and every
    parameter's gradient (within 1e-4 of its largest entry) against the
    CPU's plain loops on the same weights and tokens; each kernel's
    forward twice a layer of its kind (remat) and its backward once."""
    from repro_torch.kernels import mlstm_scan as ms
    from repro_torch.kernels import slstm_scan as ss
    from repro_torch.models import loss_fn
    cfg = get_config("xlstm_350m", reduced=True)
    model = init_params(torch.Generator().manual_seed(0), cfg).train()
    toks = torch.as_tensor(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 24)))
    counters = (ms.mlstm_scan, ms.mlstm_scan_backward, ss.slstm_scan,
                ss.slstm_scan_backward)
    res = []
    for dev in ("cpu", cuda):
        m = model.to(dev)
        before = [c.launches for c in counters]
        loss, _ = loss_fn(m, cfg, {"tokens": toks.to(dev),
                                   "labels": toks.to(dev)})
        names = [n for n, _ in m.named_parameters()]
        grads = torch.autograd.grad(loss, list(m.parameters()))
        launched = [c.launches - b for c, b in zip(counters, before)]
        res.append((float(loss.detach()), {n: g.float().cpu()
                                  for n, g in zip(names, grads)}))
    per_kind = cfg.n_layers // 2
    assert launched == [2 * per_kind, per_kind, 2 * per_kind, per_kind]
    (c_loss, c_g), (g_loss, g_g) = res
    assert abs(g_loss - c_loss) <= 1e-5 * abs(c_loss)
    for n in c_g:
        assert _within(g_g[n], c_g[n], 1e-4), n


def test_xlstm_on_card_matches_cpu(cuda):
    """Reduced xlstm-350m (float32) served on the card and on the CPU, the
    same weights and requests: the same greedy tokens; each scan kernel
    launched once a layer of its kind per prefill and decode step."""
    from repro_torch.kernels.mlstm_scan import mlstm_scan
    from repro_torch.kernels.slstm_scan import slstm_scan
    cfg = get_config("xlstm_350m", reduced=True)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (5, 40, 17, 70)]
    outs = []
    for dev in ("cpu", cuda):
        eng = ServeEngine(model.to(dev), cfg, n_slots=2, max_len=96,
                          device=dev)
        for i, p in enumerate(prompts):
            eng.submit(LMRequest(rid=i, prompt=p, max_new_tokens=6))
        counts = [mlstm_scan.launches, slstm_scan.launches]
        done = eng.run()
        outs.append({i: r.output for i, r in done.items()})
    steps = eng.stats["decode_steps"]
    per_kind = cfg.n_layers // 2 * (len(prompts) + steps)
    assert [mlstm_scan.launches - counts[0],
            slstm_scan.launches - counts[1]] == [per_kind, per_kind]
    assert outs[0] == outs[1]


def test_vision_on_card_matches_cpu(cuda):
    """Reduced llama-3.2-vision (float32, the gates drawn non-zero) on the
    card and on the CPU, the same weights, tokens and image embeddings: a
    prefill and 3 greedy decode steps, logits within 1e-4 of their
    largest entry; the flash kernel once a layer a prefill, the decode
    kernel once a self-attention layer and its cross route once a
    cross-attention layer a step."""
    from repro_torch.kernels import decode_attention as dk
    from repro_torch.models import decode_step, prefill
    cfg = get_config("llama32_vision_11b", reduced=True)
    gen = torch.Generator().manual_seed(0)
    model = init_params(gen, cfg)
    with torch.no_grad():
        for blk in model.blocks:
            if hasattr(blk, "gate_attn"):
                blk.gate_attn.fill_(0.7)
                blk.gate_mlp.fill_(-0.4)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 9)))
    img = torch.as_tensor(rng.standard_normal(
        (2, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32))
    counters = (flash_attention, dk.decode_attention_kernel,
                dk.cross_decode_attention_kernel)
    outs = []
    for dev in ("cpu", cuda):
        m = model.to(dev)
        before = [c.launches for c in counters]
        last, cache = prefill(m, cfg, {"tokens": toks.to(dev),
                                       "image_embeds": img.to(dev)}, 12)
        logits = [last.cpu()]
        for i in range(3):
            last, cache = decode_step(m, cfg, last.argmax(-1)[:, None],
                                      cache, torch.full((2,), 9 + i,
                                                        device=dev))
            logits.append(last.cpu())
        outs.append(torch.stack(logits))
    n_cross = cfg.layout().count("cross_attn")
    assert [c.launches - b for c, b in zip(counters, before)] == [
        cfg.n_layers, 3 * (cfg.n_layers - n_cross), 3 * n_cross]
    assert float((outs[1] - outs[0]).abs().max()) <= \
        1e-4 * float(outs[0].abs().max())


def test_hubert_on_card_matches_cpu(cuda):
    """Reduced hubert-xlarge (float32) on the card and on the CPU, the
    same weights and frames: the frame CE loss (rtol 1e-5) and every
    parameter's gradient (within 1e-4 of its largest entry; the unread
    ``embed`` zero on both); one gradient launch a layer."""
    from repro_torch.models import loss_fn
    cfg = get_config("hubert_xlarge", reduced=True)
    model = init_params(torch.Generator().manual_seed(0), cfg).train()
    rng = np.random.default_rng(1)
    frames = torch.as_tensor(rng.standard_normal(
        (2, 40, cfg.frontend_dim)).astype(np.float32))
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 40)))
    res = []
    for dev in ("cpu", cuda):
        m = model.to(dev)
        before = flash_attention_bwd.launches
        loss, _ = loss_fn(m, cfg, {"frames": frames.to(dev),
                                   "labels": labels.to(dev)})
        names, leaves = zip(*m.named_parameters())
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        res.append((float(loss.detach()),
                    {n: g.cpu() for n, g in zip(names, grads)}))
    assert flash_attention_bwd.launches - before == cfg.n_layers
    assert res[1][0] == pytest.approx(res[0][0], rel=1e-5)
    for n, want in res[0][1].items():
        got = res[1][1][n]
        assert float((got - want).abs().max()) <= \
            1e-4 * float(want.abs().max()), n


@pytest.mark.parametrize("n,dt", [(1, "float32"), (1000, "float32"),
                                  (3 * 2048 + 5, "bfloat16"),
                                  (1 << 20, "bfloat16")])
def test_error_feedback_compress_card_matches_cpu(cuda, n, dt):
    """``parallel.error_feedback_compress`` on the card and on the CPU, the
    same gradient and residual: q, scale and the new residual bitwise
    (the residual's products exact on both, one rounding)."""
    from repro_torch.parallel.compression import error_feedback_compress
    gen = torch.Generator().manual_seed(n)
    g = (torch.randn(n, generator=gen) * 3e-3).to(getattr(torch, dt))
    r = torch.randn(n, generator=gen) * 1e-5
    want = error_feedback_compress(g, r)
    got = error_feedback_compress(g.to(cuda), r.to(cuda))
    assert [t.device.type for t in got] == ["cuda"] * 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b)
