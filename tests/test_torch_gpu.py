"""Tests of the port that need an NVIDIA GPU: the hand-written Hopper
kernels against their plain versions, the wrappers' input checks, the
accuracy model's 'cuda' backend, the host accuracy oracle through the
bit-serial GEMM kernel, and one scenario on the card. They
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
from repro_torch.core.nonideal import accuracy_proxy_host, make_accuracy_model
from repro_torch.core.sampling import uniform_genomes
from repro_torch.experiments import get_scenario, run_scenario
from repro_torch.kernels.imc_fused import imc_fused_gemm, imc_fused_plain
from repro_torch.kernels.imc_matmul import imc_matmul, imc_matmul_plain
from repro_torch.kernels.ops import imc_gemm

pytestmark = pytest.mark.gpu

SHAPES = [
    (3, 4, 256, 8, 64, (64.0, 128.0, 256.0)),
    (2, 2, 96, 4, 32, (32.0, 64.0, 96.0)),       # odd tiling
    (2, 3, 200, 5, 64, (64.0, 128.0)),           # ragged K
    (1, 2, 48, 4, 16, (48.0,)),                  # single group
    (120, 32, 256, 32, 64, (64.0, 128.0, 256.0, 512.0)),  # main path
    (5, 40, 100, 70, 32, (32.0, 96.0)),          # ragged B and N tiles
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
    """The kernel sums in the plain version's order: the bound of
    tests/test_kernels.py holds, and in practice they agree bit for
    bit."""
    args = _inputs(P + K, P, B, K, N, rows, cuda)
    before = imc_fused_gemm.launches
    got = imc_fused_gemm(*args, sub=sub)
    assert imc_fused_gemm.launches == before + 1
    want = imc_fused_plain(*args, sub=sub)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    cpu = imc_fused_plain(*[a.cpu() for a in args], sub=sub)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-5, atol=1e-4)


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
    before = imc_fused_gemm.launches
    acc = make_accuracy_model(space, wa, backend="auto", device=cuda)
    assert acc.backend == "cuda"
    got = acc(g.to(cuda))
    assert imc_fused_gemm.launches == before + 1
    ref = make_accuracy_model(space, wa, backend="ref", device=cuda)(
        g.to(cuda))
    cpu = make_accuracy_model(space, wa, backend="jnp", device="cpu")(g)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=0.0)
    torch.testing.assert_close(got.cpu(), cpu, rtol=1e-4, atol=0.0)


def test_rram_accuracy_smoke_on_card(cuda, tmp_path):
    sc = get_scenario("rram_accuracy")
    sc = dataclasses.replace(sc, budget=sc.smoke_budget)
    before = imc_fused_gemm.launches
    res = run_scenario(sc, out_dir=str(tmp_path), device=cuda)
    assert imc_fused_gemm.launches > before
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
