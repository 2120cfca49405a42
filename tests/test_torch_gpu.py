"""Tests of the port that need an NVIDIA GPU: the hand-written Hopper
kernel against its plain version, the wrapper's input checks, the
accuracy model's 'cuda' backend and one scenario on the card. They
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
from repro_torch.core.nonideal import make_accuracy_model
from repro_torch.core.sampling import uniform_genomes
from repro_torch.experiments import get_scenario, run_scenario
from repro_torch.kernels.imc_fused import imc_fused_gemm, imc_fused_plain

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
