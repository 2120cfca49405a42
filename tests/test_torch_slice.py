"""The port's slices end to end on the CPU: ``rram_smoke`` (EDAP),
``rram_accuracy`` (§IV-H, edap_acc, the fused-kernel dataflow through
its plain version) and ``sram_lm_archs`` (the assigned LM architectures
as workloads) at the smoke budget, run by both packages with backend
'ref'; their result.json and specific_*.json must agree modulo timing
fields — identical genomes, floats at rtol 1e-5 (EDAP) and 1e-4
(accuracy-scored). The LM co-design example's scenario and its qwen3
projection through both packages' ``imc_gemm``. Plus the port's own
rules: no JAX and no ``repro`` import anywhere in it, entry points
default to the GPU and never fall back to the CPU, and the Table 3
scenarios run and render their table."""
import ast
import dataclasses
import json
import math
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.experiments import SMOKE_BUDGET as JSMOKE_BUDGET
from repro.experiments import get_scenario as jget_scenario
from repro.experiments import run_scenario as jrun_scenario
from repro.kernels.ops import imc_gemm as jimc_gemm
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.examples import codesign_lm_archs as example
from repro_torch.experiments import REGISTRY, get_scenario, run_scenario
from repro_torch.experiments import __main__ as cli
from repro_torch.experiments.report import write_summary
from repro_torch.kernels.ops import imc_gemm
from repro_torch.launch import serve as serve_cli
from repro_torch.models import init_params
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
# fields that differ between runs of the same computation, plus the
# port's device block (the reference has none)
TIMING_FIELDS = {"wall_time_s", "search_wall_time_s", "sampling_time_s",
                 "cached", "device"}


def _compare(a, b, rtol, path="result"):
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        ka, kb = set(a) - TIMING_FIELDS, set(b) - TIMING_FIELDS
        assert ka == kb, f"{path}: keys {sorted(ka ^ kb)}"
        for k in sorted(ka):
            _compare(a[k], b[k], rtol, f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, rtol, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        if "design" in path.split(".")[-2:] or path.endswith("design"):
            assert a == b, path
        elif math.isfinite(a):
            assert math.isclose(a, b, rel_tol=rtol, abs_tol=0.0), \
                f"{path}: {a} vs {b}"
        else:
            assert a == b or (math.isnan(a) and math.isnan(b)), path
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _designs_equal(a, b):
    assert a["generalized"]["design"] == b["generalized"]["design"]
    for w in a.get("specific", {}):
        assert a["specific"][w]["design"] == b["specific"][w]["design"], w


@pytest.mark.parametrize("name,rtol", [("rram_smoke", 1e-5),
                                       ("rram_accuracy", 1e-4),
                                       ("sram_lm_archs", 1e-5)])
def test_slice_matches_reference(tmp_path, name, rtol):
    ref_sc = jget_scenario(name)
    ref_sc = dataclasses.replace(ref_sc, budget=ref_sc.smoke_budget,
                                 backend="ref")
    sc = get_scenario(name)
    sc = dataclasses.replace(sc, budget=sc.smoke_budget, backend="ref")
    jrun_scenario(ref_sc, out_dir=str(tmp_path / "jax"))
    res = run_scenario(sc, out_dir=str(tmp_path / "torch"), device="cpu")
    assert res["device"] == {"type": "cpu", "name": "cpu", "count": 1}
    assert res["backend"] == "ref"
    files = sorted(os.listdir(tmp_path / "jax" / name))
    assert files == sorted(os.listdir(tmp_path / "torch" / name))
    for fn in files:
        if not fn.endswith(".json"):
            continue
        a = json.loads((tmp_path / "jax" / name / fn).read_text())
        b = json.loads((tmp_path / "torch" / name / fn).read_text())
        if fn == "result.json":
            _designs_equal(a, b)
        _compare(a, b, rtol, fn)
    # served from the cache on a re-run with the same key
    again = run_scenario(sc, out_dir=str(tmp_path / "torch"), device="cpu")
    assert again["cached"] is True
    assert "rram_accuracy" not in name or all(
        "accuracy" in m for m in res["generalized"]["per_workload"].values())


@pytest.mark.parametrize("name", ["rram_small_set_plain",
                                  "sram_small_set_random"])
def test_other_algorithms_run(tmp_path, name):
    """The plain-GA and random-search paths (generalized search and
    specific baselines) at the smoke budget."""
    sc = get_scenario(name)
    sc = dataclasses.replace(sc, budget=sc.smoke_budget)
    res = run_scenario(sc, out_dir=str(tmp_path), device="cpu")
    assert math.isfinite(res["best_score"]) and res["best_score"] < 1e29
    assert set(res["specific"]) == set(sc.workloads)
    assert len(res["history"]) >= 1 and res["backend"] == "jnp"
    text = write_summary(str(tmp_path))
    assert name in text


@pytest.mark.parametrize("name", ["table3_reduced_rram", "alg_compare_rram"])
def test_unported_scenarios_name_roadmap_item(tmp_path, name):
    """The Table 3 scenarios run and render (the name is the one this
    test had while the port refused them, naming their ROADMAP item):
    the study at the smoke budget on the CPU, six algorithms over five
    seeds, its report.md a Table 3; no registry scenario raises
    ``NotImplementedError`` any more."""
    sc = get_scenario(name)
    res = run_scenario(dataclasses.replace(sc, budget=sc.smoke_budget),
                       out_dir=str(tmp_path), device="cpu")
    assert list(res["algorithms"]) == ["GA", "PSO", "ES", "SRES", "CMA-ES",
                                       "G3PCX"]
    assert all(a["n_seeds"] == 5 for a in res["algorithms"].values())
    assert math.isfinite(res["best_score"]) and res["best_score"] < 1e29
    assert res["ground_truth"]["exhaustive"] == sc.reduced_space
    text = (tmp_path / name / "report.md").read_text()
    assert "## Algorithm comparison (Table 3)" in text
    assert all(f"| {a} |" in text for a in res["algorithms"])
    for other in REGISTRY.values():
        other.space()
        other.resolve_workloads()


def test_lm_example_matches_reference():
    """The example's default run on the CPU: ``sram_lm_archs`` at the
    smoke budget without specific baselines picks the reference's
    design, and its qwen3 projection (reduced config) through the port's
    ``imc_gemm`` matches the JAX ``imc_gemm`` (Pallas, interpret mode) on
    the same operands at the tests/test_kernels.py bound."""
    out = example.run(device="cpu")
    res, proj = out["result"], out["projection"]
    jsc = dataclasses.replace(jget_scenario("sram_lm_archs"),
                              budget=JSMOKE_BUDGET, specific_baselines=False)
    ref = jrun_scenario(jsc, write=False)
    assert res["generalized"]["design"] == ref["generalized"]["design"]
    assert "specific" not in res and "specific" not in ref
    assert math.isclose(res["best_score"], ref["best_score"], rel_tol=1e-5)
    cfg = jget_config("qwen3_4b", reduced=True)
    n = 3 * cfg.n_heads * cfg.head_dim
    assert proj["shape"] == (16, cfg.d_model, n)
    rows = int(ref["generalized"]["design"]["xbar_rows"])
    assert proj["xbar_rows"] == rows
    x, w = proj["x"].numpy(), proj["w"].numpy()
    want = np.asarray(jimc_gemm(jnp.asarray(x), jnp.asarray(w),
                                xbar_rows=rows))
    np.testing.assert_allclose(proj["y"].numpy(), want, rtol=1e-6,
                               atol=1e-4)
    exact = x.astype(np.float32) @ w
    rel = np.linalg.norm(want - exact) / np.linalg.norm(exact)
    assert math.isclose(proj["rel_err"], rel, rel_tol=1e-4)


@pytest.mark.parametrize("rows", [64, 128, 256, 512])
def test_lm_projection_matches_reference(rows):
    """The reduced qwen3 QKV projection through both packages' imc_gemm
    at every registry row count (K=32 padded to one crossbar), on the
    same numpy operands."""
    cfg = jget_config("qwen3_4b", reduced=True)
    rng = np.random.default_rng(rows)
    x = rng.integers(0, 256, (16, cfg.d_model)).astype(np.int32)
    w = (rng.standard_normal((cfg.d_model, 3 * cfg.n_heads * cfg.head_dim))
         * 0.25).astype(np.float32)
    got = imc_gemm(torch.from_numpy(x), torch.from_numpy(w),
                   xbar_rows=rows).numpy()
    want = np.asarray(jimc_gemm(jnp.asarray(x), jnp.asarray(w),
                                xbar_rows=rows))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-4)


def test_lm_example_cli(capsys):
    assert example.main(["--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "generalized LM-serving IMC design" in text
    assert "qwen3_4b" in text and "rel err" in text
    if not torch.cuda.is_available():
        assert example.main([]) == 2  # the GPU by default, no fallback
        assert "no CUDA device" in capsys.readouterr().err


def test_cli_run_and_report(tmp_path, capsys):
    out = str(tmp_path)
    assert cli.main(["run", "--scenario", "sram_smoke", "--device", "cpu",
                     "--smoke", "--out", out]) == 0
    assert (tmp_path / "sram_smoke" / "result.json").exists()
    assert cli.main(["report", "--out", out]) == 0
    assert "sram_smoke" in (tmp_path / "summary.md").read_text()
    assert cli.main(["run", "--scenario", "table3_reduced_rram", "--device",
                     "cpu", "--smoke", "--out", out]) == 0
    assert "by GA; hits: GA 3/5" in capsys.readouterr().out
    assert cli.main(["report", "--out", out]) == 0
    summary = (tmp_path / "summary.md").read_text()
    assert "## Algorithm comparison (Table 3 / §III-C1)" in summary
    assert "### `table3_reduced_rram`" in summary
    assert "| table3_reduced_rram |" not in summary  # not in the main table
    assert cli.main(["list"]) == 0


def test_default_device_is_cuda_and_never_falls_back(tmp_path):
    """Entry points default to device='cuda'; without a CUDA device they
    raise instead of running on the CPU."""
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_scenario(get_scenario("rram_smoke"), out_dir=str(tmp_path))
    assert cli.main(["run", "--scenario", "rram_smoke", "--out",
                     str(tmp_path)]) == 2
    assert not (tmp_path / "rram_smoke").exists()
    cfg = get_config("qwen3_4b", reduced=True)
    model = init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(model, cfg)
    assert serve_cli.main(["--reduced"]) == 2


def test_serve_launcher_on_cpu(capsys):
    """``python -m repro_torch.launch.serve --reduced --device cpu``: the
    reference launcher's flags and output, on the port."""
    assert serve_cli.main(["--reduced", "--device", "cpu", "--requests",
                           "3", "--max-new", "4"]) == 0
    out = capsys.readouterr().out
    assert "served 3 requests, 12 tokens" in out and "on cpu" in out


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    rel = {str(f.relative_to(ROOT / "src" / "repro_torch")) for f in files}
    # the second and third slices' modules are among those scanned
    assert {"configs/__init__.py", "configs/qwen3_4b.py",
            "models/config.py", "examples/codesign_lm_archs.py",
            "kernels/imc_matmul.py", "kernels/ops.py",
            "kernels/flash_attention.py", "models/layers.py",
            "models/attention.py", "models/transformer.py",
            "serve/engine.py", "launch/serve.py", "core/nsga.py",
            "core/pareto.py"} <= rel
    assert len(files) > 30
    return [*files, ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    """AST scan of every module of the port and of chip_smoke.py: no
    ``jax``/``jaxlib`` and no ``repro``/``repro.*`` import
    (``repro_torch`` is allowed)."""
    banned = ("jax", "jaxlib", "repro")
    for path in _port_sources():
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:  # relative: stays inside the package
                    continue
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                top = mod.split(".")[0]
                assert top not in banned, f"{path}: imports {mod}"
