"""The port's co-design launchers against the reference's:
``repro_torch.launch.search`` (flags -> Scenario field by field, and the
printed report of a registry scenario and of an ad-hoc flag run),
``repro_torch.launch.codesign_serve`` (a burst plus the verified cached
replay) and ``repro_torch.examples.quickstart`` (the same best genome as
``examples/quickstart.py``), all on the CPU. Scores are held at rtol
1e-5 (the port's EDAP bound), designs and genomes exactly."""
import argparse
import dataclasses
import json
import runpy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.launch import search as jsearch
from repro_torch.examples import quickstart
from repro_torch.experiments import get_scenario, run_scenario
from repro_torch.launch import codesign_serve
from repro_torch.launch import search

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def _args(argv):
    return search.parser().parse_args(argv)


@pytest.mark.parametrize("spec", ["paper4", "paper9", "archs",
                                  "resnet18,vgg16"])
def test_build_workload_spec_matches_reference(spec):
    names, source = search.build_workload_spec(spec)
    jnames, jsource = jsearch.build_workload_spec(spec)
    assert (tuple(names), source) == (tuple(jnames), jsource)


@pytest.mark.parametrize("argv", [
    ["--workloads", "paper4"],
    ["--workloads", "paper9", "--mem", "sram", "--agg", "mean"],
    ["--workloads", "archs", "--seq", "256", "--algorithm", "plain"],
    ["--workloads", "resnet18,alexnet", "--tech-variable",
     "--specific-baselines", "--seed", "3"],
    ["--workloads", "qwen3_4b,xlstm_350m", "--tech-variable",
     "--generations", "2", "--pga", "8", "--ph", "40", "--pe", "16"],
])
def test_scenario_from_args_matches_reference(argv):
    """The same flags build the reference's Scenario, field by field
    (pure: no search)."""
    args = _args(argv)
    sc = search.scenario_from_args(args)
    jsc = jsearch.scenario_from_args(argparse.Namespace(**{
        k: v for k, v in vars(args).items() if k != "device"}))
    got, want = dataclasses.asdict(sc), dataclasses.asdict(jsc)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, tuple):
            g, w = tuple(g), tuple(w)
        assert g == w, k


def _port_report(argv, capsys):
    assert search.main(argv + ["--device", "cpu"]) == 0
    return json.loads(capsys.readouterr().out)


def _jax_report(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["search"] + argv)
    jsearch.main()
    return json.loads(capsys.readouterr().out)


@pytest.mark.parametrize("argv", [
    ["--scenario", "sram_smoke"],
    ["--mem", "sram", "--workloads", "alexnet", "--generations", "1",
     "--pga", "8", "--ph", "40", "--pe", "16"],
])
def test_search_report_matches_reference(argv, capsys, monkeypatch):
    """The port's launcher prints the reference's report keys, its best
    design and its best score (rtol 1e-5)."""
    got = _port_report(argv, capsys)
    want = _jax_report(argv, capsys, monkeypatch)
    assert set(got) == set(want)
    assert got["scenario"] == want["scenario"]
    assert got["best_design"] == want["best_design"]
    np.testing.assert_allclose(got["best_score"], want["best_score"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["area_mm2"], want["area_mm2"],
                               rtol=1e-5)


def test_search_launcher_equals_runner_bitwise(capsys):
    """The same seed gives a bit-identical best_score through the
    launcher and through ``run_scenario`` (the experiments CLI's path)."""
    got = _port_report(["--scenario", "sram_smoke"], capsys)
    res = run_scenario(get_scenario("sram_smoke"), write=False,
                       device="cpu")
    assert got["best_score"] == res["best_score"]
    assert got["best_design"] == res["generalized"]["design"]


def test_launchers_default_to_cuda(capsys):
    """Without --device each launcher runs on cuda: without a GPU it
    exits 2 instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert search.main(["--scenario", "sram_smoke", "--device",
                            "cuda:99"]) != 0
        return
    assert search.main(["--scenario", "sram_smoke"]) == 2
    assert codesign_serve.main(["--requests", "1", "--smoke"]) == 2
    assert quickstart.main([]) == 2
    assert capsys.readouterr().err.count("no CUDA device") == 3


def test_codesign_serve_verifies_cached_replay(tmp_path, capsys):
    rc = codesign_serve.main(["--device", "cpu", "--requests", "2",
                              "--smoke", "--out", str(tmp_path),
                              "--window", "0.05"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "replay: 2 requests served from the result cache, payloads " \
        "equal" in out
    assert "-- codesign service stats" in out
    assert "4 submitted / 4 completed" in out


def test_codesign_serve_render_and_strip():
    from repro_torch.api import ServiceStats
    st = ServiceStats(**{f.name: 0 for f in
                         dataclasses.fields(ServiceStats)})
    text = codesign_serve.render_stats(st)
    assert text.startswith("-- codesign service stats")
    assert len(text.splitlines()) == 8
    r = {"best_score": 1.0, "wall_time_s": 2.0, "cached": True}
    assert codesign_serve._strip(r) == {"best_score": 1.0}


def test_quickstart_matches_reference(capsys):
    """The quickstart's search at its own budget (p_h 400, p_e 160,
    p_ga 24, 5 generations a phase, the host capacity filter) finds the
    JAX quickstart's best genome."""
    space, workloads, evaluate, res = quickstart.run("cpu")
    ref = runpy.run_path(str(ROOT / "examples" / "quickstart.py"))
    capsys.readouterr()
    jres = ref["result"]
    np.testing.assert_array_equal(res.best_genome,
                                  np.asarray(jres.best_genome))
    np.testing.assert_allclose(res.best_score, jres.best_score, rtol=1e-5)
    assert space.describe(res.best_genome) == \
        ref["space"].describe(np.asarray(jres.best_genome))
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "best design" in out and out.count(" mJ  latency ") == 4


@pytest.mark.parametrize("hamming", [True, False])
def test_joint_search_host_filter_matches_reference(hamming):
    """``joint_search`` with a host-side capacity filter (the
    quickstart's path: the reference's rejection-loop sampling, then the
    GA) at a cut budget, with and without Hamming sampling: the JAX
    search's best genome."""
    import jax
    import jax.numpy as jnp

    import repro.api as japi
    import repro_torch.api as api
    from repro_torch import random as jr

    budget = dict(p_h=40, p_e=16, p_ga=8, generations_per_phase=1,
                  hamming_sampling=hamming)
    results = []
    for m, key, to_dev, to_np in (
            (japi, jax.random.PRNGKey(0), jnp.asarray, np.asarray),
            (api, jr.PRNGKey(0, "cpu"), torch.as_tensor,
             lambda t: t.cpu().numpy())):
        space = m.get_space("rram")
        evaluate = m.make_evaluator(space, m.pack(m.get_workload_set(
            m.PAPER_4)), **({"device": "cpu"} if m is api else {}))
        objective = m.Objective("edap", aggregation="mean")
        results.append(m.joint_search(
            key, space, lambda g, e=evaluate, o=objective: o(e(g)),
            capacity_filter=lambda g, e=evaluate: to_np(
                e(to_dev(g)).feasible), **budget))
    want, got = results
    np.testing.assert_array_equal(got.best_genome,
                                  np.asarray(want.best_genome))
    np.testing.assert_allclose(got.best_score, want.best_score, rtol=1e-5)
