"""The Table 3 algorithm comparison end to end on the CPU, the port
against the JAX runner at the smoke budget: ``table3_reduced_rram``
(the reduced §III-C1 space, exhaustive ground truth) and
``alg_compare_rram`` (the full RRAM space, the real constrained
objective, SRES with the graded penalty channel).

Both packages must write the same files with the same result schema;
the designs are equal (the ground truth's and each algorithm's best),
and so are ``hits``, ``n_feasible``, ``evaluations`` and
``best_algorithm``; every per-seed best score is within rtol 1e-5.
Each algorithm's per-seed best genomes, from its lane batch on the
scenario's scorer, equal the reference's seed by seed. The JAX side is
built once per module."""
import dataclasses
import json
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.experiments import get_scenario as jget_scenario
from repro.experiments import run_scenario as jrun_scenario
from repro.experiments import runner as jrunner
from repro.core import baselines as jb
from repro.core import genetic as jgen
from repro_torch import random as jr
from repro_torch.core import baselines as tb
from repro_torch.core import genetic as tgen
from repro_torch.experiments import get_scenario, run_scenario, runner

torch.set_num_threads(1)

NAMES = ("table3_reduced_rram", "alg_compare_rram")
# fields that differ between runs of the same computation, plus the
# port's device block (the reference has none)
TIMING_FIELDS = {"wall_time_s", "mean_wall_time_s", "cached", "device"}


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
        if "design" in path.split(".")[-2]:
            assert a == b, path
        elif math.isfinite(a):
            assert math.isclose(a, b, rel_tol=rtol, abs_tol=0.0), \
                f"{path}: {a} vs {b}"
        else:
            assert a == b or (math.isnan(a) and math.isnan(b)), path
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _smoke(sc):
    return dataclasses.replace(sc, budget=sc.smoke_budget)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX runner's artifacts of both scenarios at the smoke budget."""
    out = tmp_path_factory.mktemp("jax")
    return out, {n: jrun_scenario(_smoke(jget_scenario(n)), out_dir=str(out))
                 for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_scenario_matches_reference(tmp_path, reference, name):
    ref_dir, ref = reference
    res = run_scenario(_smoke(get_scenario(name)), out_dir=str(tmp_path),
                       device="cpu")
    assert res["device"] == {"type": "cpu", "name": "cpu", "count": 1}
    files = sorted(os.listdir(ref_dir / name))
    assert files == sorted(os.listdir(tmp_path / name)) == ["report.md",
                                                           "result.json"]
    a = json.loads((ref_dir / name / "result.json").read_text())
    b = json.loads((tmp_path / name / "result.json").read_text())
    _compare(a, b, 1e-5)
    assert b["best_algorithm"] == ref[name]["best_algorithm"]
    assert a["ground_truth"]["exhaustive"] == (name == NAMES[0])
    for alg, x in a["algorithms"].items():
        y = b["algorithms"][alg]
        for k in ("hits", "n_feasible", "evaluations", "best_design"):
            assert x[k] == y[k], (alg, k)
    assert "Algorithm comparison (Table 3)" in (
        tmp_path / name / "report.md").read_text()
    # served from the cache on a re-run with the same key
    again = run_scenario(_smoke(get_scenario(name)), out_dir=str(tmp_path),
                         device="cpu")
    assert again["cached"] is True


def _scorers(name):
    """Each package's scorer (and SRES penalty channel) of the scenario,
    as run_alg_compare builds them."""
    jsc, sc = _smoke(jget_scenario(name)), _smoke(get_scenario(name))
    jst, st = jrunner.setup_scenario(jsc), runner.setup_scenario(sc)
    if sc.reduced_space:
        return (jst.space, jrunner.make_landscape_scorer(
                    jst.space, jst.wa, jst.objective), None,
                st.space, runner.make_landscape_scorer(
                    st.space, st.wa, st.objective, device="cpu"), None, sc)
    jt = jrunner.build_scorer(jst.space, jrunner.ScorerSpec(
        jst.objective, workloads=jst.wa), budget=jsc.budget)
    t = runner.build_scorer(st.space, runner.ScorerSpec(
        st.objective, workloads=st.wa), device="cpu")
    return (jst.space, jt.score,
            jrunner.make_infeasibility_penalty(jt, jst.objective),
            st.space, t.score,
            runner.make_infeasibility_penalty(t, st.objective), sc)


@pytest.mark.parametrize("name", NAMES)
def test_per_seed_genomes_match_reference(name):
    """Every algorithm's 5 seeds at the smoke budget (8 designs, 12
    iterations): the same best genome seed by seed, the best score
    within rtol 1e-5, the same evaluation count."""
    jspace, jscore, jpen, space, score, pen, sc = _scorers(name)
    seeds = [sc.seed + i for i in range(sc.budget.n_seeds)]
    pop, iters = sc.budget.p_ga, sc.budget.total_generations
    jkeys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    keys = torch.stack([jr.PRNGKey(s) for s in seeds])
    for alg in ("ga",) + tb.BASELINE_ALGORITHMS:
        if alg == "ga":
            kw = dict(p_h=pop, p_e=pop, p_ga=pop,
                      generations_per_phase=iters,
                      phases=(jgen.PLAIN_PHASE,), hamming_sampling=False)
            want = jgen.batched_joint_search(jkeys, jspace, jscore, **kw)
            kw["phases"] = (tgen.PLAIN_PHASE,)
            got = tgen.batched_joint_search(keys, space, score, **kw)
        else:
            want = jb.batched_baseline_search(
                jkeys, jspace, jscore, alg, pop=pop, iters=iters,
                penalty_fn=jpen if alg == "sres" else None)
            got = tb.batched_baseline_search(
                keys, space, score, alg, pop=pop, iters=iters,
                penalty_fn=pen if alg == "sres" else None)
            assert got.evaluations == want.evaluations
        np.testing.assert_array_equal(got.best_genomes,
                                      np.asarray(want.best_genomes),
                                      err_msg=alg)
        np.testing.assert_allclose(got.best_scores,
                                   np.asarray(want.best_scores), rtol=1e-5,
                                   err_msg=alg)
