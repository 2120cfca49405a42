"""Registry scenarios end to end on the CPU, the port against the JAX
runner at the smoke budget with backend 'ref': the joint co-search
(``joint_rram_resnet_family``, ``joint_rram_vit_family``), the NSGA-II
fronts (``rram_tech_cost_mo``, ``sram_tech_cost_mo``,
``joint_rram_mo``), the post-hoc EDAP × cost fronts
(``rram_tech_cost``, ``sram_tech_cost``), and one scenario each of the
plain GA, random search, the large set and the single workload.

Both packages must write the same files; the designs are equal (the
generalized design, the specific ones, ``joint`` and every Pareto-front
design); every other number is within rtol 1e-5, or 1e-4 where accuracy
is scored. A generalization gap is a percentage ``100 (g / s - 1)``
whose size near 0 says nothing of its error, so it is held at the same
rtol as the ratio ``g / s`` it comes from."""
import dataclasses
import json
import math
import os

import pytest
import torch

from repro.experiments import get_scenario as jget_scenario
from repro.experiments import run_scenario as jrun_scenario
from repro_torch.experiments import get_scenario, run_scenario

torch.set_num_threads(1)

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
        parts = path.split(".")
        if "design" in parts[-2:] or "arch_params" in parts[-2:]:
            assert a == b, path
        elif not math.isfinite(a):
            assert a == b or (math.isnan(a) and math.isnan(b)), path
        elif "_pct" in path:
            assert math.isclose(1 + a / 100, 1 + b / 100, rel_tol=rtol,
                                abs_tol=0.0), f"{path}: {a} vs {b}"
        else:
            assert math.isclose(a, b, rel_tol=rtol, abs_tol=0.0), \
                f"{path}: {a} vs {b}"
    else:
        assert a == b, f"{path}: {a!r} vs {b!r}"


def _designs_equal(a, b):
    assert a["generalized"]["design"] == b["generalized"]["design"]
    for w in a.get("specific", {}):
        assert a["specific"][w]["design"] == b["specific"][w]["design"], w
    assert a.get("joint") == b.get("joint")
    fa = a.get("pareto", {}).get("front", [])
    fb = b.get("pareto", {}).get("front", [])
    assert [p["design"] for p in fa] == [p["design"] for p in fb]


@pytest.mark.parametrize("name,rtol", [
    ("joint_rram_resnet_family", 1e-4), ("joint_rram_vit_family", 1e-4),
    ("joint_rram_mo", 1e-4), ("rram_tech_cost_mo", 1e-5),
    ("sram_tech_cost_mo", 1e-5), ("rram_tech_cost", 1e-5),
    ("sram_tech_cost", 1e-5), ("rram_small_set_plain", 1e-5),
    ("sram_small_set_random", 1e-5), ("sram_large_set", 1e-5),
    ("rram_single", 1e-5)])
def test_scenario_matches_reference(tmp_path, name, rtol):
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
    if name.startswith("joint"):
        assert res["joint"]["chosen_models"]
    if "tech_cost" in name:
        assert res["pareto"]["front"]
        assert res["pareto"]["searched"] == name.endswith("_mo")
    # served from the cache on a re-run with the same key
    again = run_scenario(sc, out_dir=str(tmp_path / "torch"), device="cpu")
    assert again["cached"] is True


@pytest.mark.parametrize("name", ["rram_small_set", "rram_small_set_plain"])
def test_sequential_rram_specific_baselines_match_reference(tmp_path, name):
    """With ``specific_fanout=False`` the RRAM specific baselines run one
    host-driven search per (seed, workload), their initial pools drawn
    by the host capacity filter's rejection loop, as the reference's
    ``run_specific_sequential`` does: the same designs, EDAP within rtol
    1e-5 and the gap held through its ratio ``1 + pct/100``."""
    budget = dict(p_h=40, p_e=12, p_ga=8, generations=2, n_seeds=1)
    wls = ("alexnet", "resnet18")
    ref_sc = jget_scenario(name)
    ref_sc = dataclasses.replace(
        ref_sc, workloads=wls, backend="ref",
        budget=dataclasses.replace(ref_sc.budget, **budget))
    sc = get_scenario(name)
    sc = dataclasses.replace(sc, workloads=wls, backend="ref",
                             budget=dataclasses.replace(sc.budget, **budget))
    a = jrun_scenario(ref_sc, out_dir=str(tmp_path / "jax"), n_seeds=1,
                      specific_fanout=False)
    b = run_scenario(sc, out_dir=str(tmp_path / "torch"), n_seeds=1,
                     specific_fanout=False, device="cpu")
    assert set(a["specific"]) == set(wls)
    _designs_equal(a, b)
    for w in wls:
        _compare(a["specific"][w], b["specific"][w], 1e-5, f"specific.{w}")
    _compare(a["gap"], b["gap"], 1e-5, "gap")
