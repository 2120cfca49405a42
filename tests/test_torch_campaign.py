"""The port's campaign engine (repro_torch/experiments/campaign.py) and
lane batching (repro_torch/core/distributed.py) on the CPU.

  * the generation and lane tiers cover every count, bounded, monotone;
  * generation padding with ``active`` is bitwise the unpadded run for
    the GA, NSGA-II and each baseline optimizer (a sweep, and a
    hypothesis property), and lanes with different schedules in one
    batch are bitwise each lane alone;
  * the bucket-callable cache is an LRU with live counters;
  * the result cache is schema-versioned;
  * the campaign writes result.json and specific_*.json byte-identical,
    modulo timing fields, to the sequential runner; a bucket shared by
    two scenarios builds one callable per lane flavor;
  * the stats, their render and summary.md section, the kernel-build
    cache index;
  * lanes split over [cpu, cpu] are bitwise the one-device run;
  * the port's campaign against the JAX campaign (same genomes and
    designs, numbers within rtol 1e-5, the EDAP tolerance of
    tests/test_torch_scenarios.py), and ``run --all --smoke`` of both
    CLIs on a two-scenario registry.
"""
import dataclasses
import json
import math
import os

import pytest
import torch

from repro_torch import random as jr
from repro_torch.core import baselines, distributed, genetic, nsga
from repro_torch.core.genetic import cards_of, lanes_of
from repro_torch.core.nsga import lanes_of_vec
from repro_torch.core.objectives import make_objective
from repro_torch.core.scoring import ScorerSpec, build_scorer, sharded_score_fn
from repro_torch.core.search_space import sram_space
from repro_torch.core.workloads import get_workload_set, pack
from repro_torch.experiments import __main__ as cli
from repro_torch.experiments import campaign, report, runner
from repro_torch.experiments.scenarios import Budget, Scenario
from repro_torch.kernels import build

torch.set_num_threads(1)

TINY_BUDGET = Budget(p_h=16, p_e=8, p_ga=6, generations=1)

TINY = Scenario(name="tiny_campaign", mem="sram",
                workloads=("alexnet", "resnet18"),
                algorithm="fourphase", budget=TINY_BUDGET)
TINY_PLAIN = dataclasses.replace(TINY, name="tiny_campaign_plain",
                                 algorithm="plain")
TINY_MO = dataclasses.replace(TINY, name="tiny_campaign_mo",
                              objective="edap:mean+cost",
                              specific_baselines=False)
TINY_B = dataclasses.replace(TINY, name="tiny_campaign_b")

TIMING_FIELDS = {"wall_time_s", "search_wall_time_s", "sampling_time_s"}


def _strip(d):
    return {k: v for k, v in d.items() if k not in TIMING_FIELDS}


@pytest.fixture(scope="module")
def space_scorer():
    space = sram_space()
    wa = pack(get_workload_set(["alexnet", "resnet18"]))
    sc = build_scorer(space, ScorerSpec(make_objective("edap:mean"),
                                        workloads=wa), device="cpu")
    mo = build_scorer(space,
                      ScorerSpec(make_objective("edap:mean+cost"),
                                 workloads=wa), device="cpu")
    return space, sc, mo


# ---------------------------------------------------------------------------
# shape tiers
# ---------------------------------------------------------------------------


def test_tiers_cover_and_bound():
    for n in list(range(1, 140)) + [200, 300, 1000]:
        for fn in (campaign.gen_tier, campaign.lane_tier):
            t = fn(n)
            assert t >= n
            # padding waste is bounded (< 50% everywhere on the ladder)
            assert t < 2 * n or n == 1


def test_tiers_monotone():
    gens = [campaign.gen_tier(n) for n in range(1, 200)]
    lanes = [campaign.lane_tier(n) for n in range(1, 300)]
    assert gens == sorted(gens)
    assert lanes == sorted(lanes)


# ---------------------------------------------------------------------------
# padding equivalence: bitwise, every engine
# ---------------------------------------------------------------------------


def _padded(sched, tier):
    T = sched.shape[0]
    pad = torch.cat([sched, sched[-1:].expand(tier - T, -1)])
    act = torch.tensor([True] * T + [False] * (tier - T))
    return pad, act


def _sched(gens, phases=genetic.FOUR_PHASES):
    return torch.as_tensor(genetic.phase_schedule(phases, gens))


@pytest.mark.parametrize("pad_to", [5, 8])
def test_ga_padding_bit_identical(space_scorer, pad_to):
    space, sc, _ = space_scorer
    cards = cards_of(space, "cpu")
    sched = _sched(1)  # T=4
    key = jr.PRNGKey(0)[None]
    kw = dict(p_h=16, p_e=8, p_ga=6)
    ref = genetic.search_kernel(key, cards, sched, lanes_of(sc.score), None,
                                **kw)
    pad, act = _padded(sched, pad_to)
    got = genetic.search_kernel(key, cards, pad, lanes_of(sc.score), None,
                                active=act, **kw)
    T = sched.shape[0]
    for r, g in zip(ref[:2], got[:2]):  # best genome, best score
        assert torch.equal(r, g)
    hist = torch.cat([got[2][:, :T], got[2][:, -1:]], dim=1)
    assert torch.equal(ref[2], hist)
    assert torch.equal(ref[3], got[3]) and torch.equal(ref[4], got[4])


def test_nsga_padding_bit_identical(space_scorer):
    space, _, mo = space_scorer
    cards = cards_of(space, "cpu")
    sched = _sched(1)
    key = jr.PRNGKey(3)[None]
    kw = dict(p_h=16, p_e=8, p_ga=6)
    ref = nsga.nsga_search_kernel(key, cards, sched,
                                  lanes_of_vec(mo.score_vec), None, **kw)
    pad, act = _padded(sched, 6)
    got = nsga.nsga_search_kernel(key, cards, pad,
                                  lanes_of_vec(mo.score_vec), None,
                                  active=act, **kw)
    T = sched.shape[0]
    for r, g in zip(ref[:3], got[:3]):  # pop, scores, ranks
        assert torch.equal(r, g)
    assert torch.equal(ref[3], got[3][:, :T + 1])


@pytest.mark.parametrize("alg", baselines.BASELINE_ALGORITHMS)
def test_baseline_padding_bit_identical(space_scorer, alg):
    space, sc, _ = space_scorer
    cards = cards_of(space, "cpu")
    key = jr.PRNGKey(7)[None]
    ref = baselines.baseline_kernel(key, cards, lanes_of(sc.score),
                                    algorithm=alg, pop=8, iters=3)
    act = torch.tensor([True] * 3 + [False] * 3)
    got = baselines.baseline_kernel(key, cards, lanes_of(sc.score),
                                    algorithm=alg, pop=8, iters=6,
                                    active=act)
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])
    assert torch.equal(ref[2], got[2][:, :4])


def test_padding_property_hypothesis(space_scorer):
    """Property form: any (T, tier) pair slices back bitwise."""
    pytest.importorskip("hypothesis")
    from hypothesis import given, settings, strategies as st

    space, sc, _ = space_scorer
    cards = cards_of(space, "cpu")

    @settings(max_examples=10, deadline=None)
    @given(gens=st.integers(1, 2), extra=st.integers(1, 6),
           seed=st.integers(0, 2**31 - 1))
    def prop(gens, extra, seed):
        sched = _sched(gens)
        key = jr.PRNGKey(seed)[None]
        kw = dict(p_h=12, p_e=8, p_ga=6)
        ref = genetic.search_kernel(key, cards, sched, lanes_of(sc.score),
                                    None, **kw)
        pad, act = _padded(sched, sched.shape[0] + extra)
        got = genetic.search_kernel(key, cards, pad, lanes_of(sc.score),
                                    None, active=act, **kw)
        assert torch.equal(ref[0], got[0]) and torch.equal(ref[1], got[1])

    prop()


@pytest.mark.parametrize("engine", ["ga", "nsga"])
def test_lanes_with_different_schedules(space_scorer, engine):
    """Lanes of 5 and 6 plain-GA generations padded to one tier in one
    batch ((L, T, 4) schedules, an (L, T) mask) are each bitwise the
    lane run alone on its own schedule."""
    space, sc, mo = space_scorer
    cards = cards_of(space, "cpu")
    kw = dict(p_h=16, p_e=8, p_ga=6)
    if engine == "ga":
        def run(keys, sched, active=None):
            return genetic.search_kernel(keys, cards, sched,
                                         lanes_of(sc.score), None,
                                         active=active, **kw)
    else:
        def run(keys, sched, active=None):
            return nsga.nsga_search_kernel(keys, cards, sched,
                                           lanes_of_vec(mo.score_vec), None,
                                           active=active, **kw)
    s5 = _sched(5, (genetic.PLAIN_PHASE,))
    s6 = _sched(6, genetic.FOUR_PHASES[:1])
    keys = torch.stack([jr.PRNGKey(11), jr.PRNGKey(12)])
    p5, a5 = _padded(s5, 6)
    got = run(keys, torch.stack([p5, s6]),
              torch.stack([a5, torch.ones(6, dtype=torch.bool)]))
    alone = [run(keys[:1], s5), run(keys[1:], s6)]
    n_keep = 2 if engine == "ga" else 3   # (best g, best s) / (pop, s, r)
    for lane, ref in enumerate(alone):
        for j in range(n_keep):
            assert torch.equal(got[j][lane], ref[j][0]), (lane, j)


# ---------------------------------------------------------------------------
# the in-process cache: LRU bound + counters
# ---------------------------------------------------------------------------


def test_cached_compile_lru_eviction(monkeypatch):
    monkeypatch.setattr(distributed, "KERNEL_CACHE_MAXSIZE", 3)
    distributed.kernel_cache_clear()
    built = []

    def use(key):
        return distributed.cached_compile(
            key, lambda: built.append(key) or key)

    for k in ("a", "b", "c"):
        use(k)
    assert distributed.kernel_cache_stats() == {
        "hits": 0, "misses": 3, "evictions": 0, "size": 3}
    use("a")                      # refresh "a" -> "b" is now LRU
    use("d")                      # evicts "b"
    st = distributed.kernel_cache_stats()
    assert st["evictions"] == 1 and st["size"] == 3
    assert st["hits"] == 1 and st["misses"] == 4
    use("b")                      # rebuilt: it was evicted
    assert built == ["a", "b", "c", "d", "b"]
    distributed.kernel_cache_clear()
    assert distributed.kernel_cache_stats()["size"] == 0


# ---------------------------------------------------------------------------
# schema-versioned result cache
# ---------------------------------------------------------------------------


def test_result_cache_schema_version(tmp_path):
    out = str(tmp_path)
    r1 = runner.run_scenario(TINY, out_dir=out, n_seeds=1, device="cpu")
    assert r1["schema_version"] == runner.RESULT_SCHEMA_VERSION
    r2 = runner.run_scenario(TINY, out_dir=out, n_seeds=1, device="cpu")
    assert r2["cached"]
    # a stale-schema entry recomputes
    path = os.path.join(out, TINY.name, "result.json")
    with open(path) as f:
        doc = json.load(f)
    doc["schema_version"] = runner.RESULT_SCHEMA_VERSION - 1
    with open(path, "w") as f:
        json.dump(doc, f)
    assert runner.load_cached_result(TINY, out, TINY.seed, 1, "cpu") is None
    r3 = runner.run_scenario(TINY, out_dir=out, n_seeds=1, device="cpu")
    assert not r3["cached"]
    del doc["schema_version"]     # legacy entry: no field at all
    with open(path, "w") as f:
        json.dump(doc, f)
    assert runner.load_cached_result(TINY, out, TINY.seed, 1, "cpu") is None


# ---------------------------------------------------------------------------
# campaign vs sequential: identical results
# ---------------------------------------------------------------------------


def _same_files(d_seq, d_camp, name):
    with open(os.path.join(d_seq, name, "result.json")) as f:
        a = _strip(json.load(f))
    with open(os.path.join(d_camp, name, "result.json")) as f:
        b = _strip(json.load(f))
    assert a == b, f"{name} diverged"
    for fn in sorted(os.listdir(os.path.join(d_seq, name))):
        if fn.startswith("specific_"):
            with open(os.path.join(d_seq, name, fn)) as f:
                x = f.read()
            with open(os.path.join(d_camp, name, fn)) as f:
                y = f.read()
            assert x == y, fn


def test_campaign_matches_sequential(tmp_path):
    scs = [TINY, TINY_PLAIN, TINY_MO]
    d_seq, d_camp = str(tmp_path / "seq"), str(tmp_path / "camp")
    for sc in scs:
        runner.run_scenario(sc, out_dir=d_seq, n_seeds=2, device="cpu")
    results, stats = campaign.run_campaign(scs, out_dir=d_camp, n_seeds=2,
                                           device="cpu")
    for sc in scs:
        _same_files(d_seq, d_camp, sc.name)
    assert stats["n_bucketed"] == 3
    assert [r["scenario"] for r in results] == [s.name for s in scs]
    # re-running serves every scenario from the result cache
    _, stats2 = campaign.run_campaign(scs, out_dir=d_camp, n_seeds=2,
                                      device="cpu")
    assert stats2["n_cached"] == 3 and stats2["n_buckets"] == 0


def test_campaign_mixed_generations_match_sequential(tmp_path):
    """Scenarios of 5 and 6 generations a phase share a bucket (tier 24:
    per-lane schedules, padded rows masked, 3 + 3 seeds as lanes), GA
    with specific baselines and NSGA-II: each result.json and
    specific_*.json equals its sequential run's."""
    b5 = dataclasses.replace(TINY_BUDGET, generations=5)
    b6 = dataclasses.replace(TINY_BUDGET, generations=6)
    scs = [dataclasses.replace(TINY, name="g5", budget=b5),
           dataclasses.replace(TINY, name="g6", budget=b6),
           dataclasses.replace(TINY_MO, name="m5", budget=b5),
           dataclasses.replace(TINY_MO, name="m6", budget=b6)]
    d_seq, d_camp = str(tmp_path / "seq"), str(tmp_path / "camp")
    for sc in scs:
        runner.run_scenario(sc, out_dir=d_seq, n_seeds=3, device="cpu")
    _, stats = campaign.run_campaign(scs, out_dir=d_camp, n_seeds=3,
                                     device="cpu")
    assert [(b["scenarios"], b["gen_tier"]) for b in stats["buckets"]] == [
        (["g5", "g6"], 24), (["m5", "m6"], 24)]
    for sc in scs:
        _same_files(d_seq, d_camp, sc.name)


def test_sequential_specific_baselines_equal_fanout():
    """``specific_fanout=False`` searches each (seed, workload) specific
    baseline alone with a single-workload pack; on SRAM (no capacity
    filter) it finds the fan-out's designs, EDAPs and gap exactly."""
    a = runner.run_scenario(TINY, write=False, n_seeds=2, device="cpu")
    b = runner.run_scenario(TINY, write=False, n_seeds=2, device="cpu",
                            specific_fanout=False)
    assert a["specific"] == b["specific"] and a["gap"] == b["gap"]


def test_campaign_buckets_share_kernel(tmp_path):
    """Two scenarios identical up to the name land in one bucket and
    build one callable per lane flavor: one generalized-search, one
    specific-baseline — not one pair per scenario."""
    distributed.kernel_cache_clear()
    results, stats = campaign.run_campaign(
        [TINY, TINY_B], out_dir=str(tmp_path), n_seeds=1, device="cpu")
    assert stats["n_buckets"] == 1
    b = stats["buckets"][0]
    assert b["scenarios"] == [TINY.name, TINY_B.name]
    # 2 scenarios x (1 generalized + 2 specific lanes) = 6 lanes
    assert b["lanes"] == 6
    assert stats["kernel_cache"]["misses"] == 2
    assert stats["kernel_cache"]["hits"] == 0
    # same seed + same scorer => the shared-bucket runs are identical
    assert (_strip(results[0]) | {"scenario": TINY_B.name}
            == _strip(results[1]))


def test_campaign_stats_schema_and_render(tmp_path):
    _, stats = campaign.run_campaign([TINY], out_dir=str(tmp_path),
                                     n_seeds=1, force=True, device="cpu")
    for k in ("n_scenarios", "n_buckets", "scenarios_per_sec",
              "kernel_cache", "persistent_cache", "buckets"):
        assert k in stats
    text = report.render_campaign_stats(stats)
    assert "Campaign execution" in text
    assert "scenarios/s" in text
    loaded = report.load_campaign_stats(str(tmp_path))
    assert loaded is not None
    assert loaded["n_scenarios"] == 1
    summary = report.write_summary(str(tmp_path))
    assert "## Campaign execution" in summary


def test_campaign_persistent_cache_index(tmp_path):
    cache_dir = str(tmp_path / "kernel_cache")
    out = str(tmp_path / "results")
    before = build.BUILD_DIR
    try:
        _, s1 = campaign.run_campaign([TINY], out_dir=out, n_seeds=1,
                                      force=True, compile_cache=cache_dir,
                                      device="cpu")
        pc1 = s1["persistent_cache"]
        assert pc1["enabled"] and pc1["signature_misses"] == 1
        assert os.path.exists(os.path.join(cache_dir,
                                           "campaign_index.json"))
        assert build.BUILD_DIR == (tmp_path / "kernel_cache").resolve()
        # the signature index recognizes the bucket next invocation; the
        # CPU builds no kernel library
        _, s2 = campaign.run_campaign([TINY], out_dir=out, n_seeds=1,
                                      force=True, compile_cache=cache_dir,
                                      device="cpu")
        pc2 = s2["persistent_cache"]
        assert pc2["signature_hits"] == 1 and pc2["signature_misses"] == 0
        assert pc2["entries_after"] == pc2["entries_before"] == 0
    finally:
        # tmp_path is deleted after the test: point the builds back
        build.set_build_dir(before)


# ---------------------------------------------------------------------------
# lanes over several devices
# ---------------------------------------------------------------------------


def test_compile_batched_search_splits_lanes(space_scorer):
    """[cpu, cpu]: lanes 0-1 on the first device, 2-3 on the second,
    joined in lane order; bitwise the one-device call; an indivisible
    lane count is refused."""
    space, sc, _ = space_scorer
    sched = _sched(1)
    calls = []

    def one(dev, keys, schedule, active):
        calls.append((str(dev), keys.shape[0]))
        return genetic.search_kernel(
            keys, cards_of(space, dev), schedule, lanes_of(sc.score), None,
            p_h=16, p_e=8, p_ga=6, active=active)

    keys = torch.stack([jr.PRNGKey(s) for s in range(4)])
    lanes = (keys, sched.expand(4, -1, -1), None)
    want = distributed.compile_batched_search(one, ["cpu"])(*lanes)
    got = distributed.compile_batched_search(one, ["cpu", "cpu"])(*lanes)
    assert calls == [("cpu", 4), ("cpu", 2), ("cpu", 2)]
    for w, g in zip(want, got):
        assert torch.equal(w, g)
    with pytest.raises(ValueError, match="do not split"):
        distributed.compile_batched_search(one, ["cpu", "cpu"])(
            keys[:3], sched.expand(3, -1, -1), None)
    assert distributed.search_devices(4, "cpu") == [torch.device("cpu")]


def test_runner_and_campaign_split_over_devices(tmp_path, monkeypatch):
    """The runner and the campaign with two CPU devices present (2 seeds
    and 4 specific lanes split in halves) write the one-device files;
    ``sharded_score_fn`` splits population rows the same way."""
    d_one, d_two = str(tmp_path / "one"), str(tmp_path / "two")
    runner.run_scenario(TINY, out_dir=d_one, n_seeds=2, device="cpu")
    splits = []
    real = distributed.compile_batched_search

    def spy(one, devices=None):
        splits.append(len(devices))
        return real(one, devices)
    monkeypatch.setattr(distributed, "lane_devices",
                        lambda device="cuda": [torch.device("cpu")] * 2)
    monkeypatch.setattr(runner, "compile_batched_search", spy)
    monkeypatch.setattr(campaign, "compile_batched_search", spy)
    runner.run_scenario(TINY, out_dir=d_two + "_seq", n_seeds=2,
                        device="cpu")
    _same_files(d_one, d_two + "_seq", TINY.name)
    campaign.run_campaign([TINY], out_dir=d_two, n_seeds=2, device="cpu")
    _same_files(d_one, d_two, TINY.name)
    assert splits and set(splits) == {2}
    space = sram_space()
    wa = pack(get_workload_set(["alexnet", "resnet18"]))
    sc = build_scorer(space, ScorerSpec(make_objective("edap:mean"),
                                        workloads=wa), device="cpu")
    g = torch.stack([jr.randint(jr.PRNGKey(5), (10,), 0, int(c))
                     for c in space.cardinalities], dim=1)
    for fn in (sc, sc.score):
        assert torch.equal(sharded_score_fn(fn, ["cpu", "cpu"])(g),
                           sc.score(g))
    assert sc.on("cpu") is sc


# ---------------------------------------------------------------------------
# the port's campaign against the JAX campaign
# ---------------------------------------------------------------------------

def _compare(a, b, rtol, path="result"):
    """Same keys, equal non-floats and designs, floats within rtol (a
    gap percentage through its ratio 1 + pct/100)."""
    skip = TIMING_FIELDS | {"cached", "device"}
    if isinstance(a, dict):
        assert isinstance(b, dict), path
        ka, kb = set(a) - skip, set(b) - skip
        assert ka == kb, f"{path}: keys {sorted(ka ^ kb)}"
        for k in sorted(ka):
            _compare(a[k], b[k], rtol, f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _compare(x, y, rtol, f"{path}[{i}]")
    elif isinstance(a, float) and not isinstance(b, bool):
        if "design" in path.split(".")[-2:]:
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


def _jax_twin(sc):
    from repro.experiments.scenarios import Budget as JBudget
    from repro.experiments.scenarios import Scenario as JScenario
    d = dataclasses.asdict(sc)
    d["budget"] = JBudget(**d["budget"])
    d["smoke_budget"] = JBudget(**d["smoke_budget"])
    return JScenario(**d)


def _same_as_jax(d_jax, d_port, name, rtol=1e-5):
    files = sorted(os.listdir(os.path.join(d_jax, name)))
    assert files == sorted(os.listdir(os.path.join(d_port, name)))
    for fn in files:
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(d_jax, name, fn)) as f:
            a = json.load(f)
        with open(os.path.join(d_port, name, fn)) as f:
            b = json.load(f)
        if fn == "result.json":
            assert a["generalized"]["design"] == b["generalized"]["design"]
            for w in a.get("specific", {}):
                assert (a["specific"][w]["design"]
                        == b["specific"][w]["design"]), w
            fa = a.get("pareto", {}).get("front", [])
            fb = b.get("pareto", {}).get("front", [])
            assert [p["design"] for p in fa] == [p["design"] for p in fb]
        _compare(a, b, rtol, f"{name}/{fn}")


def test_campaign_matches_jax_campaign(tmp_path):
    """TINY, TINY_PLAIN and TINY_MO (backend 'ref' on both sides, 2
    seeds) through both campaign engines: the same files, genomes and
    front designs, every number within rtol 1e-5."""
    from repro.experiments import campaign as jcampaign
    scs = [dataclasses.replace(s, backend="ref")
           for s in (TINY, TINY_PLAIN, TINY_MO)]
    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "torch")
    _, jstats = jcampaign.run_campaign([_jax_twin(s) for s in scs],
                                       out_dir=d_jax, n_seeds=2)
    _, stats = campaign.run_campaign(scs, out_dir=d_port, n_seeds=2,
                                     device="cpu")
    for key in ("n_buckets", "lanes_total", "lanes_padded"):
        assert stats[key] == jstats[key], key
    for sc in scs:
        _same_as_jax(d_jax, d_port, sc.name)


def test_cli_run_all_matches_jax_cli(tmp_path, monkeypatch, capsys):
    """``run --all --smoke --backend ref`` of both CLIs over a
    two-scenario registry (``sram_smoke``, ``rram_smoke``): the same
    files and designs within rtol 1e-5, campaign_stats.json written and
    rendered by ``report``; ``show`` prints a scenario's config."""
    from repro.experiments import __main__ as jcli
    names = ("sram_smoke", "rram_smoke")
    monkeypatch.setattr(cli, "REGISTRY",
                        {n: cli.REGISTRY[n] for n in names})
    monkeypatch.setattr(jcli, "REGISTRY",
                        {n: jcli.REGISTRY[n] for n in names})
    d_jax, d_port = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jcli.main(["run", "--all", "--smoke", "--backend", "ref",
                      "--out", d_jax]) == 0
    assert cli.main(["run", "--all", "--smoke", "--backend", "ref",
                     "--device", "cpu", "--out", d_port]) == 0
    out = capsys.readouterr().out
    assert "campaign: 2 scenarios in 2 buckets" in out
    for n in names:
        _same_as_jax(d_jax, d_port, n)
    assert os.path.exists(os.path.join(d_port, "campaign_stats.json"))
    assert cli.main(["report", "--out", d_port]) == 0
    assert "## Campaign execution" in capsys.readouterr().out
    assert cli.main(["run", "--all", "--sequential", "--smoke", "--backend",
                     "ref", "--device", "cpu", "--out", d_port]) == 0
    assert capsys.readouterr().out.count("[cached]") == 2
    assert cli.main(["run", "--out", d_port]) == 2
    assert cli.main(["show", "--scenario", "rram_smoke"]) == 0
    assert json.loads(capsys.readouterr().out)["name"] == "rram_smoke"
