"""The port's analysis suite (``repro_torch.analysis``) held to the
reference's own cases (tests/test_analysis.py): every AST rule fires
exactly once on its planted fixture and stays silent on clean code, the
suppression file round-trips (with mandatory justifications and the
port's device scopes), the CLI's exit codes, the launch audit's rules
on synthetic entries and its baseline round trip. Plus the port's own
cases: torch host syncs in marked functions, the port's ``random``
module never taken for the stdlib one, R002/R003 clean on the real
port, the committed baseline's ids equal the reference's 66, and one
full launch audit on the CPU (every scenario at its smoke budget):
no unsuppressed finding, equal scorer op sequences for scenarios that
share a campaign signature, and a planted ``.item()`` caught at run
time with its frame."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import (ALLOWED_INTERNAL, FACADE_ONLY,
                                  apply_suppressions, check_cache_key,
                                  check_deprecated, check_facade,
                                  check_facade_source, check_traced_purity,
                                  load_suppressions, parse_suppressions,
                                  run_ast_rules)
from repro_torch.analysis import __main__ as cli
from repro_torch.analysis import launch_audit as la
from repro_torch.analysis.findings import Finding

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def mini_repo(tmp_path, files):
    """A synthetic repo root: {relpath: source} -> tmp dir."""
    (tmp_path / "pyproject.toml").write_text("[project]\nname='x'\n")
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(tmp_path)


# ---------------------------------------------------------------------------
# R001: purity of @traced_closure functions
# ---------------------------------------------------------------------------

_R001_VIOLATION = {
    "src/repro_torch/core/fix_r001.py": """
        import numpy as np
        from .tracing import traced_closure

        @traced_closure
        def score(genomes):
            return np.sqrt(genomes)  # the one violation
    """,
}

_R001_CLEAN = {
    "src/repro_torch/core/fix_clean.py": """
        import numpy as np
        import torch
        from .. import random as jr
        from .tracing import traced_closure

        TABLE = np.cumprod([2, 3, 4])  # build-time numpy is fine

        @traced_closure
        def score(key, genomes):
            u = jr.uniform(key, genomes.shape)
            return torch.sqrt(genomes * torch.as_tensor(TABLE)) + u

        def host_helper(x):
            return float(np.sqrt(x))  # unmarked: not audited
    """,
}


def test_r001_fires_exactly_once(tmp_path):
    findings = check_traced_purity(mini_repo(tmp_path, _R001_VIOLATION))
    assert len(findings) == 1
    f = findings[0]
    assert (f.rule, f.symbol) == ("R001", "score")
    assert "numpy" in f.message


def test_r001_silent_on_clean_fixture(tmp_path):
    assert check_traced_purity(mini_repo(tmp_path, _R001_CLEAN)) == []


@pytest.mark.parametrize("body,needle", [
    ("return x.item()", ".item()"),
    ("return float(x)", "float()"),
    ("print(x)\n    return x", "print"),
    ("global _N\n    _N += 1\n    return x", "global"),
    ("import time\n    return time.perf_counter()", "time"),
    # the port's torch host syncs
    ("return x.cpu()", ".cpu()"),
    ("return x.numpy()", ".numpy()"),
    ("return x.tolist()", ".tolist()"),
    ("return bool(x)", "bool()"),
    ("import torch\n    torch.cuda.synchronize()\n    return x",
     "torch.cuda.synchronize()"),
    ("import random\n    return random.random()", "random.random()"),
])
def test_r001_construct_catalog(tmp_path, body, needle):
    src = ("from .tracing import traced_closure\n\n"
           "@traced_closure\ndef f(x):\n    " + body + "\n")
    root = mini_repo(tmp_path, {"src/repro_torch/core/one.py": src})
    findings = check_traced_purity(root)
    assert len(findings) == 1 and needle in findings[0].message


@pytest.mark.parametrize("imp,call", [
    ("from .. import random as jr", "jr.uniform(x, (2,))"),
    ("from .. import random", "random.uniform(x, (2,))"),
    ("from ..random import uniform", "uniform(x, (2,))"),
])
def test_r001_port_random_is_not_stdlib_random(tmp_path, imp, call):
    """The port's threefry module, imported relatively under any name,
    is not the stdlib ``random`` the rule bans (relative imports keep
    their dots in the alias map)."""
    src = (f"{imp}\nfrom .tracing import traced_closure\n\n"
           f"@traced_closure\ndef f(x):\n    return {call}\n")
    root = mini_repo(tmp_path, {"src/repro_torch/core/one.py": src})
    assert check_traced_purity(root) == []


def test_r001_mutable_default_but_not_frozen_dataclass(tmp_path):
    src = """
        from .tracing import traced_closure

        @traced_closure
        def f(x, acc=[], consts=SomeFrozenThing()):
            return x
    """
    root = mini_repo(tmp_path, {"src/repro_torch/core/two.py": src})
    findings = check_traced_purity(root)
    # the list default fires; the (frozen-style) constructor does not
    assert len(findings) == 1
    assert "mutable default" in findings[0].message


def test_port_marks_the_reference_sites():
    """Every port module the reference marks carries markers; the
    registry records (module, qualname) and the marker is the identity."""
    from repro_torch.core import genetic, nsga, scoring  # noqa: F401
    from repro_torch.core.tracing import (TRACED_REGISTRY, traced_closure,
                                          traced_sites)

    def probe(x):
        return x
    assert traced_closure(probe) is probe and probe.__traced_closure__
    sites = traced_sites()
    assert ("repro_torch.core.genetic", "search_kernel") in sites
    assert ("repro_torch.core.nsga", "nsga_search_kernel") in sites
    del TRACED_REGISTRY[(probe.__module__, probe.__qualname__)]
    marked = {}
    for rel in ("core/baselines.py", "core/nsga.py", "core/nonideal.py",
                "core/genetic.py", "core/scoring.py", "core/objectives.py",
                "core/cost_model.py", "core/sampling.py",
                "core/workloads.py", "experiments/runner.py"):
        marked[rel] = (PKG / rel).read_text().count("@traced_closure")
    assert all(n > 0 for n in marked.values()), marked
    assert sum(marked.values()) == 64, marked


# ---------------------------------------------------------------------------
# R002: cache-key completeness
# ---------------------------------------------------------------------------

def _r002_repo(tmp_path, key_body):
    return mini_repo(tmp_path, {
        "src/repro_torch/experiments/scenarios.py": """
            import dataclasses

            @dataclasses.dataclass(frozen=True)
            class Budget:
                p_ga: int = 8

            @dataclasses.dataclass(frozen=True)
            class Scenario:
                name: str
                mem: str
                seed: int = 0
        """,
        "src/repro_torch/core/scoring.py": """
            import dataclasses

            @dataclasses.dataclass(frozen=True)
            class Calib:
                n_calib: int = 32
        """,
        "src/repro_torch/experiments/runner.py": """
            import dataclasses

            CACHE_KEY_EXEMPT_FIELDS = frozenset({"name"})

            def cache_key_fields(scenario, seed, n_seeds, device="cuda"):
                return """ + key_body + "\n",
    })


def test_r002_fires_exactly_once_on_missing_field(tmp_path):
    # 'mem' is neither read nor exempt -> exactly one error finding
    root = _r002_repo(tmp_path, """{
                "seed": scenario.seed,
                "budget": dataclasses.asdict(scenario.budget),
                "n_calib": scenario.n_calib,
            }""")
    errors = [f for f in check_cache_key(root) if f.severity == "error"]
    assert len(errors) == 1
    assert errors[0].rule == "R002" and "'mem'" in errors[0].message


def test_r002_silent_when_complete(tmp_path):
    root = _r002_repo(tmp_path, """{
                "mem": scenario.mem,
                "seed": scenario.seed,
                "budget": dataclasses.asdict(scenario.budget),
                "n_calib": scenario.n_calib,
            }""")
    assert check_cache_key(root) == []


def test_r002_real_port_key_is_complete():
    """The port's runner keys every Scenario/Budget/Calib field, with the
    reference's four exemptions."""
    from repro.experiments.runner import \
        CACHE_KEY_EXEMPT_FIELDS as JEXEMPT
    from repro_torch.experiments.runner import CACHE_KEY_EXEMPT_FIELDS
    assert CACHE_KEY_EXEMPT_FIELDS == JEXEMPT
    assert check_cache_key(str(ROOT)) == []


# ---------------------------------------------------------------------------
# R003: facade enforcement
# ---------------------------------------------------------------------------

def test_r003_fires_exactly_once(tmp_path):
    root = mini_repo(tmp_path, {"src/repro_torch/launch/demo.py": """
        import repro_torch.api
        from repro_torch.core import build_scorer  # the one violation
    """})
    findings = check_facade(root)
    assert len(findings) == 1
    assert findings[0].rule == "R003"
    assert "repro_torch.core" in findings[0].message


def test_r003_source_helper_resolves_relative_imports():
    findings = check_facade_source(
        "from ..experiments import run_scenario\n"
        "from ..api import run_scenario as ok\n"
        "from ..device import resolve_device\n",
        "src/repro_torch/launch/job.py")
    assert len(findings) == 1
    assert "repro_torch.experiments" in findings[0].message


def test_r003_real_port_is_clean_without_suppression():
    """launch/ and examples/ import the co-design stack through the
    facade only (the serve launcher and the LM example were repaired),
    and no R003 suppression covers them."""
    assert check_facade(str(ROOT)) == []
    sups, _ = load_suppressions(str(ROOT))
    assert not [s for s in sups if s.rule == "R003"]


def test_allowed_internal_list_covers_the_port():
    """Every repro_torch submodule is classified: facade-only or allowed
    internal."""
    subs = {p.stem for p in PKG.iterdir()
            if not p.name.startswith("_") and
            (p.suffix == ".py" or (p / "__init__.py").exists())}
    assert subs <= set(ALLOWED_INTERNAL) | set(FACADE_ONLY), subs


# ---------------------------------------------------------------------------
# R004: deprecated ImportError stubs
# ---------------------------------------------------------------------------

def test_r004_fires_exactly_once(tmp_path):
    root = mini_repo(tmp_path, {"src/repro_torch/fresh.py": """
        from repro_torch.experiments import make_scorer

        def build(sp, wa, obj):
            return make_scorer(sp, wa, obj)
    """})
    findings = check_deprecated(root)
    assert len(findings) == 1
    assert findings[0].rule == "R004"
    assert "make_scorer" in findings[0].message


def test_r004_silent_on_the_replacement(tmp_path):
    root = mini_repo(tmp_path, {"src/repro_torch/fresh.py": """
        from repro_torch.api import build_scorer
    """})
    assert check_deprecated(root) == []


# ---------------------------------------------------------------------------
# suppressions
# ---------------------------------------------------------------------------

def test_suppression_round_trip():
    sups, problems = parse_suppressions(
        "# comment\n"
        "\n"
        "R001 src/repro_torch/core/foo.py:build.score  # pinned table\n"
        "R003 src/repro_torch/launch/x.py  # measures internals\n",
        source="analysis/torch_suppressions.txt")
    assert problems == []
    assert len(sups) == 2

    hit = Finding(rule="R001", path="src/repro_torch/core/foo.py", line=3,
                  symbol="build.score.inner", message="m")
    miss = Finding(rule="R001", path="src/repro_torch/core/bar.py", line=3,
                   symbol="build.score", message="m")
    kept, suppressed, stale = apply_suppressions([hit, miss], sups)
    assert kept == [miss]
    assert suppressed == [hit]
    # the R003 entry matched nothing -> exactly one stale warning
    assert len(stale) == 1 and stale[0].severity == "warning"
    assert "src/repro_torch/launch/x.py" in stale[0].message


def test_suppression_requires_justification():
    sups, problems = parse_suppressions(
        "R001 src/repro_torch/core/foo.py\n"        # no justification
        "R001 too many parts here  # why\n"         # malformed
        "R001@cuda src/repro_torch/a.py  # why\n"   # scope on an R rule
        "J001@tpu src/repro_torch/a.py  # why\n")   # unknown device
    assert sups == []
    assert len(problems) == 4
    assert all(p.rule == "R000" and p.severity == "error"
               for p in problems)


def test_suppression_device_scope():
    """A device-scoped launch suppression is live, and can go stale,
    only on its device."""
    sups, problems = parse_suppressions(
        "J001@cuda src/repro_torch/core/a.py:f  # a copy only the card "
        "shows\n"
        "J001 src/repro_torch/core/b.py:g  # any device\n")
    assert problems == []
    assert [s.device for s in sups] == ["cuda", ""]
    assert [s.applies("RJ", "cuda") for s in sups] == [True, True]
    assert [s.applies("RJ", "cpu") for s in sups] == [False, True]
    assert [s.applies("R", "") for s in sups] == [False, False]


def test_repo_suppression_file_parses_clean():
    text = (ROOT / "analysis" / "torch_suppressions.txt").read_text()
    sups, problems = parse_suppressions(text)
    assert problems == [] and sups


# ---------------------------------------------------------------------------
# the port itself + the CLI gate
# ---------------------------------------------------------------------------

def test_repo_ast_rules_all_suppressed_or_clean():
    """src/repro_torch carries no unsuppressed AST finding and no stale
    R suppression."""
    findings = run_ast_rules(str(ROOT))
    sups, problems = load_suppressions(str(ROOT))
    sups = [s for s in sups if s.applies("R", "")]
    kept, _, stale = apply_suppressions(findings, sups)
    assert problems == [] and stale == []
    assert kept == [], "\n".join(f.format() for f in kept)


def test_cli_exit_codes(tmp_path):
    """--ast exits 0 on a clean synthetic repo, 1 when a violation is
    introduced, and 0 again once suppressed with a justification."""
    root = mini_repo(tmp_path, _R001_CLEAN)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")

    def run():
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "--ast",
             "--root", root, "--report", str(tmp_path / "rep.json")],
            capture_output=True, text=True, env=env, cwd=str(ROOT))

    assert run().returncode == 0

    bad = tmp_path / "src/repro_torch/core/fix_r001.py"
    bad.write_text(textwrap.dedent(_R001_VIOLATION[
        "src/repro_torch/core/fix_r001.py"]))
    r = run()
    assert r.returncode == 1 and "R001" in r.stdout
    report = json.loads((tmp_path / "rep.json").read_text())
    assert any(f["rule"] == "R001" for f in report["findings"])

    sup = tmp_path / "analysis" / "torch_suppressions.txt"
    sup.parent.mkdir(exist_ok=True)
    sup.write_text("R001 src/repro_torch/core/fix_r001.py:score"
                   "  # fixture: exercised by test_cli_exit_codes\n")
    assert run().returncode == 0


def test_cli_launch_defaults_to_cuda(capsys):
    """--launch runs on cuda unless told otherwise: without a GPU it
    exits 2 instead of falling back to the CPU."""
    if torch.cuda.is_available():
        assert cli.main(["--launch", "--device", "cuda:99"]) != 0
        return
    assert cli.main(["--launch"]) == 2
    assert cli.main(["--all"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


# ---------------------------------------------------------------------------
# the launch audit (unit level)
# ---------------------------------------------------------------------------

def test_recorder_counts_ops_and_flags_host_syncs():
    """A pure call records no sync; ``.item()``, ``bool(t)``,
    ``torch.equal`` and a boolean mask each record one, and a Python
    loop's ops count once a step (the eager form of a scan body)."""
    x = torch.arange(6, dtype=torch.float32)

    def pure():
        y = x
        for _ in range(5):
            y = torch.tanh(y) + 1.0
        return y

    rec, _ = la.record_call(pure, "cpu")
    assert rec.counts["aten.tanh"] == 5 and rec.syncs == []
    # integer indexing, of a boolean tensor too, has a static shape
    mask = x > 2
    rec, _ = la.record_call(lambda: (x[torch.tensor([0, 2])],
                                     mask[torch.tensor([1])]), "cpu")
    assert rec.counts["aten.index"] == 2 and rec.syncs == []
    for fn, needle in ((lambda: x.sum().item(), "host read"),
                       (lambda: bool(x.sum() > 0), "host read"),
                       (lambda: torch.equal(x, x), "torch.equal"),
                       (lambda: x[x > 2], "depends on the data")):
        rec, _ = la.record_call(fn, "cpu")
        assert len(rec.syncs) == 1 and needle in rec.syncs[0][3], \
            rec.syncs


def test_planted_item_is_caught_with_its_frame():
    """A ``.item()`` planted in a marked function of the package is a
    J001 finding at its file and line at run time (the fixture's code
    object carries a path inside src/repro_torch; no file is written)."""
    path = PKG / "core" / "planted_fixture.py"
    src = ("from repro_torch.core.tracing import traced_closure\n"
           "import torch\n\n"
           "@traced_closure\n"
           "def score(genomes):\n"
           "    worst = genomes.max().item()  # line 6\n"
           "    return genomes.float() / worst\n")
    ns = {}
    exec(compile(src, str(path), "exec"), ns)
    g = torch.arange(1, 9).reshape(4, 2)
    rec, out = la.record_call(lambda: ns["score"](g), "cpu")
    assert out.shape == (4, 2)
    entry = la.KernelEntry("planted::scorer", "planted", "scorer", "g",
                           rec.hash, sum(rec.counts.values()),
                           dict(rec.counts), tuple(rec.syncs))
    j001 = [f for f in la.audit_entries([entry], None) if f.rule == "J001"]
    assert len(j001) == 1
    f = j001[0]
    assert (f.path, f.line, f.symbol) == (
        "src/repro_torch/core/planted_fixture.py", 6, "score")
    assert "planted::scorer" in f.message


def test_launch_audit_rules_on_synthetic_entries():
    def entry(kid, group, h, n, syncs=()):
        return la.KernelEntry(kernel_id=kid, scenario=kid.split(":")[0],
                              label=kid.split("::")[1], group=group,
                              hash=h, n_ops=n, ops={"aten.add": n},
                              syncs=syncs)

    entries = [
        entry("a::kernel", "g1", "h1", 100),
        entry("b::kernel", "g1", "h2", 100),   # J002: split group
        entry("c::kernel", "g2", "h3", 500),   # J003: bloat vs 100
        entry("d::kernel", "g3", "h4", 50,
              (("src/repro_torch/core/x.py", 7, "f", "a host read"),)),
    ]
    baseline = {"a::kernel": 100, "b::kernel": 100, "c::kernel": 100,
                "d::kernel": 50, "gone::kernel": 10}
    rules = sorted(f.rule for f in la.audit_entries(entries, baseline)
                   if f.severity == "error")
    assert rules == ["J001", "J002", "J003"]
    warn = [f for f in la.audit_entries(entries, baseline)
            if f.severity == "warning"]
    assert len(warn) == 1 and "gone::kernel" in warn[0].symbol
    # within 25% + 16 of the baseline is no bloat
    ok = [entry("c::kernel", "g2", "h3", int(100 * 1.25 + 16))]
    assert la.audit_entries(ok, {"c::kernel": 100}) == []


def test_launch_baseline_round_trip(tmp_path):
    """Each device type has its own block; writing one keeps the
    other."""
    e = la.KernelEntry(kernel_id="s::kernel", scenario="s", label="kernel",
                       group="g", hash="h", n_ops=42,
                       ops={"aten.add": 42}, syncs=())
    la.write_baseline(str(tmp_path), [e], "cpu", "cpu")
    la.write_baseline(str(tmp_path), [dataclasses.replace(e, n_ops=7)],
                      "cuda", "NVIDIA H100")
    assert la.load_baseline(str(tmp_path), "cpu") == {"s::kernel": 42}
    assert la.load_baseline(str(tmp_path), "cuda") == {"s::kernel": 7}
    assert la.load_baseline(str(tmp_path / "nowhere"), "cpu") is None


def test_repo_baseline_ids_equal_the_reference():
    """analysis/torch_baseline.json covers exactly the 66 kernel ids of
    analysis/baseline.json in its cpu block (and its cuda block, once
    written). Reads the JSON only."""
    with open(ROOT / "analysis" / "baseline.json") as f:
        want = set(json.load(f)["kernels"])
    with open(ROOT / "analysis" / "torch_baseline.json") as f:
        got = json.load(f)
    assert len(want) == 66
    assert set(got["cpu"]["kernels"]) == want
    if "cuda" in got:
        assert set(got["cuda"]["kernels"]) == want


def test_unknown_scenario_is_j000():
    findings, report = la.run_launch_audit(str(ROOT), "cpu",
                                           names=["no_such_scenario"])
    assert [f.rule for f in findings if f.severity == "error"] == ["J000"]
    assert report["n_kernels"] == 0


# ---------------------------------------------------------------------------
# the full launch audit on the CPU (every scenario, smoke budget)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cpu_audit():
    return la.run_launch_audit(str(ROOT), "cpu")


def test_full_cpu_audit_clean_and_complete(cpu_audit):
    """All 66 ids of analysis/baseline.json run on the CPU; every finding
    is suppressed in analysis/torch_suppressions.txt (no J000, J002 or
    J003 error) and no CPU-live suppression is stale."""
    findings, report = cpu_audit
    with open(ROOT / "analysis" / "baseline.json") as f:
        want = set(json.load(f)["kernels"])
    assert set(report["kernels"]) == want
    findings = findings + run_ast_rules(str(ROOT))
    sups, problems = load_suppressions(str(ROOT))
    sups = [s for s in sups if s.applies("RJ", "cpu")]
    kept, suppressed, stale = apply_suppressions(findings, sups)
    assert problems == [] and stale == [], stale
    assert kept == [], "\n".join(f.format() for f in kept)
    assert any(f.rule == "J001" for f in suppressed)


def test_rram_smoke_audit(cpu_audit):
    """rram_smoke on the CPU: scorer and kernel, no unsuppressed J001
    and within J003 of the cpu block."""
    _, report = cpu_audit
    ks = report["kernels"]
    assert {k for k in ks if k.startswith("rram_smoke::")} == {
        "rram_smoke::scorer", "rram_smoke::kernel"}
    assert not ks["rram_smoke::scorer"]["syncs"]
    base = la.load_baseline(str(ROOT), "cpu")
    entries = [la.KernelEntry(**{**ks[k], "syncs": tuple(
        tuple(s) for s in ks[k]["syncs"])})
        for k in ("rram_smoke::scorer", "rram_smoke::kernel")]
    for e in entries:
        assert e.n_ops <= int(base[e.kernel_id] * la.BLOAT_RATIO
                              + la.BLOAT_SLACK)
    findings = la.audit_entries(entries, base)
    sups, _ = load_suppressions(str(ROOT))
    kept, _, _ = apply_suppressions(findings, sups)
    errors = [f for f in kept if f.severity == "error"]
    assert errors == [], "\n".join(f.format() for f in errors)


def test_shared_signature_shares_one_op_sequence(cpu_audit):
    """A scenario and its ``_plain`` variant build one Scorer (the
    campaign's scorer_key): one op-sequence hash, one J002 group."""
    _, report = cpu_audit
    ks = report["kernels"]
    a, b = ks["rram_small_set::scorer"], ks["rram_small_set_plain::scorer"]
    assert a["group"] == b["group"]
    assert a["hash"] == b["hash"] and a["n_ops"] == b["n_ops"] > 0
    assert ks["rram_small_set::kernel"]["hash"] != \
        ks["rram_small_set_plain::kernel"]["hash"]
