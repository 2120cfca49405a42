"""Layer 1: repo-specific AST lint rules over the port (stdlib only);
counterpart of ``repro/analysis/ast_rules.py``.

Rules
-----
R001  search-region purity: no host-sync / impure constructs inside
      functions marked ``@traced_closure`` (``repro_torch.core.tracing``)
      — ``.item()``, ``float()``/``int()``/``bool()`` on non-literal
      values, ``.cpu()``, ``.numpy()``, ``.tolist()``,
      ``torch.cuda.synchronize()``, ``np.*`` / ``time.*`` / ``random.*``
      calls, ``print``, ``global`` mutation, mutable default arguments.
      A host sync inside a search call stalls the eager launch queue
      and stops a CUDA graph of the step; host work re-runs on every
      call. Hoist it to build time or keep the value on the device.
R002  cache-key completeness: every ``Scenario`` / ``Budget`` /
      ``Calib`` field must be read by ``runner.cache_key_fields`` or
      listed in ``runner.CACHE_KEY_EXEMPT_FIELDS`` — a new knob can
      never silently alias cached results.
R003  facade enforcement: ``src/repro_torch/launch/`` and
      ``src/repro_torch/examples/`` import the co-design stack only
      through ``repro_torch.api`` (never ``repro_torch.core`` /
      ``.experiments`` / ``.serve`` directly). ``tools/`` stays out: its
      scripts import the reference on purpose.
R004  no calls to ImportError-stubbed deprecated APIs
      (``runner.make_scorer``, ``runner.make_traced_scorer``,
      ``distributed.make_sharded_scorer``).

All rules are pure-stdlib ``ast`` visitors: the AST layer needs no
torch and no device.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .findings import Finding

# The package these rules audit, and its facade.
PACKAGE = "repro_torch"
FACADE = f"{PACKAGE}.api"

# The facade boundary: the reference's, plus the port's own modules
# (its threefry port, device resolution, the JAX-free numpy helpers)
# and its examples package (the reference keeps examples/ outside src).
FACADE_ONLY = ("core", "experiments", "serve")
ALLOWED_INTERNAL = ("analysis", "api", "configs", "models", "kernels",
                    "train", "data", "parallel", "checkpoint", "launch",
                    "random", "device", "convert", "examples")

# Directories (repo-relative) the facade rule covers.
FACADE_SCAN_DIRS = (os.path.join("src", PACKAGE, "launch"),
                    os.path.join("src", PACKAGE, "examples"))

# Directories the purity / deprecated-API rules cover.
SRC_SCAN_DIRS = (os.path.join("src", PACKAGE),)

# Removed APIs that survive only as ImportError stubs.
DEPRECATED_STUBS = ("make_scorer", "make_traced_scorer",
                    "make_sharded_scorer")

# Module roots whose calls are banned inside traced closures.
_IMPURE_ROOTS = ("numpy", "time", "random")

# Tensor methods that wait for the device (no-argument calls), and why.
_SYNC_METHODS = {
    "item": "a host sync",
    "cpu": "a device-to-host copy, a host sync",
    "numpy": "a device-to-host copy, a host sync",
    "tolist": "a device-to-host copy, a host sync",
}

# Calls that wait for the device.
_SYNC_CALLS = ("torch.cuda.synchronize",)

_DECORATOR_NAME = "traced_closure"


def iter_py_files(repo_root: str,
                  rel_dirs: Sequence[str]) -> Iterable[str]:
    """Repo-relative paths (forward slashes) of every .py file under
    ``rel_dirs``, sorted; __pycache__ skipped."""
    out = []
    for rel in rel_dirs:
        base = os.path.join(repo_root, rel)
        if not os.path.isdir(base):
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for name in sorted(filenames):
                if name.endswith(".py"):
                    p = os.path.relpath(os.path.join(dirpath, name),
                                        repo_root)
                    out.append(p.replace(os.sep, "/"))
    return sorted(set(out))


def parse_file(repo_root: str, rel_path: str) -> ast.Module:
    with open(os.path.join(repo_root, rel_path)) as f:
        return ast.parse(f.read(), filename=rel_path)


def import_aliases(tree: ast.Module) -> Dict[str, str]:
    """Local name -> full dotted module/object path, from every import
    statement in the file (module scope and nested). A relative import
    keeps its leading dots (``from .. import random`` maps ``random`` to
    ``..random``), so the port's own ``random`` module is never taken
    for the stdlib one."""
    aliases: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                aliases[a.asname or a.name.split(".")[0]] = (
                    a.name if a.asname else a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom):
            mod = "." * node.level + (node.module or "")
            sep = "" if mod.endswith(".") else "."
            for a in node.names:
                if a.name == "*":
                    continue
                aliases[a.asname or a.name] = f"{mod}{sep}{a.name}"
    return aliases


def _resolve_root(node: ast.expr, aliases: Dict[str, str]
                  ) -> Optional[str]:
    """Full dotted path of a Name/Attribute chain's base, through the
    alias map; None when the base is not a plain name."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if not isinstance(node, ast.Name):
        return None
    base = aliases.get(node.id, node.id)
    return ".".join([base] + list(reversed(parts)))


def _is_impure_path(path: Optional[str]) -> Optional[str]:
    if path is None:
        return None
    for root in _IMPURE_ROOTS:
        if path == root or path.startswith(root + "."):
            return root
    return None


def _has_marker(fn: ast.AST) -> bool:
    for dec in getattr(fn, "decorator_list", ()):
        if isinstance(dec, ast.Name) and dec.id == _DECORATOR_NAME:
            return True
        if isinstance(dec, ast.Attribute) and dec.attr == _DECORATOR_NAME:
            return True
    return False


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _marked_functions(tree: ast.Module) -> List[Tuple[str, ast.AST]]:
    """(qualname, node) of every ``@traced_closure``-marked function."""
    marked: List[Tuple[str, ast.AST]] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                qual = f"{prefix}{child.name}"
                if _has_marker(child):
                    marked.append((qual, child))
                visit(child, f"{qual}.")
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
            else:
                visit(child, prefix)

    visit(tree, "")
    return marked


_LITERAL_NODES = (ast.Constant,)


def _check_traced_body(path: str, qual: str, fn: ast.AST,
                       aliases: Dict[str, str]) -> List[Finding]:
    out: List[Finding] = []

    def bad(node: ast.AST, msg: str) -> None:
        out.append(Finding(rule="R001", path=path, line=node.lineno,
                           symbol=qual, message=msg))

    # mutable default arguments on the marked function itself
    # (mutable literals and the dict/list/set constructors; immutable
    # calls like frozen-dataclass defaults are fine)
    mutable_ctors = ("dict", "list", "set", "bytearray", "defaultdict",
                     "deque", "OrderedDict", "Counter")
    args = fn.args
    for default in list(args.defaults) + [d for d in args.kw_defaults
                                          if d is not None]:
        mutable = isinstance(default, (ast.List, ast.Dict, ast.Set,
                                       ast.ListComp, ast.DictComp,
                                       ast.SetComp, ast.GeneratorExp))
        if isinstance(default, ast.Call):
            f = default.func
            name = f.id if isinstance(f, ast.Name) else (
                f.attr if isinstance(f, ast.Attribute) else "")
            mutable = name in mutable_ctors
        if mutable:
            bad(default, "mutable default argument on a traced closure "
                         "(shared across every call; default to None "
                         "and build inside)")

    for node in ast.walk(fn):
        # nested marked functions are scanned as their own entry points
        if node is not fn and isinstance(node, _FUNC_NODES) \
                and _has_marker(node):
            continue
        if isinstance(node, ast.Global):
            bad(node, "global mutation inside a traced closure "
                      "(shared state mutated on every search call; "
                      "pass state in and out)")
        if isinstance(node, ast.Call):
            func = node.func
            if isinstance(func, ast.Attribute) \
                    and func.attr in _SYNC_METHODS \
                    and not node.args and not node.keywords:
                bad(node, f".{func.attr}() inside a traced closure "
                          f"({_SYNC_METHODS[func.attr]}; keep the value "
                          "on the device)")
            if isinstance(func, ast.Name) and func.id == "print":
                bad(node, "print() inside a traced closure "
                          "(host I/O on every search call; print "
                          "outside it)")
            if isinstance(func, ast.Name) \
                    and func.id in ("float", "int", "bool") \
                    and node.args \
                    and not isinstance(node.args[0], _LITERAL_NODES):
                bad(node, f"{func.id}() on a non-literal inside a "
                          "traced closure (a host sync on a tensor; "
                          "hoist static conversions to build time)")
            called = _resolve_root(func, aliases)
            if called in _SYNC_CALLS:
                bad(node, f"{called}() inside a traced closure (waits "
                          "for the device; synchronize outside the "
                          "search call)")
            impure = _is_impure_path(called)
            if impure is not None:
                bad(node, f"{called}() call inside a traced closure "
                          f"({impure} runs on the host at every call; "
                          "hoist to build time or use the torch "
                          "equivalent)")
    return out


def check_traced_purity(repo_root: str) -> List[Finding]:
    """R001 over every marked function in the scan roots."""
    findings: List[Finding] = []
    for rel in iter_py_files(repo_root, SRC_SCAN_DIRS):
        tree = parse_file(repo_root, rel)
        marked = _marked_functions(tree)
        if not marked:
            continue
        aliases = import_aliases(tree)
        for qual, fn in marked:
            findings += _check_traced_body(rel, qual, fn, aliases)
    return findings


# ---------------------------------------------------------------------------
# R002: cache-key completeness
# ---------------------------------------------------------------------------

_RUNNER = os.path.join("src", PACKAGE, "experiments", "runner.py")
_SCENARIOS = os.path.join("src", PACKAGE, "experiments", "scenarios.py")
_SCORING = os.path.join("src", PACKAGE, "core", "scoring.py")


def _dataclass_fields(tree: ast.Module, class_name: str) -> List[str]:
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name == class_name:
            return [s.target.id for s in node.body
                    if isinstance(s, ast.AnnAssign)
                    and isinstance(s.target, ast.Name)]
    raise ValueError(f"dataclass {class_name!r} not found")


def _function(tree: ast.Module, name: str) -> ast.FunctionDef:
    for node in tree.body:
        if isinstance(node, _FUNC_NODES) and node.name == name:
            return node
    raise ValueError(f"function {name!r} not found")


def _exempt_fields(tree: ast.Module) -> Tuple[List[str], int]:
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets = [t.id for t in node.targets
                       if isinstance(t, ast.Name)]
            if "CACHE_KEY_EXEMPT_FIELDS" in targets:
                call = node.value
                if isinstance(call, ast.Call) and call.args:
                    return sorted(ast.literal_eval(call.args[0])), \
                        node.lineno
                return sorted(ast.literal_eval(call)), node.lineno
    return [], 0


def check_cache_key(repo_root: str) -> List[Finding]:
    """R002: Scenario/Budget/Calib fields vs runner.cache_key_fields."""
    runner_tree = parse_file(repo_root, _RUNNER.replace(os.sep, "/"))
    scen_tree = parse_file(repo_root, _SCENARIOS.replace(os.sep, "/"))
    scoring_tree = parse_file(repo_root, _SCORING.replace(os.sep, "/"))
    runner_rel = _RUNNER.replace(os.sep, "/")

    scenario_fields = _dataclass_fields(scen_tree, "Scenario")
    budget_fields = _dataclass_fields(scen_tree, "Budget")
    calib_fields = _dataclass_fields(scoring_tree, "Calib")

    fn = _function(runner_tree, "cache_key_fields")
    accessed = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "scenario":
            accessed.add(node.attr)
    exempt, exempt_line = _exempt_fields(runner_tree)

    findings: List[Finding] = []
    for field in scenario_fields:
        if field not in accessed and field not in exempt:
            findings.append(Finding(
                rule="R002", path=runner_rel, line=fn.lineno,
                symbol="cache_key_fields",
                message=f"Scenario field {field!r} is neither read by "
                        "cache_key_fields nor listed in "
                        "CACHE_KEY_EXEMPT_FIELDS — cached results would "
                        "alias across its values"))
    for field in exempt:
        if field not in scenario_fields:
            findings.append(Finding(
                rule="R002", path=runner_rel, line=exempt_line or 1,
                symbol="CACHE_KEY_EXEMPT_FIELDS",
                message=f"exempt field {field!r} is not a Scenario "
                        "field — remove the stale exemption",
                severity="warning"))
    if "budget" not in accessed:
        for field in budget_fields:
            findings.append(Finding(
                rule="R002", path=runner_rel, line=fn.lineno,
                symbol="cache_key_fields",
                message=f"Budget field {field!r} is not keyed "
                        "(cache_key_fields never reads "
                        "scenario.budget)"))
    for field in calib_fields:
        if field not in accessed and field not in exempt:
            findings.append(Finding(
                rule="R002", path=runner_rel, line=fn.lineno,
                symbol="cache_key_fields",
                message=f"Calib field {field!r} is not keyed by "
                        "cache_key_fields"))
    return findings


# ---------------------------------------------------------------------------
# R003: facade enforcement
# ---------------------------------------------------------------------------

def _module_of(rel_path: str) -> Optional[str]:
    """Dotted module path of a repo file under src/ (None outside)."""
    parts = rel_path.split("/")
    if parts[0] != "src":
        return None
    mod = parts[1:]
    if mod[-1].endswith(".py"):
        mod[-1] = mod[-1][:-3]
    if mod[-1] == "__init__":
        mod = mod[:-1]
    return ".".join(mod)


def import_targets(tree: ast.Module,
                   rel_path: str) -> List[Tuple[int, str]]:
    """(lineno, resolved module) for every import; relative imports are
    resolved against the file's own package path."""
    pkg_parts: List[str] = []
    mod = _module_of(rel_path)
    if mod:
        pkg_parts = mod.split(".")[:-1] if rel_path.endswith(".py") \
            and not rel_path.endswith("__init__.py") else mod.split(".")
    out: List[Tuple[int, str]] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            target = node.module or ""
            if node.level:
                base = pkg_parts[: len(pkg_parts) - (node.level - 1)] \
                    if node.level > 1 else pkg_parts
                target = ".".join(base + ([target] if target else []))
            out.append((node.lineno, target))
    return out


def _facade_findings(tree: ast.Module, rel: str) -> List[Finding]:
    findings: List[Finding] = []
    for lineno, mod in import_targets(tree, rel):
        parts = mod.split(".")
        if parts[0] == PACKAGE and len(parts) > 1 \
                and parts[1] in FACADE_ONLY:
            findings.append(Finding(
                rule="R003", path=rel, line=lineno, symbol="",
                message=f"imports {mod} directly — the co-design stack "
                        f"is only supported through {FACADE}"))
    return findings


def check_facade(repo_root: str,
                 rel_dirs: Sequence[str] = FACADE_SCAN_DIRS
                 ) -> List[Finding]:
    """R003: no direct repro_torch.{core,experiments,serve} imports in
    the port's launchers and examples."""
    findings: List[Finding] = []
    for rel in iter_py_files(repo_root, rel_dirs):
        findings += _facade_findings(parse_file(repo_root, rel), rel)
    return findings


def check_facade_source(source: str, rel_path: str) -> List[Finding]:
    """R003 on one in-memory snippet (tests exercise the rule on
    synthetic violations without touching the repo)."""
    return _facade_findings(ast.parse(source, filename=rel_path), rel_path)


# ---------------------------------------------------------------------------
# R004: deprecated ImportError stubs
# ---------------------------------------------------------------------------

def check_deprecated(repo_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for rel in iter_py_files(repo_root, SRC_SCAN_DIRS):
        tree = parse_file(repo_root, rel)
        defined = {node.name for node in ast.walk(tree)
                   if isinstance(node, _FUNC_NODES)}
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom):
                for a in node.names:
                    if a.name in DEPRECATED_STUBS:
                        findings.append(Finding(
                            rule="R004", path=rel, line=node.lineno,
                            symbol="",
                            message=f"imports removed API {a.name!r} "
                                    "(an ImportError stub); use "
                                    "core.scoring.build_scorer"))
            elif isinstance(node, ast.Attribute) \
                    and node.attr in DEPRECATED_STUBS \
                    and node.attr not in defined:
                findings.append(Finding(
                    rule="R004", path=rel, line=node.lineno, symbol="",
                    message=f"references removed API "
                            f"{node.attr!r} (an ImportError stub); use "
                            "core.scoring.build_scorer"))
    return findings


def run_ast_rules(repo_root: str) -> List[Finding]:
    """All of R001-R004 over the repo."""
    findings = check_traced_purity(repo_root)
    r002_inputs = (_RUNNER, _SCENARIOS, _SCORING)
    if all(os.path.exists(os.path.join(repo_root, p))
           for p in r002_inputs):
        findings += check_cache_key(repo_root)
    else:
        missing = [p.replace(os.sep, "/") for p in r002_inputs
                   if not os.path.exists(os.path.join(repo_root, p))]
        findings.append(Finding(
            rule="R002", path=missing[0], line=1, symbol="",
            message="cache-key rule skipped: expected file(s) missing "
                    f"({', '.join(missing)}) — if the runner moved, "
                    "update repro_torch/analysis/ast_rules.py",
            severity="warning"))
    findings += check_facade(repo_root)
    findings += check_deprecated(repo_root)
    return findings
