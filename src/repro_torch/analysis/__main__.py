"""CLI of the port's analysis suite; counterpart of
``python -m repro.analysis``.

    python -m repro_torch.analysis --ast              # R001-R004, no device
    python -m repro_torch.analysis --launch           # J000-J003 on cuda
    python -m repro_torch.analysis --all --device cpu # both, on the CPU
    python -m repro_torch.analysis --all --report analysis_report.json
    python -m repro_torch.analysis --launch --update-baseline --device cuda

``--launch`` and ``--all`` run on ``--device`` (default ``cuda``) and exit
2 without a GPU unless ``--device cpu`` is given. Exit status is 1 iff
an unsuppressed ERROR finding remains (warnings — stale suppressions,
ids missing from the baseline — print but pass). Suppressions live in
``analysis/torch_suppressions.txt``; every line needs a justification
comment (see ``repro_torch.analysis.findings``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List

from .ast_rules import run_ast_rules
from .findings import Finding, apply_suppressions, load_suppressions


def repo_root_of(start: str) -> str:
    """Nearest ancestor holding the repo markers (pyproject + src)."""
    d = os.path.abspath(start)
    while True:
        if os.path.exists(os.path.join(d, "pyproject.toml")) \
                and os.path.isdir(os.path.join(d, "src")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise SystemExit(
                f"cannot find the repo root above {start!r} "
                "(looked for pyproject.toml + src/)")
        d = parent


def main(argv: List[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="the port's analysis suite (AST lint + launch audit)")
    ap.add_argument("--ast", action="store_true",
                    help="run the AST rules R001-R004")
    ap.add_argument("--launch", action="store_true",
                    help="run the launch audit J000-J003 on --device")
    ap.add_argument("--all", action="store_true",
                    help="run both layers")
    ap.add_argument("--device", default="cuda",
                    help="device of the launch audit (default cuda; "
                         "'cpu' to run it without a GPU)")
    ap.add_argument("--root", default=".",
                    help="repo root (default: discovered from cwd)")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="write the full report (findings + per-id op "
                         "counts, hashes and sync sites) as JSON")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite --device's block of "
                         "analysis/torch_baseline.json (implies --launch)")
    args = ap.parse_args(argv)
    if args.update_baseline:
        args.launch = True
    if args.all:
        args.ast = args.launch = True
    if not (args.ast or args.launch):
        args.ast = True  # cheap default

    root = repo_root_of(args.root)
    findings: List[Finding] = []
    report = {"ast": args.ast, "launch": args.launch}
    device_type = ""
    if args.launch:
        from ..device import resolve_device
        try:
            dev = resolve_device(args.device)
        except RuntimeError as e:
            print(f"analysis: {e}", file=sys.stderr)
            return 2
        device_type = dev.type

    if args.ast:
        findings += run_ast_rules(root)
    if args.launch:
        from .launch_audit import run_launch_audit
        lfindings, lreport = run_launch_audit(
            root, dev, update_baseline=args.update_baseline)
        findings += lfindings
        report["launch_audit"] = lreport

    # staleness is only decidable for the rule families that ran, and a
    # device-scoped launch suppression only on its device
    ran = ("R" if args.ast else "") + ("J" if args.launch else "")
    sups, problems = load_suppressions(root)
    sups = [s for s in sups if s.applies(ran, device_type)]
    kept, suppressed, stale = apply_suppressions(findings, sups)
    kept += problems + stale

    errors = [f for f in kept if f.severity == "error"]
    warnings = [f for f in kept if f.severity != "error"]
    for f in errors + warnings:
        tag = "error" if f.severity == "error" else "warning"
        print(f"{tag}: {f.format()}")
    for f in suppressed:
        print(f"suppressed: {f.format()}")
    print(f"analysis: {len(errors)} error(s), {len(warnings)} "
          f"warning(s), {len(suppressed)} suppressed")

    report["findings"] = [f.asdict() for f in kept]
    report["suppressed"] = [f.asdict() for f in suppressed]
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"report written to {args.report}")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
