"""Findings and the suppression file of the port's analysis suite;
counterpart of ``repro/analysis/findings.py``.

A :class:`Finding` is one rule violation at one location. Findings can
be suppressed through a plain-text suppression file (``analysis/
torch_suppressions.txt`` at the repo root). Format, one suppression
per line::

    R001 src/repro_torch/core/foo.py:make_thing.score  # why this is fine
    J001@cuda src/repro_torch/core/bar.py:rank        # why this is fine

``RULE[@device] path[:symbol]  # justification``. The symbol suffix
narrows the suppression to one function (qualname match, or a dotted
prefix of one); without it the whole file is suppressed for that rule.
A launch-audit rule may carry a device scope (``J001@cuda``): a host
sync that only the card shows (a device-to-host copy dispatches nothing
on the CPU) is then suppressed, and judged stale, only when the audit
ran on that device. The justification comment is MANDATORY — a
suppression without one is itself an error finding, so every silenced
rule carries its reason in the file. Suppressions that match nothing
are reported as warnings (stale entries rot fast otherwise).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterable, List, Sequence, Tuple

SUPPRESSION_FILE = os.path.join("analysis", "torch_suppressions.txt")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at one location."""
    rule: str               # "R001".."R004", "J000".."J003"
    path: str               # repo-relative, forward slashes
    line: int
    symbol: str             # qualname of the offending function, or ""
    message: str
    severity: str = "error"  # "error" fails the build; "warning" reports

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym} {self.message}"

    def asdict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class Suppression:
    rule: str
    path: str
    symbol: str             # "" suppresses the whole file for the rule
    justification: str
    line: int               # line number inside the suppression file
    device: str = ""        # "" any device; "cuda" / "cpu" that audit only

    def matches(self, f: Finding) -> bool:
        if f.rule != self.rule or f.path != self.path:
            return False
        if not self.symbol:
            return True
        return (f.symbol == self.symbol
                or f.symbol.startswith(self.symbol + "."))

    def applies(self, families: str, device: str) -> bool:
        """Whether this entry is live for a run of the rule ``families``
        ("R", "J" or "RJ") on ``device`` (its type: "cpu" / "cuda")."""
        return self.rule[:1] in families and \
            (not self.device or self.device == device)


def parse_suppressions(
        text: str, source: str = SUPPRESSION_FILE,
) -> Tuple[List[Suppression], List[Finding]]:
    """Parse the suppression file; malformed lines come back as error
    findings against the file itself (never silently ignored)."""
    source = source.replace(os.sep, "/")
    sups: List[Suppression] = []
    problems: List[Finding] = []
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        body, _, comment = line.partition("#")
        justification = comment.strip()
        parts = body.split()
        if len(parts) != 2:
            problems.append(Finding(
                rule="R000", path=source, line=i, symbol="",
                message=f"malformed suppression line: {raw.strip()!r} "
                        "(expected 'RULE[@device] path[:symbol]  # "
                        "justification')"))
            continue
        rule_dev, target = parts
        rule, _, device = rule_dev.partition("@")
        path, _, symbol = target.partition(":")
        if not justification:
            problems.append(Finding(
                rule="R000", path=source, line=i, symbol="",
                message=f"suppression for {rule_dev} {target} has no "
                        "justification comment (mandatory: explain WHY "
                        "after '#')"))
            continue
        if device and (device not in ("cpu", "cuda")
                       or not rule.startswith("J")):
            problems.append(Finding(
                rule="R000", path=source, line=i, symbol="",
                message=f"suppression {rule_dev}: a device scope is "
                        "'@cpu' or '@cuda' on a launch-audit (J) rule"))
            continue
        sups.append(Suppression(rule=rule, path=path, symbol=symbol,
                                justification=justification, line=i,
                                device=device))
    return sups, problems


def load_suppressions(repo_root: str) -> Tuple[List[Suppression],
                                               List[Finding]]:
    path = os.path.join(repo_root, SUPPRESSION_FILE)
    if not os.path.exists(path):
        return [], []
    with open(path) as f:
        return parse_suppressions(f.read())


def apply_suppressions(
        findings: Iterable[Finding], sups: Sequence[Suppression],
        source: str = SUPPRESSION_FILE,
) -> Tuple[List[Finding], List[Finding], List[Finding]]:
    """Split findings into (kept, suppressed) and report stale
    suppressions as warning findings. Returns (kept, suppressed,
    stale_warnings)."""
    source = source.replace(os.sep, "/")
    kept: List[Finding] = []
    suppressed: List[Finding] = []
    used = [False] * len(sups)
    for f in findings:
        hit = False
        for i, s in enumerate(sups):
            if s.matches(f):
                used[i] = True
                hit = True
        (suppressed if hit else kept).append(f)
    stale = [
        Finding(rule="R000", path=source, line=s.line, symbol="",
                message=f"stale suppression ({s.rule}"
                        f"{'@' + s.device if s.device else ''} {s.path}"
                        f"{':' + s.symbol if s.symbol else ''}) matches "
                        "no current finding — remove it",
                severity="warning")
        for s, u in zip(sups, used) if not u
    ]
    return kept, suppressed, stale
