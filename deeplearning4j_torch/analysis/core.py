"""graftcheck core: findings, the baseline mechanism, and the runner (the
port's own copy of ``deeplearning4j_tpu/analysis/core.py``).

Two rule families run over the package's ASTs:

- ``torch_rules`` — device→host syncs in the serving and training hot
  loops, and randomness that bypasses a seeded generator or the keyed
  ``ops/random.py``.
- ``concurrency_rules`` — per-class lock-ownership inference, a
  cross-module lock-acquisition graph with cycle detection,
  lock-held-across-blocking-call detection, and wall-clock duration
  math (the ``monotonic-deadline`` rule).

Findings carry a *stable key* (rule + file + scope + detail — no line
numbers), so the baseline survives unrelated edits. The baseline file is
the port's audited list of known-unsafe spots: every entry needs a
one-line human justification, and the test gate fails on any finding
that is neither fixed nor baselined.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Iterable, List, Optional

#: repo-relative package directory the default run scans
DEFAULT_PACKAGE = "deeplearning4j_torch"

#: baseline shipped with the package (the audited known-unsafe list)
DEFAULT_BASELINE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "baseline.json")


@dataclass
class Finding:
    """One analyzer hit. ``key`` intentionally omits the line number so a
    baseline entry keeps matching while surrounding code moves."""

    rule: str          # e.g. "conc-mixed-lock"
    path: str          # repo-relative posix path
    line: int
    col: int
    scope: str         # "Class.method", "function", or "<module>"
    detail: str        # rule-specific stable token (attr name, callee, ...)
    message: str

    @property
    def key(self) -> str:
        return f"{self.rule}::{self.path}::{self.scope}::{self.detail}"

    def render(self) -> str:
        return (f"{self.path}:{self.line}:{self.col}: {self.rule} "
                f"[{self.scope}] {self.message}")


@dataclass
class Baseline:
    """Audited suppressions: key -> justification. Every entry MUST carry
    a non-empty justification string — the baseline is documentation of
    deliberate unsafety, not a mute button."""

    entries: dict = field(default_factory=dict)
    path: Optional[str] = None

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path, encoding="utf-8") as fh:
            raw = json.load(fh)
        entries = {}
        for e in raw.get("entries", []):
            key = e.get("key")
            just = e.get("justification", "")
            if not key:
                raise ValueError(f"baseline entry missing 'key': {e}")
            if not isinstance(just, str) or not just.strip():
                raise ValueError(
                    f"baseline entry for {key!r} has no justification — "
                    "every suppression must say WHY the spot is deliberate")
            entries[key] = just
        return cls(entries=entries, path=path)

    def match(self, finding: Finding) -> bool:
        return finding.key in self.entries

    def stale_keys(self, findings: Iterable[Finding]) -> List[str]:
        hit = {f.key for f in findings}
        return sorted(k for k in self.entries if k not in hit)


@dataclass
class Report:
    findings: List[Finding]        # everything the rules produced
    unbaselined: List[Finding]     # findings with no baseline entry
    baselined: List[Finding]
    stale_baseline: List[str]      # baseline keys matching nothing
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)


def _iter_py_files(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames
                       if d not in ("__pycache__", ".cache")]
        for name in sorted(filenames):
            if name.endswith(".py"):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def _relpath(path: str, base: str) -> str:
    return os.path.relpath(path, base).replace(os.sep, "/")


def analyze(root: Optional[str] = None,
            baseline: Optional[Baseline] = None,
            files: Optional[List[str]] = None) -> Report:
    """Run both rule families over ``root`` (a package directory) or an
    explicit ``files`` list. ``baseline`` splits findings into
    unbaselined (gate-failing) and baselined (audited)."""
    from deeplearning4j_torch.analysis import concurrency_rules, torch_rules

    if root is None:
        root = os.path.join(_repo_root(), DEFAULT_PACKAGE)
    base = os.path.dirname(os.path.abspath(root))
    paths = files if files is not None else _iter_py_files(root)

    findings: List[Finding] = []
    parse_errors: List[str] = []
    modules = []  # (relpath, tree) pairs, for the cross-module pass
    for path in paths:
        rel = _relpath(path, base)
        try:
            with open(path, encoding="utf-8") as fh:
                tree = ast.parse(fh.read(), filename=path)
        except (OSError, SyntaxError) as e:
            parse_errors.append(f"{rel}: {e}")
            continue
        modules.append((rel, tree))

    for rel, tree in modules:
        findings.extend(torch_rules.check_module(tree, rel))
        findings.extend(concurrency_rules.check_module(tree, rel))
    # the lock-acquisition graph needs every module's class info at once
    findings.extend(concurrency_rules.check_lock_graph(modules))

    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    if baseline is None:
        baseline = Baseline()
    unbase = [f for f in findings if not baseline.match(f)]
    based = [f for f in findings if baseline.match(f)]
    return Report(findings=findings, unbaselined=unbase, baselined=based,
                  stale_baseline=baseline.stale_keys(findings),
                  files_scanned=len(modules), parse_errors=parse_errors)


def _repo_root() -> str:
    # analysis/ lives at deeplearning4j_torch/analysis/ — two dirs up is
    # the repo root the default scan is relative to
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def run_check(root: Optional[str] = None,
              baseline_path: Optional[str] = None) -> Report:
    """The CLI/test entry: scan the package against the shipped baseline
    (or ``baseline_path``)."""
    bp = baseline_path if baseline_path is not None else DEFAULT_BASELINE
    baseline = Baseline.load(bp) if os.path.exists(bp) else Baseline()
    return analyze(root=root, baseline=baseline)
