"""CLI for graftcheck.

``python -m deeplearning4j_torch.analysis --check`` scans the package
against the shipped baseline and exits non-zero on any unbaselined
finding (or any stale baseline entry — the audited list must not rot).
``--list`` prints every finding including baselined ones, ``--baseline``
points at an alternative baseline file, ``--root`` at an alternative
package directory.
"""

from __future__ import annotations

import argparse
import sys

from deeplearning4j_torch.analysis.core import (DEFAULT_BASELINE, Baseline,
                                              analyze)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m deeplearning4j_torch.analysis")
    ap.add_argument("--check", action="store_true",
                    help="exit non-zero on unbaselined findings (default)")
    ap.add_argument("--list", action="store_true",
                    help="also print baselined findings with their "
                         "justifications")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help="baseline JSON path (default: the shipped one)")
    ap.add_argument("--root", default=None,
                    help="package directory to scan (default: the "
                         "installed deeplearning4j_torch package)")
    args = ap.parse_args(argv)

    try:
        import os
        baseline = Baseline.load(args.baseline) \
            if os.path.exists(args.baseline) else Baseline()
    except ValueError as e:
        print(f"graftcheck: bad baseline: {e}", file=sys.stderr)
        return 2

    report = analyze(root=args.root, baseline=baseline)

    for err in report.parse_errors:
        print(f"graftcheck: parse error: {err}", file=sys.stderr)
    for f in report.unbaselined:
        print(f.render())
    if args.list:
        for f in report.baselined:
            just = baseline.entries.get(f.key, "")
            print(f"[baselined] {f.render()}  # {just}")
    for key in report.stale_baseline:
        print(f"graftcheck: stale baseline entry (matches nothing): {key}")

    n = len(report.unbaselined)
    print(f"graftcheck: {report.files_scanned} files, "
          f"{len(report.findings)} findings "
          f"({n} unbaselined, {len(report.baselined)} baselined, "
          f"{len(report.stale_baseline)} stale baseline entries)")
    if n or report.stale_baseline or report.parse_errors:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
