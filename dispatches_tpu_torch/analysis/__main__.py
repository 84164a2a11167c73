"""CLI: ``python -m dispatches_tpu_torch.analysis [--check|--write-baseline|
--selftest] [--json] [--baseline FILE] [paths...]`` (counterpart of
``python -m dispatches_tpu.analysis``, with the same exit codes and JSON
document).

Default action is ``--check`` over the ``dispatches_tpu_torch`` package:
run both AST passes (graftlint GL001-GL008 + lockcheck GL009-GL012),
subtract the committed baseline, and exit non-zero iff NEW findings
exist.  tests/test_torch_analysis.py runs exactly this.
``--json`` emits the findings as one machine-readable document
(rule/path/line/message/fingerprint + a ``baselined`` flag per
finding) so CI can annotate instead of grepping text; the exit-code
contract is identical.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional, Sequence

from dispatches_tpu_torch.analysis.graftlint import (
    DEFAULT_BASELINE,
    RULES,
    Finding,
    lint_paths,
    load_baseline,
    new_findings,
    package_root,
    write_baseline,
)
from dispatches_tpu_torch.analysis.lockcheck import check_paths
from dispatches_tpu_torch.analysis.selftest import run_selftest

JSON_SCHEMA_VERSION = 1


def _json_report(findings: Sequence[Finding],
                 fresh: Sequence[Finding]) -> str:
    fresh_ids = {id(f) for f in fresh}
    return json.dumps({
        "schema": JSON_SCHEMA_VERSION,
        "findings": [
            {
                "rule": f.rule,
                "name": RULES[f.rule],
                "path": f.path,
                "line": f.line,
                "col": f.col,
                "message": f.message,
                "fingerprint": f.fingerprint,
                "baselined": id(f) not in fresh_ids,
            }
            for f in findings
        ],
        "counts": {
            "total": len(findings),
            "baselined": len(findings) - len(fresh),
            "new": len(fresh),
        },
    }, indent=2)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dispatches_tpu_torch.analysis",
        description="graftlint: torch/CUDA-discipline + lock-discipline "
                    "static analysis",
    )
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files/dirs to lint (default: the "
                         "dispatches_tpu_torch package)")
    ap.add_argument("--check", action="store_true",
                    help="fail on findings beyond the baseline "
                         "(default action)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept all current findings as legacy")
    ap.add_argument("--selftest", action="store_true",
                    help="run the rule self-test corpus")
    ap.add_argument("--json", action="store_true",
                    help="emit findings as a JSON document (same exit "
                         "code as the text report)")
    ap.add_argument("--baseline", type=Path, default=DEFAULT_BASELINE)
    ns = ap.parse_args(argv)

    if ns.selftest:
        errors = run_selftest()
        for e in errors:
            print(f"SELFTEST FAIL: {e}")
        if not errors:
            print("graftlint selftest: all rules fire / no false "
                  "positives on the corpus")
        return 1 if errors else 0

    paths = ns.paths or [package_root()]
    findings: List[Finding] = lint_paths(paths) + check_paths(paths)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))

    if ns.write_baseline:
        n = write_baseline(findings, ns.baseline)
        print(f"graftlint: wrote {n} baseline finding(s) to {ns.baseline}")
        return 0

    baseline = load_baseline(ns.baseline)
    fresh = new_findings(findings, baseline)

    if ns.json:
        print(_json_report(findings, fresh))
        return 1 if fresh else 0

    for f in fresh:
        print(f"{f.render()}  [fingerprint {f.fingerprint}]")
    n_base = len(findings) - len(fresh)
    print(
        f"graftlint: {len(findings)} finding(s), {n_base} baselined, "
        f"{len(fresh)} new"
    )
    if fresh:
        print(
            "New findings fail --check. Fix them, or (for accepted "
            "legacy debt) regenerate the baseline with --write-baseline."
        )
    return 1 if fresh else 0


if __name__ == "__main__":
    sys.exit(main())
