"""CLI: ``python -m dispatches_tpu_torch.sweep --report [DIR] [--json]``.

Prints the progress/throughput report of an on-disk sweep
``ResultStore`` — chunk completion, per-point status counts
(ok / retried / quarantined), convergence, and solves/s (overall and
steady-state, i.e. excluding the first chunk).  ``DIR`` defaults to the
``DISPATCHES_TPU_SWEEP_RESULT_DIR`` flag / the ``SweepOptions`` default
directory.  Exit code 0, or 2 when ``DIR`` holds no store.  Reads files
only: it runs on any host, card or not.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dispatches_tpu_torch.sweep",
        description="design-space sweep progress/throughput report",
    )
    ap.add_argument("--report", action="store_true",
                    help="print the store report (default action)")
    ap.add_argument("--json", action="store_true",
                    help="print the raw summary dict as one JSON line")
    ap.add_argument("store", nargs="?", default=None,
                    help="ResultStore directory (default: the "
                         "DISPATCHES_TPU_SWEEP_RESULT_DIR flag)")
    ns = ap.parse_args(argv)

    from dispatches_tpu_torch.sweep import ResultStore, SweepOptions, format_report

    path = ns.store if ns.store is not None else SweepOptions.from_env().result_dir
    try:
        store = ResultStore(path)
    except FileNotFoundError as exc:
        print(str(exc), file=sys.stderr)
        return 2
    summary = store.summary()
    print(json.dumps(summary) if ns.json else format_report(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
