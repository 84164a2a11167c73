"""CLI: ``python -m dispatches_tpu_torch.serve --stats [--n N] [--json]
[--device DEV]``.

Drives the JAX package's demo workload (staggered battery-arbitrage LP
requests, one shape bucket per ``--horizons`` entry) through a fresh
``SolveService`` on ``--device`` (the card unless given) and prints the
``--stats`` text report; with ``--json`` the raw metrics dict as one
JSON line.  Exits 1 unless every request is ``DONE``.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch


def _arbitrage_nlp(T: int):
    from dispatches_tpu_torch.core.graph import Flowsheet, tshift

    fs = Flowsheet(horizon=T)
    fs.add_var("charge", lb=0, ub=2.0)
    fs.add_var("discharge", lb=0, ub=2.0)
    fs.add_var("soc", lb=0, ub=8.0)
    fs.add_param("price", np.full(T, 30.0))
    fs.add_eq(
        "soc_evolution",
        lambda v, p: v["soc"] - tshift(v["soc"], v["soc"].new_zeros(()))
        - 0.9 * v["charge"] + v["discharge"] / 0.9,
    )
    return fs.compile(
        objective=lambda v, p: torch.sum(
            p["price"] * (v["discharge"] - v["charge"])),
        sense="max",
    )


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m dispatches_tpu_torch.serve",
        description="micro-batching solve service demo / stats report",
    )
    ap.add_argument("--stats", action="store_true",
                    help="print the text stats report (default action)")
    ap.add_argument("--json", action="store_true",
                    help="print the raw metrics dict as one JSON line")
    ap.add_argument("--n", type=int, default=24,
                    help="requests per bucket (default 24)")
    ap.add_argument("--max-batch", type=int, default=8,
                    help="service max_batch (default 8)")
    ap.add_argument("--horizons", default="8,12",
                    help="comma-separated model horizons, one shape "
                         "bucket each (default 8,12)")
    ap.add_argument("--device", default=None,
                    help="device the service runs on (default: cuda)")
    ns = ap.parse_args(argv)

    from dispatches_tpu_torch.serve import ServeOptions, SolveService

    service = SolveService(ServeOptions.from_env(max_batch=ns.max_batch),
                           device=ns.device)
    rng = np.random.default_rng(0)
    handles = []
    for T in (int(t) for t in ns.horizons.split(",")):
        nlp = _arbitrage_nlp(T)
        defaults = nlp.default_params()
        for _ in range(ns.n):
            price = 30.0 + 10.0 * rng.standard_normal(T)
            params = {"p": {**defaults["p"], "price": price},
                      "fixed": defaults["fixed"]}
            handles.append(service.submit(nlp, params, solver="pdlp"))
    service.flush_all()
    n_done = sum(h.result().status == "DONE" for h in handles)

    if ns.json:
        print(json.dumps({"demo_requests": len(handles),
                          "demo_done": n_done, **service.metrics()},
                         default=str))
    else:
        print(service.format_stats())
    return 0 if n_done == len(handles) else 1


if __name__ == "__main__":
    sys.exit(main())
