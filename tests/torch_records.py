"""Recorded JAX outputs that tier-1 parity tests hold the port to.

Some JAX sides compile for minutes on the CPU (a vmapped IPM over the
flagship, the hybrid's traced IPM, a simulated market day).  Their
outputs depend only on fixed inputs, so they are recorded once in
``tests/data/<name>.json`` and the tier-1 test compares the port with the
record, with the comparisons and tolerances it used against the live JAX
run.  Each record has a ``slow`` test that rebuilds the JAX side and holds
it to the file bitwise, so a record cannot drift from the JAX package.

A record is a tree of dicts, lists, strings, numbers and numpy arrays;
an array is stored as its dtype, shape and values (``repr`` floats, so
the JSON round trip is exact).  Rewrite records with

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/torch_records.py [name ...]

(every record when no name is given).
"""

from __future__ import annotations

import importlib
import json
import sys
from pathlib import Path

import numpy as np

DATA = Path(__file__).parent / "data"

#: record name -> (test module that rebuilds it, its function)
RECORDS = {
    "hybrid_ipm_jax_t4_dense": ("test_torch_re_hybrid", "jax_record"),
    "market_day_jax_csvs": ("test_torch_market_day", "jax_record"),
    "ipm_flagship_dense_jax": ("test_torch_ipm", "jax_record"),
    "structured_flagship_jax": ("test_torch_structured", "jax_record"),
    "grid_bidders_jax": ("test_torch_grid", "jax_record"),
    "pdlp_batch_jax": ("test_torch_pdlp_batch", "jax_record"),
    "reduced_vmap_newton_jax": ("test_torch_reduced", "jax_record"),
    "nuclear_price_taker_jax": ("test_torch_nuclear", "jax_record"),
    "soak_reports_jax": ("test_torch_soak", "jax_record"),
    "solverlog_traces_jax": ("test_torch_solverlog", "jax_record"),
    "obs_cli_keys_jax": ("test_torch_obs_cli", "jax_record"),
    "analysis_recompile_counts_jax": ("test_torch_analysis", "jax_record"),
}


def encode(tree):
    """``tree`` as JSON-ready values (arrays and numpy scalars tagged)."""
    if isinstance(tree, dict):
        return {str(k): encode(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [encode(v) for v in tree]
    if isinstance(tree, (str, bool, int, float)) or tree is None:
        return tree
    a = np.asarray(tree)
    return {"__nd__": {"dtype": a.dtype.str, "shape": list(a.shape), "value": a.tolist()}}


def decode(obj):
    """The inverse of :func:`encode`: arrays come back as numpy arrays."""
    if isinstance(obj, dict):
        if set(obj) == {"__nd__"}:
            nd = obj["__nd__"]
            return np.asarray(nd["value"], dtype=np.dtype(nd["dtype"])).reshape(nd["shape"])
        return {k: decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode(v) for v in obj]
    return obj


def path(name: str) -> Path:
    return DATA / f"{name}.json"


def read(name: str):
    """The record ``name``, decoded."""
    return decode(json.loads(path(name).read_text()))


def matches(name: str, tree) -> bool:
    """Whether ``tree`` equals the record ``name`` bitwise."""
    return json.loads(json.dumps(encode(tree))) == json.loads(path(name).read_text())


def write(name: str, tree) -> None:
    path(name).write_text(json.dumps(encode(tree), indent=1, sort_keys=True) + "\n")


def main(names) -> None:
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    for name in names or sorted(RECORDS):
        module, fn = RECORDS[name]
        write(name, getattr(importlib.import_module(module), fn)())
        print(f"wrote {path(name)}")


if __name__ == "__main__":
    main(sys.argv[1:])
