"""The PyTorch port's perf ledger (``dispatches_tpu_torch.obs.ledger``) held to
the JAX package's ``obs.ledger``: the constants and the gated-metric table,
byte-equal ``ledger.jsonl`` lines for the same records, each package
loading the other's file (a torn last line skipped), and
``check_regressions`` / ``format_trend`` / ``format_check`` equal on a
seeded history with groups that pass, regress and lack history, across
window and tolerance settings (``DISPATCHES_TPU_OBS_LEDGER_TOL`` too)."""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import ledger as jled  # noqa: E402

from dispatches_tpu_torch.obs import ledger as tled  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _history(seed):
    """Records of three groups (sweep on cuda and on cpu, a serve group),
    the last cuda record halving solves/s; one record of another schema."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(7):
        for kind, wl, backend, n in (("sweep", "abc123", "cuda", 7), ("sweep", "abc123", "cpu", 2),
                                     ("serve", "w1", "cuda", 4)):
            if i >= n:
                continue
            m = {"solves_per_sec": float(rng.normal(100.0, 5.0)),
                 "pdhg_iters_mean": float(rng.normal(800.0, 10.0)),
                 "compile_count": int(rng.integers(1, 3)), "note": "x"}
            if kind == "sweep" and backend == "cuda" and i == n - 1:
                m["solves_per_sec"] = 40.0
            out.append({"schema": 1, "sha": f"{i:012x}", "ts": 1.0 + i, "kind": kind,
                        "workload": wl, "backend": backend, "metrics": m,
                        **({"extra": {"algorithm": "halpern"}} if i % 2 else {})})
    out.append({"schema": 2, "kind": "sweep", "metrics": {}})
    return out


def test_constants_match_jax():
    for name in ("SCHEMA_VERSION", "LEDGER_FILE", "DEFAULT_DIR", "DEFAULT_TOL",
                 "DEFAULT_WINDOW", "MIN_RECORDS"):
        assert getattr(tled, name) == getattr(jled, name), name
    assert list(tled.GATED_METRICS.items()) == list(jled.GATED_METRICS.items())
    assert tled.__all__ == jled.__all__
    assert (tled.SCHEMA_VERSION, tled.DEFAULT_WINDOW, tled.MIN_RECORDS,
            tled.DEFAULT_TOL) == (1, 5, 3, 0.3)


def test_records_byte_equal_and_cross_loaded(tmp_path):
    recs = _history(0)
    for r in recs:
        tled.append(r, dir=tmp_path / "t")
        jled.append(r, dir=tmp_path / "j")
    t_bytes = (tmp_path / "t" / tled.LEDGER_FILE).read_bytes()
    assert t_bytes == (tmp_path / "j" / jled.LEDGER_FILE).read_bytes()
    # each package loads the other's file; a torn last line is skipped
    with open(tmp_path / "t" / tled.LEDGER_FILE, "a") as f:
        f.write('{"schema": 1, "kind": "sw')
    assert jled.load(tmp_path / "t") == tled.load(tmp_path / "j") == recs
    assert tled.load(tmp_path / "nowhere") == []
    # make_record: the same keys and identity as JAX's, backend a torch
    # device type
    t_rec = tled.make_record("sweep", "abc", {"solves_per_sec": 1.0}, backend="cuda",
                             extra={"dispatch": "direct"})
    j_rec = jled.make_record("sweep", "abc", {"solves_per_sec": 1.0}, backend="cuda",
                             extra={"dispatch": "direct"})
    assert list(t_rec) == list(j_rec)
    assert {k: v for k, v in t_rec.items() if k != "ts"} == \
        {k: v for k, v in j_rec.items() if k != "ts"}
    assert json.loads(json.dumps(t_rec, sort_keys=True))["backend"] == "cuda"


@pytest.mark.parametrize("window,tol", [(5, None), (3, 0.1), (2, 0.7)])
def test_gate_and_renders_equal_jax(window, tol):
    recs = _history(1)
    t_out = tled.check_regressions(recs, window=window, tol=tol)
    assert t_out == jled.check_regressions(recs, window=window, tol=tol)
    assert tled.format_check(t_out) == jled.format_check(t_out)
    assert tled.format_trend(recs) == jled.format_trend(recs)
    groups = {e["group"] for e in t_out["insufficient"]}
    assert groups == {"sweep/abc123/cpu"}
    if tol is None:
        assert not t_out["ok"] and t_out["regressions"][0]["metric"] == "solves_per_sec"
    assert tled.format_trend([]) == jled.format_trend([])
    empty = tled.check_regressions([])
    assert empty == jled.check_regressions([]) and empty["ok"]
    assert tled.format_check(empty) == jled.format_check(empty)


def test_env_flags_and_directory(monkeypatch, tmp_path):
    monkeypatch.delenv("DISPATCHES_TPU_OBS_LEDGER_DIR", raising=False)
    monkeypatch.setenv("DISPATCHES_TPU_OBS_LEDGER_TOL", "0.45")
    assert not tled.enabled() and tled.default_dir() == jled.default_dir() == "perf_ledger"
    assert tled.default_tolerance() == jled.default_tolerance() == 0.45
    recs = _history(2)
    assert tled.check_regressions(recs) == jled.check_regressions(recs)
    monkeypatch.setenv("DISPATCHES_TPU_OBS_LEDGER_DIR", str(tmp_path))
    assert tled.enabled() and tled.default_dir() == str(tmp_path)
    for r in recs:
        tled.append(r)
    assert jled.check_regressions(dir=str(tmp_path)) == tled.check_regressions()
    assert isinstance(tled.git_sha(), str) and tled.git_sha()
