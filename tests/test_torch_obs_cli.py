"""The PyTorch port's obs CLI (``python -m dispatches_tpu_torch.obs``) held to
the JAX package's, both called in-process through ``main(argv)``, the
port's with ``--device cpu``:

- ``--soak --json`` and ``--report --json`` carry the JAX CLI's keys (the
  soak report's whole key tree; the report's top-level keys, span names
  and per-span columns), and ``--soak`` honours ``--out`` and
  ``DISPATCHES_TPU_SOAK_REPORT_DIR``;
- ``--timeline --json --trace-file``, ``--slo [--check] --metrics-file``,
  ``--ledger`` / ``--check-regressions --ledger-dir`` and ``--flight``
  print what the JAX CLI prints on the same inputs and exit with its
  codes; ``--prom`` prints the port registry's Prometheus text; no action
  prints the usage and exits 2.

The JAX CLI's ``--soak --json`` and ``--report --json`` outputs (their key
trees and the JAX soak's request counts) are recorded in
``tests/data/obs_cli_keys_jax.json`` (``tests/torch_records.py``), which
``test_cli_jax_record_is_current`` (slow) holds to fresh JAX runs.
"""

import contextlib
import io
import json
import os
import tempfile

import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import flight as jfl  # noqa: E402
from dispatches_tpu.obs import trace as jtrace  # noqa: E402
from dispatches_tpu.obs.__main__ import main as jmain  # noqa: E402

from dispatches_tpu_torch.obs import export as texp  # noqa: E402
from dispatches_tpu_torch.obs import flight as tfl  # noqa: E402
from dispatches_tpu_torch.obs import ledger as tled  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from dispatches_tpu_torch.obs.__main__ import main as tmain  # noqa: E402
import torch_records  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

EXAMPLE_SPEC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "examples", "slo_spec.json")
CPU = ["--device", "cpu"]
KEYS_RECORD = "obs_cli_keys_jax"


@pytest.fixture(autouse=True)
def _clean():
    for mod in (tfl, jfl):
        mod.reset()
    yield
    for mod in (tfl, jfl, ttrace, jtrace):
        mod.reset()
    ttrace.enable(False)
    jtrace.enable(False)


def _run(main, argv, capsys):
    rc = main(argv)
    return rc, capsys.readouterr().out


def _key_tree(d):
    if isinstance(d, dict):
        return {k: _key_tree(v) for k, v in d.items()}
    if isinstance(d, list):
        return [_key_tree(v) for v in d[:1]]
    return None


def _report_keys(payload):
    return {"top": sorted(payload),
            "spans": {k: sorted(v) for k, v in payload["spans"].items()}}


def jax_record():
    """The JAX CLI's ``--soak --json --duration 1`` key tree and request
    counts, and its ``--report --json`` keys (the demo compiles the JAX
    PDLP for seconds)."""
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for name, argv in (("soak", ["--soak", "--json", "--duration", "1", "--out", d]),
                           ("report", ["--report", "--json"])):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert jmain(argv) == 0
            payload = json.loads(buf.getvalue())
            out[name] = ({"keys": _key_tree(payload), "requests": payload["requests"],
                          "spec": payload["spec"]} if name == "soak"
                         else _report_keys(payload))
    for mod in (jfl, jtrace):
        mod.reset()
    jtrace.enable(False)
    return out


@pytest.mark.slow
def test_cli_jax_record_is_current():
    assert torch_records.matches(KEYS_RECORD, jax_record())


def test_soak_json_keys_equal_jax(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("DISPATCHES_TPU_SOAK_REPORT_DIR", str(tmp_path / "env"))
    rc, out = _run(tmain, ["--soak", "--json", "--duration", "1", *CPU], capsys)
    t, j = json.loads(out), torch_records.read(KEYS_RECORD)["soak"]
    assert rc == 0 and json.loads(json.dumps(_key_tree(t))) == j["keys"]
    assert t["report_path"] == str(tmp_path / "env" / "soak_report.json")
    assert t["requests"] == j["requests"] and t["spec"] == j["spec"]
    assert t["virtual"] is True and t["soak_p99_ms"] > 0
    rc, out = _run(tmain, ["--soak", "--duration", "0.5", *CPU, "--out", str(tmp_path / "t")],
                   capsys)
    assert rc == 0 and "== soak report (virtual clock" in out and "soak_latency_p99" in out
    assert (tmp_path / "t" / "soak_report.json").exists()


def test_report_json_keys_equal_jax(capsys):
    rc, out = _run(tmain, ["--report", "--json", *CPU], capsys)
    t = json.loads(out)
    assert rc == 0 and _report_keys(t) == torch_records.read(KEYS_RECORD)["report"]
    assert t["spans"]["serve.request"]["count"] == 2
    rc, out = _run(tmain, ["--prom"], capsys)
    assert rc == 0 and out == texp.render_prometheus()
    assert "# TYPE dispatches_tpu_serve_requests counter" in out


def _pipelined_events(plan=7):
    def span(name, ts, dur, **args):
        return {"name": name, "ph": "X", "ts": float(ts), "dur": float(dur), "pid": 1,
                "tid": 1, "args": args}
    return [span("plan.stage", 0, 10, plan=plan, lanes=4),
            span("plan.submit", 10, 5, plan=plan, seq=1, label="a", lanes=4, live=3,
                 inflight=1, request_ids=[11, 12, 13]),
            span("plan.stage", 15, 10, plan=plan, lanes=4),
            span("plan.submit", 25, 5, plan=plan, seq=2, label="a", lanes=4, live=4,
                 inflight=2),
            span("plan.fence", 30, 20, plan=plan, seq=1, label="a", lanes=4, inflight=1),
            span("plan.fence", 50, 5, plan=plan, seq=2, label="a", lanes=4, inflight=0)]


def test_host_views_equal_jax(tmp_path, capsys):
    trace_path = tmp_path / "trace.json"
    trace_path.write_text(json.dumps({"traceEvents": _pipelined_events()}))
    for argv in (["--timeline", "--json", "--trace-file", str(trace_path)],
                 ["--timeline", "--trace-file", str(trace_path)],
                 ["--report", "--json", "--trace-file", str(trace_path)],
                 ["--report", "--trace-file", str(trace_path)]):
        assert _run(tmain, argv, capsys) == _run(jmain, argv, capsys), argv
    out_t, out_j = tmp_path / "t.json", tmp_path / "j.json"
    for main, out in ((tmain, out_t), (jmain, out_j)):
        assert main(["--timeline", "--trace-file", str(trace_path),
                     "--export-trace", str(out)]) == 0
    capsys.readouterr()
    assert json.loads(out_t.read_text()) == json.loads(out_j.read_text())
    assert _run(tmain, [], capsys)[0] == _run(jmain, [], capsys)[0] == 2


def _snapshot(missed):
    return {"serve.latency_ms": {"kind": "histogram", "values": {
                "bucket=a#0": {"count": 10, "mean": 5.0, "p50": 5.0, "p95": 5.0, "p99": 5.0}}},
            "serve.deadline": {"kind": "counter", "values": {f"event={missed}": 5}},
            "serve.requests": {"kind": "counter", "values": {"event=submitted": 5}}}


def test_slo_ledger_flight_equal_jax(tmp_path, capsys):
    for name, missed in (("ok", "met"), ("bad", "missed")):
        (tmp_path / f"{name}.json").write_text(json.dumps(_snapshot(missed)))
    for name in ("ok", "bad"):
        for extra in ([], ["--json"], ["--check"], ["--check", "--json"]):
            argv = ["--slo", "--slo-spec", EXAMPLE_SPEC, "--metrics-file",
                    str(tmp_path / f"{name}.json"), *extra]
            got = _run(tmain, argv, capsys)
            assert got == _run(jmain, argv, capsys), argv
            assert got[0] == (1 if name == "bad" and "--check" in extra else 0)
    led = tmp_path / "ledger"
    for i, sps in enumerate((100.0, 101.0, 99.0, 40.0)):
        tled.append({"schema": 1, "sha": f"{i:012x}", "ts": float(i), "kind": "sweep",
                     "workload": "w", "backend": "cuda",
                     "metrics": {"solves_per_sec": sps, "compile_count": 1}}, dir=led)
        for argv in (["--ledger", "--ledger-dir", str(led)],
                     ["--ledger", "--json", "--ledger-dir", str(led)],
                     ["--check-regressions", "--ledger-dir", str(led)],
                     ["--check-regressions", "--json", "--ledger-dir", str(led),
                      "--window", "2", "--tol", "0.5"]):
            got = _run(tmain, argv, capsys)
            assert got == _run(jmain, argv, capsys), argv
        assert _run(tmain, ["--check-regressions", "--ledger-dir", str(led)], capsys)[0] == \
            (1 if i == 3 else 0)
    tfl.enable(str(tmp_path / "flight"))
    tfl.trigger("deadline_miss", request_id=7, bucket="pdlp#0")
    rc, out = _run(tmain, ["--flight", "--flight-dir", str(tmp_path / "flight")], capsys)
    assert rc == 0 and "deadline_miss request_id=7 bucket=pdlp#0" in out
    rc, out = _run(tmain, ["--flight", "--json", "--flight-dir", str(tmp_path / "flight")],
                   capsys)
    assert rc == 0 and json.loads(out)["bundles"][0]["trigger"]["request_id"] == 7
    empty = ["--flight", "--flight-dir", str(tmp_path / "empty")]
    assert _run(tmain, empty, capsys) == _run(jmain, empty, capsys)
