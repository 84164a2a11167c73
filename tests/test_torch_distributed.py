"""The PyTorch port's distributed tracing (``dispatches_tpu_torch.obs.distributed``)
held to the JAX package's ``obs.distributed`` on the same inputs:

- trace context: the submit context's wire dict, the innermost open span
  as ``par``, a decoder tolerant of missing keys, a re-hydrated remote
  context, equal to JAX's; the disarmed RPC client builds no context
  (spy-pinned) and the armed one does; an armed port client's context
  re-hydrates in a JAX server's ``net.rpc.serve`` span and the other way
  round;
- clock alignment: ``offset_from_exchange`` on seeded exchanges and
  ``sync_clock`` on one scripted ping sequence, equal to JAX's (lowest RTT
  wins, failures skipped, ``None`` on total failure);
- merging: ``merge_traces`` on seeded multi-process event lists (remote
  epochs ahead and behind) equal to JAX's and accepted by
  ``validate_chrome_trace``; ``export_merged_trace`` writes JAX's bytes;
  ``request_processes`` and ``report.journey_processes`` equal JAX's;
  ``merge_registry_snapshots`` sums counters only, as JAX's;
- flight bundles: the remote facade's ``deadline_miss`` and the router's
  ``plan_error`` carry the implicated replica's snapshot, as JAX's; a
  failed snapshot pull never raises.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.net import rpc as jrpc  # noqa: E402
from dispatches_tpu.obs import distributed as jdist  # noqa: E402
from dispatches_tpu.obs import flight as jflight  # noqa: E402
from dispatches_tpu.obs import report as jreport  # noqa: E402
from dispatches_tpu.obs import trace as jtrace  # noqa: E402

from dispatches_tpu_torch.net import rpc as trpc  # noqa: E402
from dispatches_tpu_torch.obs import distributed as tdist  # noqa: E402
from dispatches_tpu_torch.obs import flight as tflight  # noqa: E402
from dispatches_tpu_torch.obs import report as treport  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from torch_isolation import isolated_obs_state  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

PKGS = [(tdist, ttrace), (jdist, jtrace)]


def test_api_matches_jax():
    assert tdist.__all__ == jdist.__all__
    assert tdist.TraceContext._fields == jdist.TraceContext._fields
    assert tdist.ClockSync._fields == jdist.ClockSync._fields


def _contexts(dist, trace):
    dist.enable(True)
    trace.enable(True)
    dist.set_generation(3)
    out = {}
    with dist.submit_context("peer/abc/1-0") as ctx:
        out["bare"] = dist.wire_context()
        with trace.span("outer"):
            with trace.span("inner"):
                out["nested"] = dist.wire_context()
    out["ctx"] = tuple(ctx)
    out["after"] = dist.current()
    out["decoded"] = tuple(dist.decode_context(out["bare"]))
    out["empty"] = tuple(dist.decode_context({}))
    tc = {"rid": "r-9", "pid": 4242, "gen": 2, "par": "fleet.submit"}
    with dist.remote_context(tc) as rctx:
        out["remote"] = (tuple(rctx), dist.current() == rctx)
    out["outside"] = dist.wire_context()
    return out


def test_trace_context_equal_jax():
    t, j = (_contexts(*p) for p in PKGS)
    assert t == j
    assert t["bare"] == {"pid": os.getpid(), "gen": 3, "rid": "peer/abc/1-0"}
    assert t["nested"]["par"] == "inner" and t["after"] is None
    assert t["empty"] == (None, 0, 1, None) and t["remote"] == (("r-9", 4242, 2, "fleet.submit"),
                                                                True)


def test_disarmed_client_builds_no_context(monkeypatch):
    calls = []
    real = tdist.wire_context
    monkeypatch.setattr(tdist, "wire_context", lambda: calls.append(1) or real())
    seen = []
    server = trpc.RpcServer({"echo": lambda p: seen.append(p) or {"ok": 1}}).start()
    try:
        client = trpc.RpcClient("127.0.0.1", server.port)
        assert client.call("echo", {"x": 1})["ok"] == 1
        assert calls == []
        tdist.enable(True)
        assert client.call("echo", {"x": 2})["ok"] == 1
        client.close()
    finally:
        server.stop()
    assert calls and seen == [{"x": 1}, {"x": 2}]


@pytest.mark.parametrize("client_mod,server_pkg", [(trpc, (jrpc, jdist, jtrace)),
                                                   (jrpc, (trpc, tdist, ttrace))],
                         ids=["port-client", "jax-client"])
def test_context_rehydrates_across_packages(client_mod, server_pkg):
    server_rpc, server_dist, server_trace = server_pkg
    client_dist = tdist if client_mod is trpc else jdist
    for dist in (tdist, jdist):
        dist.enable(True)
    server_trace.enable(True)
    seen = []
    server = server_rpc.RpcServer({"who": lambda p: seen.append(server_dist.current()) or {}})
    server.start()
    try:
        client = client_mod.RpcClient("127.0.0.1", server.port)
        with client_dist.submit_context("peer/x/7"):
            client.call("who", {})
        client.close()
    finally:
        server.stop()
    assert seen[0].rid == "peer/x/7" and seen[0].pid == os.getpid()
    spans = [e for e in server_trace.events() if e["name"] == "net.rpc.serve"]
    assert spans and spans[0]["args"]["request_id"] == "peer/x/7"
    assert spans[0]["args"]["method"] == "who"


def test_offset_and_sync_clock_equal_jax(monkeypatch):
    rng = np.random.default_rng(3)
    for t0, rtt, remote in zip(rng.uniform(0, 1e6, 20), rng.uniform(0, 1e3, 20),
                               rng.uniform(-1e6, 1e6, 20)):
        assert tuple(tdist.offset_from_exchange(t0, t0 + rtt, remote)) == \
            tuple(jdist.offset_from_exchange(t0, t0 + rtt, remote))
    est = tdist.offset_from_exchange(5000.0, 5400.0, 200.0)
    assert est.offset_us == 5000.0 and 200.0 + est.offset_us == 5200.0

    def scripted(trace):
        samples = iter([Exception("transport"), {"now_us": 50.0}, {"now_us": 60.0},
                        {"pong": True}])
        clock = iter([0.0, 100.0, 200.0, 300.0, 310.0, 400.0, 500.0, 600.0, 700.0])
        monkeypatch.setattr(trace, "now_us", lambda: next(clock))

        def ping():
            item = next(samples)
            if isinstance(item, Exception):
                raise item
            return item

        return ping

    got = tdist.sync_clock(scripted(ttrace), samples=4)
    want = jdist.sync_clock(scripted(jtrace), samples=4)
    assert tuple(got) == tuple(want) == (245.0, 10.0)
    assert tdist.sync_clock(lambda: (_ for _ in ()).throw(OSError("down")), samples=2) is None


def _seeded_traces(seed):
    rng = np.random.default_rng(seed)
    local = [{"name": "fleet.request", "ph": "X", "ts": float(1000 + 10 * i),
              "dur": float(rng.uniform(100, 5000)), "tid": 1,
              "args": {"request_id": i, "origin_rid": f"p/{i}"}} for i in range(6)]
    remotes = []
    for w, off in ((4242, -899_000.0), (4343, 12_345.5), (4444, 0.0)):
        evts = [{"name": "serve.request", "ph": "X", "ts": float(rng.uniform(0, 1e6)),
                 "dur": float(rng.uniform(0, 2000)), "tid": int(rng.integers(5, 9)),
                 "args": {"request_id": int(rng.integers(0, 6)), "origin_rid": f"p/{k}"}}
                for k in range(5)]
        evts.append({"name": "serve.ping", "ph": "i", "ts": float(rng.uniform(0, 1e3)),
                     "tid": 5, "args": {}})
        remotes.append({"pid": w, "label": f"replica:{w}", "offset_us": off, "events": evts})
    return local, remotes


@pytest.mark.parametrize("seed", [0, 1])
def test_merge_traces_and_export_equal_jax(tmp_path, seed):
    local, remotes = _seeded_traces(seed)
    got = tdist.merge_traces(local, remotes, local_pid=1111)
    want = jdist.merge_traces(local, remotes, local_pid=1111)
    assert got == want
    assert treport.validate_chrome_trace(got) == [] and all(e["ts"] >= 0.0 for e in got)
    assert {m["args"]["name"] for m in got if m.get("ph") == "M"} == {
        "router", "replica:4242", "replica:4343", "replica:4444"}
    n_t = tdist.export_merged_trace(tmp_path / "t.json", local, remotes, local_pid=1111, dropped=3)
    n_j = jdist.export_merged_trace(tmp_path / "j.json", local, remotes, local_pid=1111, dropped=3)
    assert n_t == n_j == len(got)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    for rid in (0, 3, 5, "p/2"):
        assert tdist.request_processes(got, rid) == jdist.request_processes(want, rid)
        assert treport.journey_processes(got, rid) == jreport.journey_processes(want, rid)


def test_merge_registry_snapshots_equal_jax():
    rng = np.random.default_rng(7)
    snaps = {}
    for w in range(3):
        snaps[f"w{w}"] = {
            "net.bytes": {"kind": "counter", "values": {
                "dir=tx": float(rng.integers(1, 99)), "dir=rx": float(rng.integers(1, 99))}},
            "serve.requests": {"kind": "counter", "values": {
                f"event=e{k}": float(rng.integers(0, 9)) for k in range(w + 1)}},
            "serve.queue_depth": {"kind": "gauge", "values": {"": 7.0}},
            "net.rpc_ms": {"kind": "histogram", "values": {"method=submit": {"count": 4}}}}
    snaps["dead"] = None
    got = tdist.merge_registry_snapshots(snaps)
    assert got == jdist.merge_registry_snapshots(snaps)
    assert set(got) == {"net.bytes", "serve.requests"}


class _FakeClient:
    peer = "127.0.0.1:7777"

    def call(self, method, payload=None, **kw):
        if method == "metrics_snapshot":
            return {"pid": 7777, "generation": 1, "now_us": 0.0,
                    "snapshot": {"serve.requests": {"kind": "counter",
                                                    "values": {"event=submitted": 9.0}}}}
        raise AssertionError(f"unexpected RPC {method}")


class _Replica:
    name = "replica-07"
    worker_pid = 4141

    def metrics_snapshot(self):
        return {"pid": 4141, "snapshot": {"x": {"kind": "counter", "values": {"": 1.0}}}}


class _DeadReplica:
    name = "replica-09"
    worker_pid = None

    def metrics_snapshot(self):
        raise OSError("connection refused")


def _bundles(pkg, root):
    import importlib

    remote = importlib.import_module(f"{pkg}.fleet.remote")
    router = importlib.import_module(f"{pkg}.fleet.router")
    service = importlib.import_module(f"{pkg}.serve.service")
    flight = tflight if pkg == "dispatches_tpu_torch" else jflight
    facade = remote.RemoteServiceFacade(_FakeClient(), {"pid": 7777, "generation": 1})
    handle = remote.RemoteSolveHandle(facade, {}, 0.0, 1.0, 42, "bucket-x")
    out = []
    for name, fire in (
            ("deadline", lambda: facade._flight_deadline(
                handle, service.ServeResult("TIMEOUT", None, None, 123.0))),
            ("poll", lambda: router.FleetRouter._flight_poll_error(
                _Replica(), RuntimeError("wedged"))),
            ("dead", lambda: router.FleetRouter._flight_poll_error(
                _DeadReplica(), RuntimeError("x")))):
        flight.enable(str(root / name))
        try:
            fire()
        finally:
            flight.enable(None)
        out.append([(b["kind"], b["trigger"]) for b in flight.bundles(str(root / name),
                                                                         full=True)])
    router.FleetRouter._flight_poll_error(_DeadReplica(), RuntimeError("x"))  # disarmed
    return out


def test_flight_bundles_carry_the_replica_snapshot_as_jax(tmp_path):
    got = _bundles("dispatches_tpu_torch", tmp_path / "t")
    want = _bundles("dispatches_tpu", tmp_path / "j")
    assert json.loads(json.dumps(got)) == json.loads(json.dumps(want))
    (deadline,), (poll,), dead = got
    assert deadline[0] == "deadline_miss" and deadline[1]["detail"]["peer"] == "127.0.0.1:7777"
    assert deadline[1]["detail"]["replica_snapshot"]["snapshot"]["serve.requests"]["values"][
        "event=submitted"] == 9.0
    assert poll[0] == "plan_error" and poll[1]["detail"]["worker_pid"] == 4141
    assert "wedged" in poll[1]["detail"]["error"]
    assert poll[1]["detail"]["replica_snapshot"]["pid"] == 4141
    assert dead == []  # the pull failed: no bundle, and nothing raised
