"""The PyTorch port's RPC layer (``dispatches_tpu_torch.net.rpc``) held to the
JAX package's ``net.rpc``, in process with stub handlers:

- a port ``RpcClient`` calls a JAX ``RpcServer`` and a JAX client calls a
  port server: results decode to the same trees, the built-in ``ping``
  carries a clock sample, remote handler errors come back verbatim and
  are never retried;
- the fault cases of ``tests/test_net.py`` on the port's client, with the
  port's injector: an injected ``hang_s`` burns the deadline without
  sleeping, a transient ``net.send`` fault is absorbed by a retry (and
  noted recovered), a persistent ``net.connect`` partition exhausts the
  budget; a seeded scenario gives the same outcome sequence twice, and
  the same sequence as the JAX client under JAX's injector;
- the remote facade's early-result stash (a poll delivers a result before
  its submit returns) against a JAX server;
- the client's ``net.rpc_ms`` histogram and ``net.rpc.calls`` counter.
"""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.faults import inject as jfaults  # noqa: E402
from dispatches_tpu.net import rpc as jrpc  # noqa: E402

from dispatches_tpu_torch.faults import inject as tfaults  # noqa: E402
from dispatches_tpu_torch.net import rpc as trpc  # noqa: E402
from dispatches_tpu_torch.obs import registry as treg  # noqa: E402
from torch_isolation import isolated_obs_state  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

#: (client module, server module) pairs: port -> JAX and JAX -> port
PAIRS = [(trpc, jrpc), (jrpc, trpc)]
PAIR_IDS = ["port-client", "jax-client"]


def _server(rpc_mod):
    calls = {"n": 0}

    def echo(payload):
        calls["n"] += 1
        return {"got": payload}

    def boom(payload):
        raise ValueError("handler exploded")

    server = rpc_mod.RpcServer({"echo": echo, "boom": boom}).start()
    server.calls = calls
    return server


@pytest.fixture()
def jax_server():
    server = _server(jrpc)
    yield server
    server.stop()


def test_api_matches_jax():
    assert trpc.__all__ == jrpc.__all__
    for name in ("DEFAULT_BACKOFF_MS", "DEFAULT_CONNECT_TIMEOUT_MS", "DEFAULT_RETRIES",
                 "BACKOFF_CAP_MS"):
        assert getattr(trpc, name) == getattr(jrpc, name), name


@pytest.mark.parametrize("client_mod,server_mod", PAIRS, ids=PAIR_IDS)
def test_roundtrip_ping_and_remote_errors_across_packages(client_mod, server_mod):
    server = _server(server_mod)
    client = client_mod.RpcClient("127.0.0.1", server.port, retries=3)
    try:
        x = np.arange(3, dtype=np.float32)
        out = client.call("echo", {"x": x, "t": (1, "two")})
        assert out["got"]["t"] == (1, "two")
        assert out["got"]["x"].dtype == np.float32 and out["got"]["x"].tobytes() == x.tobytes()
        assert client.ping()
        assert isinstance(client.call("ping")["now_us"], float)
        with pytest.raises(client_mod.RpcRemoteError, match="handler exploded"):
            client.call("boom")
        with pytest.raises(client_mod.RpcRemoteError, match="unknown RPC method"):
            client.call("nope")
        assert server.calls["n"] == 1  # the echo; errors were never retried
    finally:
        client.close()
        server.stop()


def test_injected_delay_burns_deadline_without_sleeping(jax_server):
    client = trpc.RpcClient("127.0.0.1", jax_server.port, retries=0)
    tfaults.arm({"rules": [{"site": "net.recv", "hang_s": 30.0, "p": 1.0, "times": 0}]})
    try:
        t0 = time.monotonic()
        with pytest.raises(trpc.RpcDeadline):
            client.call("echo", {}, deadline_ms=50.0)
        assert time.monotonic() - t0 < 2.0  # virtual, not slept
    finally:
        client.close()


def test_transient_fault_absorbed_and_partition_exhausts(jax_server):
    client = trpc.RpcClient("127.0.0.1", jax_server.port, retries=2, backoff_ms=1.0)
    r0 = tfaults.recovered_total()
    tfaults.arm({"rules": [{"site": "net.send", "p": 1.0}]})  # times=1
    try:
        assert client.call("echo", {"ok": 1})["got"]["ok"] == 1
        assert tfaults.recovered_total() > r0
    finally:
        client.close()
    tfaults.reset()
    peer = f"127.0.0.1:{jax_server.port}"
    client = trpc.RpcClient("127.0.0.1", jax_server.port, retries=1, backoff_ms=1.0)
    tfaults.arm({"rules": [{"site": "net.connect", "p": 1.0, "times": 0, "match": peer}]})
    try:
        with pytest.raises(trpc.RpcError, match="injected fault at net.connect"):
            client.call("echo", {})
    finally:
        client.close()


def _scenario_outcomes(rpc_mod, faults_mod, port):
    faults_mod.reset()
    faults_mod.arm({"rules": [{"site": "net.send", "p": 0.5, "seed": 11, "times": 0}]})
    client = rpc_mod.RpcClient("127.0.0.1", port, retries=0, backoff_ms=1.0)
    outcomes = []
    for i in range(8):
        try:
            client.call("echo", {"i": i})
            outcomes.append("ok")
        except rpc_mod.RpcError:
            outcomes.append("err")
    client.close()
    faults_mod.reset()
    return outcomes


def test_fault_scenario_deterministic_and_equal_jax(jax_server):
    port_server = _server(trpc)
    try:
        first = _scenario_outcomes(trpc, tfaults, jax_server.port)
        second = _scenario_outcomes(trpc, tfaults, port_server.port)
        jax = _scenario_outcomes(jrpc, jfaults, port_server.port)
    finally:
        port_server.stop()
    assert first == second == jax
    assert "err" in first and "ok" in first


def test_early_delivered_result_waits_for_its_submit():
    from dispatches_tpu_torch.fleet.remote import RemoteServiceFacade

    def submit(payload):
        return {"id": 7, "bucket": "b", "queue_depth": 0}

    def poll(payload):
        if 7 in set((payload or {}).get("ack") or []):
            return {"dispatched": 0, "done": []}
        return {"dispatched": 0,
                "done": [{"id": 7, "status": "DONE", "result": {"x": np.float32(3.5)},
                          "obj": 1.25, "latency_ms": 2.0}]}

    server = jrpc.RpcServer({"submit": submit, "poll": poll}).start()
    client = trpc.RpcClient("127.0.0.1", server.port)
    try:
        facade = RemoteServiceFacade(client, {"options": {}})
        facade.poll()  # the result for id 7 lands with no handle yet
        handle = facade.submit(None, {"p": 1.0})
        assert handle.done() and handle.result().status == "DONE"
        assert handle.result().obj == 1.25
        facade.poll()
        assert facade._early == {} and facade._acks == []
    finally:
        client.close()
        server.stop()


def test_client_latency_histogram_and_call_counter(jax_server):
    reg = treg.default_registry()
    calls0 = reg.counter("net.rpc.calls").value(method="echo", outcome="ok")
    client = trpc.RpcClient("127.0.0.1", jax_server.port)
    try:
        for i in range(3):
            client.call("echo", {"i": i})
    finally:
        client.close()
    assert reg.counter("net.rpc.calls").value(method="echo", outcome="ok") == calls0 + 3
    assert reg.snapshot()["net.rpc_ms"]["values"]["method=echo"]["count"] >= 3
