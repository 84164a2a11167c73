"""Request/response RPC over :mod:`dispatches_tpu_torch.net.wire` frames
(counterpart of ``dispatches_tpu/net/rpc.py``; a port client talks to a
JAX server and the other way round).

One in-flight request per connection (strict request → response), with
a client-side connection *pool* so concurrent callers get concurrent
sockets instead of serializing on one — the pool lock is held only for
the list pop/append; every byte of socket I/O runs outside it (lock
discipline the JAX package's graftlint pins as GL009).

**Deadlines** are per call and client-enforced: the remaining budget
becomes the socket timeout of each dial/read, and a call that runs out
raises :class:`RpcDeadline`.  **Retries** cover transport faults only
(dial/send/recv failures, torn frames) with capped-exponential backoff;
an application error raised by the remote handler is NOT retried — the
transport worked, the answer was "no".  Retried requests carry a
client-unique ``rid`` so a handler that already executed a request
whose response was lost can deduplicate instead of double-executing
(the worker's submit handler does; see :mod:`net.worker`).

**Fault sites** (the scenario grammar of :mod:`dispatches_tpu_torch.faults`):

* ``net.connect`` — the dial fails (label = ``host:port``, so
  ``match`` partitions a peer away);
* ``net.send`` / ``net.recv`` — the write/read fails and the
  connection is torn down (label = ``peer/method``); a ``hang_s`` rule
  at these sites models *delay via clock skew* — the seconds are
  charged against the call's deadline budget without sleeping, so a
  delay scenario deterministically drives deadline expiry.

All injected faults the retry loop absorbs are reported via
:func:`faults.note_recovered`, keeping ``fault_recovery_rate == 1.0``
when containment held.

Instrumented: ``net.rpc.calls{method,outcome}``, ``net.retries``,
``net.connects`` (fresh dials — reconnect churn), client-side
``net.rpc_ms`` and server-side ``net.rpc.server_ms`` latency
histograms (their difference is the measured wire overhead), and
retroactive ``net.rpc`` trace spans (:func:`obs.trace.complete`) when
tracing is armed.  When :mod:`obs.distributed` is armed
(``DISPATCHES_TPU_NET_TRACE``) the client additionally attaches a
compact trace context to every frame and the server re-hydrates it
around the handler — disarmed, both sides pay one cached-boolean
branch.
"""
from __future__ import annotations

import itertools
import os
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from dispatches_tpu_torch.analysis.flags import flag_name
from dispatches_tpu_torch.analysis.runtime import sanitized_lock
from dispatches_tpu_torch.faults import inject as _faults
from dispatches_tpu_torch.net import wire
from dispatches_tpu_torch.obs import distributed as obs_distributed
from dispatches_tpu_torch.obs import registry as obs_registry
from dispatches_tpu_torch.obs import trace as obs_trace

__all__ = [
    "DEFAULT_BACKOFF_MS",
    "DEFAULT_CONNECT_TIMEOUT_MS",
    "DEFAULT_RETRIES",
    "RpcClient",
    "RpcConnectError",
    "RpcDeadline",
    "RpcError",
    "RpcRemoteError",
    "RpcServer",
]

DEFAULT_CONNECT_TIMEOUT_MS = 500.0
DEFAULT_RETRIES = 2
DEFAULT_BACKOFF_MS = 10.0
BACKOFF_CAP_MS = 250.0

_calls = obs_registry.counter(
    "net.rpc.calls", "RPC calls completed by the client "
    "(method=<name>, outcome=ok|remote_error|deadline|exhausted)")
_retries = obs_registry.counter(
    "net.retries", "RPC transport attempts retried after a "
    "dial/send/recv failure (method=<name>)")
_connects = obs_registry.counter(
    "net.connects", "fresh client dials (pool misses + reconnects "
    "after torn connections; peer=<host:port>)")
_latency = obs_registry.histogram(
    "net.rpc_ms", "client-observed RPC round-trip latency in "
    "milliseconds (method=<name>; successful calls only)")
_server_latency = obs_registry.histogram(
    "net.rpc.server_ms", "server-side handler latency in milliseconds "
    "(method=<name>; successful dispatches only) — subtract from the "
    "client's net.rpc_ms to get wire overhead")


class RpcError(RuntimeError):
    """Base transport/protocol error for one RPC call."""


class RpcConnectError(RpcError):
    """The peer could not be dialed (refused, timed out, partitioned)."""


class RpcDeadline(RpcError):
    """The per-call deadline expired before a response landed."""


class RpcRemoteError(RpcError):
    """The remote handler raised; carried back verbatim, never retried."""


def _env_ms(short: str, default: float) -> float:
    raw = os.environ.get(flag_name(short), "")
    return float(raw) if raw else default


def _env_int(short: str, default: int) -> int:
    raw = os.environ.get(flag_name(short), "")
    return int(raw) if raw else default


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------


class RpcServer:
    """Threaded RPC server: one accept loop, one thread per connection.

    ``handlers`` maps method name → ``fn(payload) -> result``; payloads
    and results cross :func:`wire.decode_payload` /
    :func:`wire.encode_payload`, so handlers see real pytrees.  A
    ``ping`` handler is built in (the heartbeat channel).  Handler
    exceptions become ``ok: false`` responses — one bad request never
    takes the connection (or the server) down.
    """

    def __init__(self, handlers: Dict[str, Callable], *,
                 host: str = "127.0.0.1", port: int = 0):
        self._handlers = dict(handlers)
        # the clock sample rides the heartbeat: obs.distributed's
        # midpoint estimator needs a remote now_us on every ping
        self._handlers.setdefault(
            "ping", lambda payload: {"pong": True,
                                     "now_us": obs_trace.now_us()})
        # guards the live-connection set only; socket I/O and handler
        # dispatch run on the per-connection threads outside it
        self._lock = sanitized_lock("net.server")
        self._conns: Dict[int, socket.socket] = {}
        self._conn_seq = itertools.count(1)
        self._running = False
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        self._listener.listen(64)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread: Optional[threading.Thread] = None

    def start(self) -> "RpcServer":
        self._running = True
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="rpc-accept", daemon=True)
        self._accept_thread.start()
        return self

    def _accept_loop(self) -> None:
        while self._running:
            try:
                conn, _addr = self._listener.accept()
            except OSError:
                return  # listener closed: shutdown
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            cid = next(self._conn_seq)
            with self._lock:
                self._conns[cid] = conn
            threading.Thread(
                target=self._serve_connection, args=(cid, conn),
                name=f"rpc-conn-{cid}", daemon=True).start()

    def _serve_connection(self, cid: int, conn: socket.socket) -> None:
        try:
            while self._running:
                try:
                    msg = wire.recv_msg(conn)
                except (wire.WireError, OSError):
                    return  # torn frame / reset: drop the connection
                if msg is None:
                    return  # clean EOF between requests
                resp = self._dispatch(msg)
                try:
                    wire.send_msg(conn, resp)
                except OSError:
                    return
        finally:
            with self._lock:
                self._conns.pop(cid, None)
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, msg: Dict) -> Dict:
        rid = msg.get("id")
        method = msg.get("m")
        handler = self._handlers.get(method)
        if handler is None:
            return {"id": rid, "ok": False, "kind": "method",
                    "error": f"unknown RPC method {method!r}"}
        tc = msg.get("tc")
        t0 = time.monotonic()
        try:
            payload = wire.decode_payload(msg.get("p"))
            if tc is not None and obs_distributed.enabled():
                result = self._dispatch_traced(method, handler, payload, tc)
            else:
                result = handler(payload)
            _server_latency.observe((time.monotonic() - t0) * 1e3,
                                    method=method)
            return {"id": rid, "ok": True,
                    "p": wire.encode_payload(result)}
        except Exception as exc:  # handler bug → error response, not a
            return {"id": rid, "ok": False, "kind": "app",  # dead conn
                    "error": f"{type(exc).__name__}: {exc}"}

    @staticmethod
    def _dispatch_traced(method: str, handler: Callable, payload, tc: Dict):
        """Run one handler under the caller's re-hydrated trace context
        so spans it emits (and ``distributed.current()`` reads) carry
        the origin-side request identity."""
        with obs_distributed.remote_context(tc) as ctx:
            args: Dict = {"method": method, "origin_pid": ctx.pid}
            if ctx.rid is not None:
                args["request_id"] = ctx.rid
            if ctx.parent is not None:
                args["origin_parent"] = ctx.parent
            with obs_trace.span("net.rpc.serve", **args):
                return handler(payload)

    def stop(self) -> None:
        self._running = False
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            try:
                conn.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------


class RpcClient:
    """Pooled RPC client for one peer, with deadlines and retries."""

    def __init__(self, host: str, port: int, *,
                 connect_timeout_ms: Optional[float] = None,
                 retries: Optional[int] = None,
                 backoff_ms: float = DEFAULT_BACKOFF_MS,
                 max_pool: int = 8):
        self.host = host
        self.port = int(port)
        self.peer = f"{host}:{self.port}"
        self.connect_timeout_ms = (
            _env_ms("NET_CONNECT_TIMEOUT_MS", DEFAULT_CONNECT_TIMEOUT_MS)
            if connect_timeout_ms is None else float(connect_timeout_ms))
        self.retries = (_env_int("NET_RPC_RETRIES", DEFAULT_RETRIES)
                        if retries is None else int(retries))
        self.backoff_ms = float(backoff_ms)
        self.max_pool = int(max_pool)
        # guards the idle-socket pool only: checkout/checkin are list
        # ops; dial/send/recv always run outside the lock
        self._lock = sanitized_lock("net.client")
        self._pool: List[socket.socket] = []
        self._seq = itertools.count(1)
        self._nonce = f"{os.getpid():x}-{id(self) & 0xFFFFFF:x}"
        self._closed = False

    # -- connection pool ---------------------------------------------------

    def _checkout(self, timeout_s: Optional[float]) -> socket.socket:
        with self._lock:
            if self._closed:
                raise RpcConnectError(f"client for {self.peer} is closed")
            sock = self._pool.pop() if self._pool else None
        if sock is not None:
            return sock
        if _faults.armed():
            _faults.check("net.connect", label=self.peer)
        dial = self.connect_timeout_ms / 1e3
        if timeout_s is not None:
            dial = min(dial, max(timeout_s, 1e-3))
        try:
            sock = socket.create_connection((self.host, self.port),
                                            timeout=dial)
        except OSError as exc:
            raise RpcConnectError(
                f"dial {self.peer} failed: {exc}") from exc
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        _connects.inc(peer=self.peer)
        return sock

    def _checkin(self, sock: socket.socket) -> None:
        with self._lock:
            if not self._closed and len(self._pool) < self.max_pool:
                self._pool.append(sock)
                return
        try:
            sock.close()
        except OSError:
            pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            pool, self._pool = self._pool, []
        for sock in pool:
            try:
                sock.close()
            except OSError:
                pass

    # -- the call ----------------------------------------------------------

    def call(self, method: str, payload=None, *,
             deadline_ms: Optional[float] = None,
             retries: Optional[int] = None):
        """One RPC: returns the decoded result or raises ``Rpc*``.

        ``deadline_ms`` bounds the whole call including retries and
        injected delay; ``retries`` overrides the client budget for
        this call (0 = single attempt — heartbeat pings use it so a
        lost beat stays lost, which is what failover detection needs).
        """
        budget = self.retries if retries is None else int(retries)
        t0 = time.monotonic()
        t0_us = obs_trace.now_us()
        rid = f"{self._nonce}-{next(self._seq)}"
        request = {"id": rid, "m": method,
                   "p": wire.encode_payload(payload)}
        # one cached-boolean branch when disarmed (spy-pinned)
        if obs_distributed.enabled():
            request["tc"] = obs_distributed.wire_context()
        penalty_s = 0.0  # injected delay, charged as if time passed
        label = f"{self.peer}/{method}"
        attempt = 0
        last_exc: Optional[BaseException] = None
        while True:
            remaining = self._remaining_s(deadline_ms, t0, penalty_s)
            if remaining is not None and remaining <= 0.0:
                self._finish(method, "deadline", t0, t0_us)
                raise RpcDeadline(
                    f"{method} to {self.peer} ran out of deadline "
                    f"({deadline_ms} ms) after {attempt} attempt(s)"
                ) from last_exc
            sock = None
            try:
                sock = self._checkout(remaining)
                if _faults.armed():
                    penalty_s += _faults.hang_for("net.send", label=label)
                    remaining = self._remaining_s(deadline_ms, t0,
                                                  penalty_s)
                    if remaining is not None and remaining <= 0.0:
                        raise socket.timeout("injected send delay")
                    _faults.check("net.send", label=label)
                sock.settimeout(remaining)
                wire.send_msg(sock, request)
                if _faults.armed():
                    penalty_s += _faults.hang_for("net.recv", label=label)
                    remaining = self._remaining_s(deadline_ms, t0,
                                                  penalty_s)
                    if remaining is not None and remaining <= 0.0:
                        raise socket.timeout("injected recv delay")
                    _faults.check("net.recv", label=label)
                    sock.settimeout(remaining)
                resp = wire.recv_msg(sock)
            except (_faults.InjectedFault, wire.WireError, OSError) as exc:
                # socket.timeout is an OSError: deadline pressure and
                # transport failure share the retry/teardown path
                if sock is not None:
                    try:
                        sock.close()
                    except OSError:
                        pass
                _faults.note_recovered(exc)
                last_exc = exc
                attempt += 1
                if attempt > budget:
                    status = ("deadline" if isinstance(exc, socket.timeout)
                              else "exhausted")
                    self._finish(method, status, t0, t0_us)
                    err = (RpcDeadline if status == "deadline"
                           else RpcConnectError
                           if isinstance(exc, RpcConnectError)
                           else RpcError)
                    raise err(
                        f"{method} to {self.peer} failed after "
                        f"{attempt} attempt(s): {exc}") from exc
                _retries.inc(method=method)
                backoff = min(self.backoff_ms * (2 ** (attempt - 1)),
                              BACKOFF_CAP_MS) / 1e3
                if remaining is not None:
                    backoff = min(backoff, max(remaining, 0.0))
                if backoff > 0.0:
                    time.sleep(backoff)
                continue
            if resp is None:
                # clean EOF where a response belonged: the peer died
                # between our send and its reply — retryable
                try:
                    sock.close()
                except OSError:
                    pass
                last_exc = RpcError(f"{self.peer} closed before replying")
                attempt += 1
                if attempt > budget:
                    self._finish(method, "exhausted", t0, t0_us)
                    raise RpcError(
                        f"{method} to {self.peer}: connection closed "
                        f"before a response, {attempt} attempt(s)")
                _retries.inc(method=method)
                continue
            self._checkin(sock)
            if not resp.get("ok"):
                self._finish(method, "remote_error", t0, t0_us)
                raise RpcRemoteError(
                    f"{method} on {self.peer}: "
                    f"{resp.get('error', 'unknown remote error')}")
            self._finish(method, "ok", t0, t0_us)
            return wire.decode_payload(resp.get("p"))

    @staticmethod
    def _remaining_s(deadline_ms: Optional[float], t0: float,
                     penalty_s: float) -> Optional[float]:
        if deadline_ms is None:
            return None
        return deadline_ms / 1e3 - (time.monotonic() - t0) - penalty_s

    def _finish(self, method: str, status: str, t0: float,
                t0_us: float) -> None:
        _calls.inc(method=method, outcome=status)
        dur_ms = (time.monotonic() - t0) * 1e3
        if status == "ok":
            _latency.observe(dur_ms, method=method)
        if obs_trace.enabled():
            obs_trace.complete("net.rpc", t0_us, dur_ms * 1e3,
                               method=method, peer=self.peer,
                               status=status)

    def ping(self, deadline_ms: Optional[float] = None) -> bool:
        """One heartbeat round-trip; never retried (a lost beat must
        stay lost so the router's silence detection sees it)."""
        if deadline_ms is None:
            deadline_ms = _env_ms("NET_HEARTBEAT_MS", 100.0)
        try:
            self.call("ping", deadline_ms=deadline_ms, retries=0)
            return True
        except RpcError:
            return False
