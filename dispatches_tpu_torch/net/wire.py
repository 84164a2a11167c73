"""Length-prefixed framed messages over TCP, versioned (counterpart of
``dispatches_tpu/net/wire.py``, frame for frame: the two packages talk to
each other).

Every frame is::

    +------+---------+------------------+----------------+
    | 4 B  |   1 B   |       4 B        |   length B     |
    | DTNW | version | body length (BE) | JSON body utf8 |
    +------+---------+------------------+----------------+

A reader either gets a whole message or an error — no partial-frame
states escape :func:`recv_msg`.  The magic makes a stray connection
(port scanner, wrong protocol) fail loudly on the first four bytes
instead of mis-parsing a length; the version byte lets a future schema
bump refuse old peers explicitly rather than corrupting them.

Payload encoding rides the bitwise pytree codec from
:mod:`dispatches_tpu_torch.serve.journal` (``encode_tree``/``decode_tree``):
arrays serialize as ``(shape, dtype, base64(bytes))``, so params,
warm starts, and snapshot states cross the wire *bitwise* — the
fingerprint of a decoded request equals the fingerprint the client
computed.  :func:`encode_payload` extends the codec (strict superset;
``__nd__``/``__tuple__`` frames are unchanged) with NamedTuple
tagging: solver results (``LPResult``, soak stub results) are
namedtuples whose *field names* callers read back, so they round-trip
as ``{"__ntuple__": [typename, [fields...], [values...]]}`` and decode
into a dynamically rebuilt namedtuple with identical fields.

A tensor leaf (a result computed on the card) is encoded by the journal
codec after ``.cpu()`` as its numpy bytes, dtype and shape, so it decodes
on the far side as the numpy array the JAX package would have sent.
Stdlib-only (socket/struct/json); numpy and torch enter only through the
journal codec.
"""
from __future__ import annotations

import collections
import json
import socket
import struct
from typing import Dict, Optional, Tuple

from dispatches_tpu_torch.obs import registry as obs_registry
from dispatches_tpu_torch.serve import journal as journal_mod

__all__ = [
    "MAGIC",
    "MAX_FRAME",
    "WIRE_VERSION",
    "WireError",
    "decode_payload",
    "encode_payload",
    "recv_msg",
    "send_msg",
]

MAGIC = b"DTNW"
WIRE_VERSION = 1
_HEADER = struct.Struct(">4sBI")
#: upper bound on one frame — far above any real request payload, low
#: enough that a corrupt length can't trigger a multi-GB allocation
MAX_FRAME = 256 * 1024 * 1024

_bytes = obs_registry.counter(
    "net.bytes", "wire bytes moved (header + body), by direction")
_frames = obs_registry.counter(
    "net.frames", "wire frames moved, by direction")


class WireError(RuntimeError):
    """A frame violated the wire contract (bad magic/version/length,
    or the peer closed mid-frame)."""


# ---------------------------------------------------------------------------
# payload codec: journal pytree codec + namedtuple tagging
# ---------------------------------------------------------------------------

_NTUPLE_CACHE: Dict[Tuple[str, Tuple[str, ...]], type] = {}


def encode_payload(tree):
    """JSON-safe encoding of ``tree``; bitwise-reversible for array
    leaves (journal codec) and field-preserving for namedtuples."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {"__ntuple__": [
            type(tree).__name__,
            list(tree._fields),
            [encode_payload(v) for v in tree],
        ]}
    if isinstance(tree, dict):
        return {str(k): encode_payload(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"__tuple__": [encode_payload(v) for v in tree]}
    if isinstance(tree, list):
        return [encode_payload(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return journal_mod._encode_leaf(tree)


def decode_payload(obj):
    """Inverse of :func:`encode_payload`."""
    if isinstance(obj, dict):
        if "__nd__" in obj:
            return journal_mod.decode_tree(obj)
        if "__ntuple__" in obj:
            typename, fields, values = obj["__ntuple__"]
            key = (str(typename), tuple(str(f) for f in fields))
            cls = _NTUPLE_CACHE.get(key)
            if cls is None:
                cls = collections.namedtuple(key[0], key[1])
                _NTUPLE_CACHE[key] = cls
            return cls(*[decode_payload(v) for v in values])
        if "__tuple__" in obj:
            return tuple(decode_payload(v) for v in obj["__tuple__"])
        return {k: decode_payload(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_payload(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def send_msg(sock: socket.socket, msg: Dict) -> int:
    """Frame and write one JSON message; returns bytes written.

    The caller owns socket exclusivity (one in-flight request per
    connection) and error handling — any ``OSError`` from the kernel
    propagates so the transport layer can tear the connection down."""
    body = json.dumps(msg, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_FRAME:
        raise WireError(f"frame body {len(body)} B exceeds MAX_FRAME")
    frame = _HEADER.pack(MAGIC, WIRE_VERSION, len(body)) + body
    sock.sendall(frame)
    _bytes.inc(len(frame), dir="tx")
    _frames.inc(dir="tx")
    return len(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise WireError(
                f"peer closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket) -> Optional[Dict]:
    """Read one whole framed message; ``None`` on a clean EOF at a
    frame boundary (the peer hung up between requests)."""
    try:
        first = sock.recv(1)
    except socket.timeout:
        raise
    if not first:
        return None
    head = first + _recv_exact(sock, _HEADER.size - 1)
    magic, version, length = _HEADER.unpack(head)
    if magic != MAGIC:
        raise WireError(f"bad frame magic {magic!r}")
    if version != WIRE_VERSION:
        raise WireError(
            f"wire version {version} != {WIRE_VERSION} (peer too "
            "old/new; refuse rather than mis-parse)")
    if length > MAX_FRAME:
        raise WireError(f"frame length {length} exceeds MAX_FRAME")
    body = _recv_exact(sock, length) if length else b""
    _bytes.inc(_HEADER.size + length, dir="rx")
    _frames.inc(dir="rx")
    try:
        return json.loads(body.decode("utf-8"))
    except ValueError as exc:
        raise WireError(f"undecodable frame body: {exc}") from None
