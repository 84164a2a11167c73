"""The PyTorch port's wire framing (``dispatches_tpu_torch.net.wire``) held
to the JAX package's ``net.wire``:

- the same messages give the same frame bytes from both packages' ``send_msg``
  over a ``socketpair``, payloads encoded through each package's
  ``encode_payload`` (numpy leaves of every kind, 0-d, empty,
  non-contiguous, bfloat16, tuples, namedtuples, nested dicts);
- each package's ``recv_msg`` decodes the other's frames to the same
  message, and a decoded request's fingerprint equals the client's;
- a CPU tensor leaf encodes to the frame of the numpy array it holds;
- the hardening cases of ``tests/test_net.py``: bad magic, version skew,
  a mid-frame close, an oversize length, a clean EOF at a frame boundary,
  and the codec corners (0-d rank, bfloat16's dtype class, empty shapes,
  non-contiguous input, namedtuple fields).
"""

import json
import socket
from collections import namedtuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.net import wire as jwire  # noqa: E402
from dispatches_tpu.serve.bucket import request_fingerprint as j_fingerprint  # noqa: E402

from dispatches_tpu_torch.net import wire as twire  # noqa: E402
from dispatches_tpu_torch.serve import journal as tjournal  # noqa: E402
from dispatches_tpu_torch.serve.bucket import request_fingerprint as t_fingerprint  # noqa: E402
from torch_isolation import isolated_obs_state  # noqa: E402,F401
from torch_threads import one_torch_thread  # noqa: E402,F401

Res = namedtuple("Res", ["obj", "iters", "x"])


def _messages(seed):
    """Seeded RPC-shaped messages whose payloads cover the codec's cases."""
    rng = np.random.default_rng(seed)
    price = rng.uniform(1.0, 2.0, 8)
    base = np.arange(12, dtype=np.float64).reshape(3, 4) * rng.normal()
    return [
        {"id": f"abc-{seed}", "m": "submit",
         "p": {"rid": "peer/1", "params": {"p": {"price": price}, "fixed": {}},
               "x0": None, "solver": "pdlp", "options": {"tol": 1e-8},
               "deadline_ms": 60000.0, "warm_key": ("k", 3)}},
        {"id": 7, "ok": True,
         "p": {"done": [{"id": 3, "status": "DONE", "obj": float(rng.normal()),
                         "latency_ms": 1.5,
                         "result": Res(np.float64(rng.normal()), np.int32(7),
                                       rng.normal(size=(2, 3)).astype(np.float32))}],
               "queue_depth": 0, "est_service_s": None}},
        {"m": "x", "p": {"zero_d": np.array(3.5), "empty": np.zeros((3, 0), np.int64),
                         "slice": base[:, ::2], "bools": rng.uniform(size=5) > 0.5,
                         "ints": rng.integers(-9, 9, (2, 2)).astype(np.int16),
                         "tuple": (1, "two", np.float32(2.5)), "list": [1, [2, None]]}},
    ]


def _frames(wire_mod, msg):
    a, b = socket.socketpair()
    try:
        n = wire_mod.send_msg(a, {**msg, "p": wire_mod.encode_payload(msg.get("p"))})
        a.close()
        chunks = []
        while True:
            c = b.recv(65536)
            if not c:
                break
            chunks.append(c)
    finally:
        b.close()
    data = b"".join(chunks)
    assert n == len(data)
    return data


def _recv(wire_mod, data):
    a, b = socket.socketpair()
    try:
        a.sendall(data)
        a.close()
        msg = wire_mod.recv_msg(b)
        assert wire_mod.recv_msg(b) is None  # clean EOF at the frame boundary
    finally:
        b.close()
    return msg


def _same(a, b):
    if isinstance(b, np.ndarray):
        assert isinstance(a, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    elif isinstance(b, tuple):
        assert type(a).__name__ == type(b).__name__ and getattr(a, "_fields", None) == \
            getattr(b, "_fields", None) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(b, dict):
        assert list(a) == list(b)
        for k in b:
            _same(a[k], b[k])
    elif isinstance(b, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a == b and type(a) is type(b)


def test_api_matches_jax():
    assert twire.__all__ == jwire.__all__
    assert (twire.MAGIC, twire.WIRE_VERSION, twire.MAX_FRAME) == \
        (jwire.MAGIC, jwire.WIRE_VERSION, jwire.MAX_FRAME)
    assert twire._HEADER.format == jwire._HEADER.format


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_frames_byte_equal_jax_and_cross_decode(seed):
    for msg in _messages(seed):
        t_bytes, j_bytes = _frames(twire, msg), _frames(jwire, msg)
        assert t_bytes == j_bytes
        t_got, j_got = _recv(twire, j_bytes), _recv(jwire, t_bytes)
        assert t_got == j_got == json.loads(t_bytes[9:])
        _same(twire.decode_payload(t_got["p"]), jwire.decode_payload(j_got["p"]))


def test_decoded_request_fingerprint_equals_the_clients():
    params = _messages(4)[0]["p"]["params"]
    got = twire.decode_payload(_recv(twire, _frames(jwire, {"p": params}))["p"])
    assert t_fingerprint(got) == t_fingerprint(params) == j_fingerprint(params)
    back = jwire.decode_payload(_recv(jwire, _frames(twire, {"p": params}))["p"])
    assert j_fingerprint(back) == j_fingerprint(params)


def test_tensor_leaf_frames_as_its_numpy_array():
    x = np.random.default_rng(5).normal(size=(3, 4))
    for arr in (x, x.astype(np.float32), x[:, 1:3], np.array(2.5)):
        t_tree = {"r": Res(torch.as_tensor(arr), torch.tensor(7, dtype=torch.int32), None)}
        n_tree = {"r": Res(arr.copy(order="C"), np.array(7, np.int32), None)}
        assert _frames(twire, {"p": t_tree}) == _frames(jwire, {"p": n_tree})
    bf = torch.tensor([1.5, -2.25, 0.0], dtype=torch.bfloat16)
    got = jwire.decode_payload(_recv(jwire, _frames(twire, {"p": bf}))["p"])
    assert got.dtype.name == "bfloat16" and got.tobytes() == bf.view(torch.int16).numpy().tobytes()


@pytest.mark.parametrize("mod", [twire, jwire], ids=["port", "jax"])
def test_bad_magic_version_midframe_and_oversize_refused(mod):
    cases = [(b"HTTP/1.1 200 OK\r\n\r\n", "magic"),
             (twire.MAGIC + bytes([twire.WIRE_VERSION + 1]) + (2).to_bytes(4, "big") + b"{}",
              "version"),
             (twire.MAGIC + bytes([twire.WIRE_VERSION]) + (100).to_bytes(4, "big") + b"partial",
              "mid-frame"),
             (twire.MAGIC + bytes([twire.WIRE_VERSION]) + (twire.MAX_FRAME + 1).to_bytes(4, "big"),
              "MAX_FRAME")]
    for data, match in cases:
        a, b = socket.socketpair()
        try:
            a.sendall(data)
            a.close()
            with pytest.raises(mod.WireError, match=match):
                mod.recv_msg(b)
        finally:
            b.close()
    a, b = socket.socketpair()
    try:
        twire.send_msg(a, {"m": "x", "p": [1, 2, 3]})
        twire.send_msg(a, {"m": "y"})
        assert jwire.recv_msg(b) == {"m": "x", "p": [1, 2, 3]}
        assert twire.recv_msg(b) == {"m": "y"}
        a.close()
        assert twire.recv_msg(b) is None
    finally:
        b.close()


def _roundtrip(tree):
    return twire.decode_payload(json.loads(json.dumps(twire.encode_payload(tree))))


def test_codec_corners_hold():
    out = _roundtrip({"x": np.array(3.5)})
    assert out["x"].shape == () and out["x"].dtype == np.float64
    ml_dtypes = pytest.importorskip("ml_dtypes")
    arr = np.array([1.5, -2.25, 0.0], dtype=ml_dtypes.bfloat16)
    back = _roundtrip(arr)
    assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()
    scalar = np.array(1.25, dtype=ml_dtypes.bfloat16)
    back = _roundtrip(scalar)
    assert back.shape == () and back.dtype == scalar.dtype and back.tobytes() == scalar.tobytes()
    for empty in (np.zeros((0,), np.float32), np.zeros((3, 0), np.int64)):
        back = _roundtrip(empty)
        assert back.shape == empty.shape and back.dtype == empty.dtype
    sliced = np.arange(12, dtype=np.float64).reshape(3, 4)[:, ::2]
    assert np.array_equal(_roundtrip(sliced), sliced)
    r = _roundtrip({"r": namedtuple("Res", ["obj", "iters"])(np.float64(2.5), np.int32(7))})["r"]
    assert r._fields == ("obj", "iters") and float(r.obj) == 2.5 and int(r.iters) == 7
    tree = {"zero_d": np.array(7), "bf16": np.ones(4, ml_dtypes.bfloat16),
            "empty": np.zeros((0, 2), np.float32), "tup": (np.array(1.0), "label")}
    out = tjournal.decode_tree(json.loads(json.dumps(tjournal.encode_tree(tree))))
    assert out["zero_d"].shape == () and out["bf16"].dtype == tree["bf16"].dtype
    assert out["empty"].shape == (0, 2) and out["tup"][1] == "label"
