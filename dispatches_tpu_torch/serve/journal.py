"""Write-ahead request journal: crash durability for the solve service
(counterpart of ``dispatches_tpu/serve/journal.py``; host-side, numpy
only, and the same file format, so a journal written by either package
replays in the other).

Every request the service *accepts* (past shedding and backpressure)
is journaled before the caller's handle can complete: one ``accept``
record carrying the full parameter payload (bitwise, base64 of the
host buffer), the request fingerprint, the relative deadline, and the
options signature — followed by ``status`` records as the request
moves QUEUED → DISPATCHED → terminal.  A service that dies mid-flight
leaves a journal whose non-terminal requests are exactly the ones a
fresh process must resubmit; :func:`replay` reconstructs that set,
tolerating a torn final record (a crash mid-``write`` truncates the
last line, never corrupts earlier ones).  The open set is keyed by
``request_id``: two distinct in-flight requests with bitwise-equal
params are two open requests and both replay.  Resubmit idempotency
rides on the ``orig`` link instead: a recovery's re-accept names the
request id it supersedes, so a journal that already holds a previous
recovery's re-accepts replays each original request exactly once.

Layout and rotation: records are JSON lines appended to numbered
segments (``journal-00001.jsonl`` …).  A segment is rotated after
``segment_records`` records: the old file is flushed, fsynced and
closed before the next is created with ``O_EXCL``, so rotation never
loses or duplicates a record — the only vulnerable byte span is the
tail of the newest segment, which replay treats as torn.  A clean
:meth:`RequestJournal.shutdown` (written by ``SolveService.drain``)
marks the journal so recovery can tell "nothing was lost" from "the
process died".

Journaling is gated on ``DISPATCHES_TPU_SERVE_JOURNAL_DIR`` or an
explicit ``journal_dir=`` constructor argument; disarmed, the service
holds no journal object and its hot paths pay one ``is None`` branch.

The codec round-trips a parameter tree *bitwise*, so the fingerprint of
resubmitted params equals the journaled one: arrays serialize as
``(shape, dtype.str, base64(contiguous bytes))`` and tuples are tagged
to survive JSON.  A tensor leaf is encoded from its CPU copy under the
numpy dtype's code, so it writes the bytes its numpy array would.
"""
from __future__ import annotations

import base64
import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from dispatches_tpu_torch.analysis.flags import flag_name

__all__ = [
    "JournalReplay",
    "RequestJournal",
    "decode_tree",
    "default_dir",
    "enabled",
    "encode_tree",
    "replay",
]

SCHEMA_VERSION = 1
DEFAULT_SEGMENT_RECORDS = 512
_SEGMENT_PREFIX = "journal-"
_SEGMENT_SUFFIX = ".jsonl"

#: statuses that end a request's life — anything else is open at death
TERMINAL_STATUSES = ("DONE", "TIMEOUT", "ERROR", "SHED")


def enabled() -> bool:
    """True when ``DISPATCHES_TPU_SERVE_JOURNAL_DIR`` names a directory."""
    return bool(os.environ.get(flag_name("SERVE_JOURNAL_DIR")))


def default_dir() -> Optional[str]:
    """The env-configured journal directory, or None."""
    return os.environ.get(flag_name("SERVE_JOURNAL_DIR")) or None


# ---------------------------------------------------------------------------
# payload codec: bitwise tree round-trip through JSON
# ---------------------------------------------------------------------------


def _dtype_code(dtype: "np.dtype") -> str:
    """A string :func:`_resolve_dtype` reconstructs exactly: ``dtype.str``,
    except for extension dtypes (ml_dtypes ``bfloat16``) that numpy
    renders as opaque void codes — those go by name."""
    if dtype.kind == "V" and dtype.names is None:
        return dtype.name
    return dtype.str


def _resolve_dtype(code: str) -> "np.dtype":
    """Inverse of :func:`_dtype_code` (ml_dtypes only for the names numpy
    cannot resolve; imported lazily)."""
    try:
        return np.dtype(code)
    except TypeError:
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, code))


def _leaf_array(leaf):
    """``(host array or raw bytes, shape, dtype code)`` of one leaf."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: the raw bytes under ml_dtypes' name
            return t.view(torch.int16).numpy().tobytes(), list(t.shape), "bfloat16"
        leaf = t.numpy()
    arr = np.asarray(leaf)
    if not arr.flags["C_CONTIGUOUS"]:
        # not unconditionally: ascontiguousarray promotes 0-d arrays to (1,)
        arr = np.ascontiguousarray(arr)
    return arr.tobytes(), list(arr.shape), _dtype_code(arr.dtype)


def _encode_leaf(leaf) -> Dict:
    buf, shape, code = _leaf_array(leaf)
    return {"__nd__": [shape, code, base64.b64encode(buf).decode("ascii")]}


def encode_tree(tree):
    """Encode a params tree (dicts/lists/tuples of arrays, tensors and
    scalars) into a JSON-safe structure, bitwise-reversible."""
    if isinstance(tree, dict):
        return {str(k): encode_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return {"__tuple__": [encode_tree(v) for v in tree]}
    if isinstance(tree, list):
        return [encode_tree(v) for v in tree]
    if tree is None or isinstance(tree, (bool, int, float, str)):
        return tree
    return _encode_leaf(tree)


def decode_tree(obj):
    """Inverse of :func:`encode_tree` (leaves come back as numpy arrays)."""
    if isinstance(obj, dict):
        if "__nd__" in obj:
            shape, dtype, b64 = obj["__nd__"]
            buf = base64.b64decode(b64.encode("ascii"))
            return np.frombuffer(buf, dtype=_resolve_dtype(dtype)).reshape(
                tuple(shape)).copy()
        if "__tuple__" in obj:
            return tuple(decode_tree(v) for v in obj["__tuple__"])
        return {k: decode_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [decode_tree(v) for v in obj]
    return obj


def _decode_options(opts):
    """JSON turns tuples into lists, but option values must stay hashable
    (they feed ``freeze_options``): lists come back as tuples."""
    if opts is None:
        return None
    out = {}
    for key, value in opts.items():
        if isinstance(value, list):
            value = tuple(tuple(v) if isinstance(v, list) else v
                          for v in value)
        out[key] = value
    return out


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------


class RequestJournal:
    """Append-only write-ahead journal with atomic segment rotation."""

    def __init__(self, directory: str, *,
                 segment_records: int = DEFAULT_SEGMENT_RECORDS):
        if not directory:
            raise ValueError("RequestJournal needs a directory")
        self.directory = str(directory)
        self.segment_records = max(int(segment_records), 1)
        os.makedirs(self.directory, exist_ok=True)
        self._records_in_segment = 0
        self._fh = None
        self._seg = self._next_segment_index()
        self._open_segment()

    # -- segment plumbing ---------------------------------------------------

    def _next_segment_index(self) -> int:
        top = 0
        for name in os.listdir(self.directory):
            if name.startswith(_SEGMENT_PREFIX) and name.endswith(_SEGMENT_SUFFIX):
                try:
                    top = max(top, int(name[len(_SEGMENT_PREFIX):-len(_SEGMENT_SUFFIX)]))
                except ValueError:
                    continue
        return top + 1

    def _segment_path(self, seg: int) -> str:
        return os.path.join(self.directory, f"{_SEGMENT_PREFIX}{seg:05d}{_SEGMENT_SUFFIX}")

    def _open_segment(self) -> None:
        # O_EXCL: a rotation either fully creates the next segment or
        # fails loudly — no half-rotated state to replay around
        fd = os.open(self._segment_path(self._seg),
                     os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o644)
        self._fh = os.fdopen(fd, "w", encoding="utf-8")
        self._records_in_segment = 0
        self._write({"k": "h", "schema": SCHEMA_VERSION, "seg": self._seg})

    def _rotate(self) -> None:
        self._fh.flush()
        os.fsync(self._fh.fileno())
        self._fh.close()
        self._seg += 1
        self._open_segment()

    def _write(self, rec: Dict) -> None:
        if self._fh is None:
            return
        self._fh.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._fh.flush()
        self._records_in_segment += 1
        if self._records_in_segment >= self.segment_records:
            self._rotate()

    # -- record kinds -------------------------------------------------------

    def accept(self, request_id: int, fingerprint: str, *, solver: str,
               options: Optional[Dict], deadline_ms: Optional[float],
               t: float, params, origin: Optional[int] = None) -> None:
        """Journal an accepted request (status QUEUED) with its full
        payload — written before the request can possibly complete.
        ``origin`` marks a recovery resubmission: the request id this
        accept supersedes (replay closes it)."""
        rec = {
            "k": "a",
            "id": int(request_id),
            "fp": fingerprint,
            "solver": solver,
            "opts": options,
            "deadline_ms": deadline_ms,
            "t": float(t),
            "params": encode_tree(params),
        }
        if origin is not None:
            rec["orig"] = int(origin)
        self._write(rec)

    def status(self, request_ids: Sequence[int], status: str) -> None:
        """Journal a status transition for a batch of requests."""
        self._write({"k": "s", "ids": [int(i) for i in request_ids], "st": str(status)})

    def shutdown(self, clean: bool = True) -> None:
        """Journal the clean-shutdown marker (written by ``drain``)."""
        self._write({"k": "x", "clean": bool(clean)})

    def close(self) -> None:
        if self._fh is not None:
            self._fh.flush()
            os.fsync(self._fh.fileno())
            self._fh.close()
            self._fh = None


# ---------------------------------------------------------------------------
# replay
# ---------------------------------------------------------------------------


class JournalReplay:
    """The reconstructed journal state: what to resubmit, and counts."""

    def __init__(self):
        self.accepted = 0            # accept records seen
        self.torn = 0                # undecodable lines skipped
        self.clean_shutdown = False  # a clean marker was the last word
        #: open requests in accept order (dicts with id/fp/solver/options/
        #: deadline_ms/params, params decoded) ready for resubmission
        self.open_requests: List[Dict] = []
        self.lost = 0                # accepts whose payload failed decode
        #: highest request id any accept carried: a recovering service
        #: seeds its request counter past it, so ids stay unique per
        #: journal directory (the orig-supersede link relies on that)
        self.max_id = 0


def _segments(directory: str) -> List[str]:
    names = [n for n in os.listdir(directory)
             if n.startswith(_SEGMENT_PREFIX) and n.endswith(_SEGMENT_SUFFIX)]
    return [os.path.join(directory, n) for n in sorted(names)]


def replay(directory: str) -> JournalReplay:
    """Reconstruct the set of requests that were QUEUED or DISPATCHED
    when the journal went quiet.

    Torn records (a line that fails to parse) are counted and skipped.
    A request is open when its latest status is non-terminal and no
    later accept names it via ``orig``; two requests with identical
    params but different ids are both open.
    """
    out = JournalReplay()
    if not os.path.isdir(directory):
        return out
    accepts: Dict[int, Dict] = {}    # request id -> its accept record
    order: List[int] = []            # ids in accept order
    status_of: Dict[int, str] = {}   # request id -> latest status
    superseded: set = set()          # ids replaced by a recovery re-accept
    for path in _segments(directory):
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    out.torn += 1
                    continue
                kind = rec.get("k")
                if kind == "a":
                    out.accepted += 1
                    out.clean_shutdown = False
                    rid = int(rec["id"])
                    out.max_id = max(out.max_id, rid)
                    if rid not in accepts:
                        order.append(rid)
                    accepts[rid] = rec
                    status_of[rid] = "QUEUED"
                    orig = rec.get("orig")
                    if orig is not None:
                        superseded.add(int(orig))
                elif kind == "s":
                    for rid in rec.get("ids", ()):
                        status_of[int(rid)] = rec["st"]
                elif kind == "x":
                    out.clean_shutdown = bool(rec.get("clean"))
    if out.clean_shutdown:
        return out
    for rid in order:
        if rid in superseded or status_of.get(rid) in TERMINAL_STATUSES:
            continue
        rec = accepts[rid]
        try:
            params = decode_tree(rec["params"])
        except Exception:
            out.lost += 1
            continue
        out.open_requests.append({
            "id": rid,
            "fp": rec["fp"],
            "solver": rec.get("solver") or "pdlp",
            "options": _decode_options(rec.get("opts")),
            "deadline_ms": rec.get("deadline_ms"),
            "params": params,
        })
    return out
