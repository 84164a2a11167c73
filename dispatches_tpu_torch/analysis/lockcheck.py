"""lockcheck: a lock-discipline AST pass over the concurrent layers
(counterpart of ``dispatches_tpu/analysis/lockcheck.py``).

graftlint (GL001-GL008) keeps the *device* discipline honest; this
second pass keeps the *host concurrency* discipline honest.  The serve,
plan, fleet and net layers are genuinely concurrent — an RLock-guarded
dispatch window with out-of-order fencing, concurrent submitters,
fsynced journal writes on the submit path, RPC threads — and every
hard-won rule ("the device wait never runs under the window lock",
"on_done fires outside the lock", "journal accept lands before the
handle is reachable") is one refactor away from silently regressing.
Each rule here encodes one of those invariants:

GL009 blocking-under-lock        a fence/``synchronize``/
                                 ``block_until_ready``/``collect``/
                                 solver dispatch/``fsync``/``sleep``/
                                 ``Event.wait``/zero-arg ``result()``
                                 reachable while a lock is held — every
                                 other thread that touches the lock now
                                 waits on the device (the bug class the
                                 plan's window/fence lock split exists to
                                 prevent).
GL010 reentrant-sink-under-lock  user callbacks (``on_done``), flight
                                 ``trigger``, obs trace emission,
                                 journal writes, or exporter ticks
                                 invoked under a held lock — a sink
                                 that re-enters the locked layer
                                 deadlocks, and even a benign one
                                 stretches the critical section over I/O.
GL011 lock-order-inversion       the global acquisition-order graph
                                 over all owned locks has a cycle —
                                 two threads taking the same pair in
                                 opposite orders deadlock under load.
GL012 guarded-field-unguarded-   an attribute written under its class's
      write                      lock in one method and bare in another
                                 — the guard is either unnecessary or
                                 the bare write is a race.

The model: per class, which ``threading.Lock``/``RLock`` (or
``sanitized_lock``) attributes it owns; per module, module-level locks;
per function, which statements execute under a ``with <lock>:`` — plus
ONE-LEVEL interprocedural call summaries (``self.method()`` and
same-module function calls resolve to what the callee blocks on,
emits, and acquires), so ``with self._lock: self._flush()`` is caught
when ``_flush`` fences.

Reviewed intentional holds are annotated in source, Clang
thread-safety-analysis style, with a trailing ``# lockcheck:
intentional`` comment on the ``with`` line (optionally scoped:
``# lockcheck: intentional(GL009)``); the annotation suppresses
GL009/GL010 for that hold — GL011's order edges still count.  The
users today are the plan's fence lock, which *by design* holds across
the device wait so fencers (never submitters) serialize, and the kernel
library's build lock, held across the one ``nvcc`` build.

The pass is the JAX package's with one more blocking name,
``synchronize`` (torch's counterpart of ``block_until_ready``); the JAX
tree calls nothing of that name, so both passes read it alike.  Findings
reuse graftlint's machinery unchanged: same ``Finding`` dataclass, same
line-independent fingerprints, same baseline file, same ``--check``/
``--selftest`` CLI.  Like graftlint, this module is stdlib-only
(ast/re/pathlib).
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from dispatches_tpu_torch.analysis.graftlint import (
    Finding,
    _base_name,
    _root_name,
    _source_line,
    iter_py_files,
    _relpath,
)

#: rules owned by this pass (graftlint.RULES carries the id -> name map)
LOCKCHECK_RULES = ("GL009", "GL010", "GL011", "GL012")

# call names that block the calling thread on the device, the disk, or
# another thread: reachable under a held lock = every contender waits
_BLOCKING_CALLS = {
    "sleep",              # time.sleep / recovery backoff
    "block_until_ready",  # the device wait
    "synchronize",        # torch.cuda / event / stream device wait
    "_fence",             # plan's bounded device wait
    "collect",            # plan.collect fences until a ticket retires
    "drain",              # plan.drain fences the whole window
    "fsync",              # journal segment rotation
    "wait",               # Event.wait / ticket._event.wait
    "join",               # thread join
    "_run",               # solver dispatch (PlanProgram._run)
}
# zero-arg ``.result()`` is a future-style blocking getter; with
# arguments it is a constructor/recorder and stays exempt
_BLOCKING_ZERO_ARG_ATTRS = {"result"}

# sinks that fan out to user code or re-enter the observability /
# durability layers: invoking one under a lock risks reentrancy
# (deadlock on an RLock-less path) and stretches the hold over I/O
_REENTRANT_SINKS = {
    "trigger",       # obs_flight.trigger: snapshot diff + bundle write
    "maybe_export",  # exporter tick: file I/O on the caller's thread
    "on_done",       # user callback
    "_on_done",      # its ticket-side spelling
    "_complete",     # handle completion releases result() waiters
    "accept",        # journal write-ahead record (flushed write)
}
# obs trace emission under a lock runs every registered sink (the
# TimelineAccumulator subscription path) inside the critical section
_TRACE_EMITTERS = {"complete", "instant"}
_TRACE_ROOTS = {"trace", "obs_trace"}

_PRAGMA_RE = re.compile(r"#\s*lockcheck:\s*intentional(?:\(([^)]*)\))?")
_LOCK_FACTORY_ATTRS = {"Lock", "RLock"}
_SANITIZED_FACTORY = "sanitized_lock"

_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef)


def _lock_ctor_reentrant(value: ast.expr) -> Optional[bool]:
    """Is ``value`` a lock construction?  Returns reentrancy, or None.

    Recognizes ``threading.Lock()`` / ``threading.RLock()`` (and bare
    ``Lock()``/``RLock()`` imports) plus the runtime sanitizer factory
    ``sanitized_lock(name, reentrant=...)``.
    """
    if not isinstance(value, ast.Call):
        return None
    base = _base_name(value.func)
    if base in _LOCK_FACTORY_ATTRS:
        return base == "RLock"
    if base == _SANITIZED_FACTORY:
        for kw in value.keywords:
            if kw.arg == "reentrant" and isinstance(kw.value, ast.Constant):
                return bool(kw.value.value)
        return True  # the factory defaults to reentrant
    return None


@dataclass(frozen=True)
class LockInfo:
    key: str        # graph node: "Class.attr" or "path:name"
    reentrant: bool


@dataclass
class _FuncSummary:
    """One-level call summary: what a function blocks on, which sinks
    it fires, and which locks it acquires — consulted when the function
    is CALLED while the caller holds a lock."""

    blocking: List[str] = field(default_factory=list)
    sinks: List[str] = field(default_factory=list)
    acquires: List[str] = field(default_factory=list)  # lock keys


@dataclass
class _FileModel:
    relpath: str
    lines: List[str]
    #: class name -> {attr -> LockInfo}
    class_locks: Dict[str, Dict[str, LockInfo]] = field(default_factory=dict)
    #: module-level lock name -> LockInfo
    module_locks: Dict[str, LockInfo] = field(default_factory=dict)
    #: (class name or None, function name) -> summary
    summaries: Dict[Tuple[Optional[str], str], _FuncSummary] = field(
        default_factory=dict)
    #: line -> set of rule ids suppressed there (empty set = all)
    pragmas: Dict[int, Set[str]] = field(default_factory=dict)
    #: module-level ``from X import name [as alias]``: alias -> (X, name)
    imports: Dict[str, Tuple[str, str]] = field(default_factory=dict)

    def attr_owner(self, attr: str,
                   prefer: Optional[str] = None) -> Optional[LockInfo]:
        """Resolve a lock attribute: the preferred (enclosing) class
        first, else the unique owner across the file's classes (so
        ``with c._lock:`` on a sibling instance still resolves); an
        ambiguous attr stays unresolved — conservative, never guessed.
        """
        if prefer is not None:
            info = self.class_locks.get(prefer, {}).get(attr)
            if info is not None:
                return info
        owners = [locks[attr] for locks in self.class_locks.values()
                  if attr in locks]
        if len(owners) == 1:
            return owners[0]
        return None

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.pragmas.get(line)
        return rules is not None and (not rules or rule in rules)


#: an acquisition-order edge with the site that created it
@dataclass(frozen=True)
class _Edge:
    src: str
    dst: str
    path: str
    line: int
    col: int
    source: str


# ---------------------------------------------------------------------------
# pass 1: lock model + call summaries
# ---------------------------------------------------------------------------


def _build_model(tree: ast.Module, relpath: str, src: str) -> _FileModel:
    model = _FileModel(relpath=relpath, lines=src.splitlines())
    for lineno, line in enumerate(model.lines, start=1):
        m = _PRAGMA_RE.search(line)
        if m:
            rules = set()
            if m.group(1):
                rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            model.pragmas[lineno] = rules

    # module-level locks (direct assignments in the module body), plus
    # the imports a later linking pass may resolve to other modules'
    # locks (``from plan.execution import _pool_lock``)
    for node in tree.body:
        if isinstance(node, ast.Assign):
            reent = _lock_ctor_reentrant(node.value)
            if reent is None:
                continue
            for t in node.targets:
                if isinstance(t, ast.Name):
                    model.module_locks[t.id] = LockInfo(
                        key=f"{relpath}:{t.id}", reentrant=reent)
        elif isinstance(node, ast.ImportFrom) and node.module:
            for alias in node.names:
                model.imports[alias.asname or alias.name] = (
                    node.module, alias.name)

    # class-owned locks: any ``self.attr = <lock ctor>`` in any method
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        locks: Dict[str, LockInfo] = {}
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Assign):
                continue
            reent = _lock_ctor_reentrant(sub.value)
            if reent is None:
                continue
            for t in sub.targets:
                if (isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"):
                    locks[t.attr] = LockInfo(
                        key=f"{node.name}.{t.attr}", reentrant=reent)
        if locks:
            model.class_locks[node.name] = locks

    return model


def _build_summaries(tree: ast.Module, model: _FileModel) -> None:
    """One-level summaries for module functions and direct class
    methods.  Runs AFTER lock-model linking (imported module locks must
    already be resolvable for a summary's ``acquires`` to name them)."""
    for node in tree.body:
        if isinstance(node, _FUNC_NODES):
            model.summaries[(None, node.name)] = _summarize(node, None, model)
        elif isinstance(node, ast.ClassDef):
            for sub in node.body:
                if isinstance(sub, _FUNC_NODES):
                    model.summaries[(node.name, sub.name)] = _summarize(
                        sub, node.name, model)


def _link_imported_locks(models: Sequence[_FileModel]) -> None:
    """Resolve ``from X import lock_name`` against the scanned set:
    when X names exactly one scanned module that owns ``lock_name`` as
    a module-level lock, the importer shares the SAME lock node — this
    is what lets the global order graph see an inversion whose two
    halves live in different files."""
    for model in models:
        for local, (module, orig) in model.imports.items():
            if local in model.module_locks:
                continue
            suffix = module.replace(".", "/") + ".py"
            owners = [
                m for m in models
                if m is not model
                and (m.relpath == suffix
                     or m.relpath.endswith("/" + suffix))
                and orig in m.module_locks
            ]
            if len(owners) == 1:
                model.module_locks[local] = owners[0].module_locks[orig]


def _shallow_body(fnode: ast.AST) -> Iterable[ast.AST]:
    """All nodes of a function body, excluding nested function defs
    (a nested def runs when *called*, not where it is defined)."""
    stack: List[ast.AST] = list(fnode.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _is_blocking_call(node: ast.Call) -> Optional[str]:
    base = _base_name(node.func)
    if base in _BLOCKING_CALLS:
        return base
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _BLOCKING_ZERO_ARG_ATTRS
            and not node.args and not node.keywords):
        return node.func.attr
    return None


def _is_sink_call(node: ast.Call) -> Optional[str]:
    base = _base_name(node.func)
    if base in _REENTRANT_SINKS:
        return base
    if (isinstance(node.func, ast.Attribute)
            and node.func.attr in _TRACE_EMITTERS
            and _root_name(node.func) in _TRACE_ROOTS):
        return f"{_root_name(node.func)}.{node.func.attr}"
    return None


def _resolve_lock(expr: ast.expr, class_name: Optional[str],
                  model: _FileModel) -> Optional[LockInfo]:
    """Map a ``with`` context expression to a known lock, or None."""
    if isinstance(expr, ast.Name):
        return model.module_locks.get(expr.id)
    if isinstance(expr, ast.Attribute):
        if isinstance(expr.value, ast.Name) and expr.value.id == "self":
            return model.attr_owner(expr.attr, prefer=class_name)
        return model.attr_owner(expr.attr)
    return None


def _summarize(fnode: ast.AST, class_name: Optional[str],
               model: _FileModel) -> _FuncSummary:
    s = _FuncSummary()
    for node in _shallow_body(fnode):
        if isinstance(node, ast.Call):
            b = _is_blocking_call(node)
            if b is not None:
                s.blocking.append(b)
            k = _is_sink_call(node)
            if k is not None:
                s.sinks.append(k)
        elif isinstance(node, ast.With):
            for item in node.items:
                info = _resolve_lock(item.context_expr, class_name, model)
                if info is not None:
                    s.acquires.append(info.key)
    return s


# ---------------------------------------------------------------------------
# pass 2: per-function checks
# ---------------------------------------------------------------------------


@dataclass
class _Held:
    info: LockInfo
    with_line: int  # pragma anchor


class _FileChecker:
    def __init__(self, model: _FileModel) -> None:
        self.model = model
        self.findings: List[Finding] = []
        self.edges: List[_Edge] = []
        #: (class, attr) -> {"guarded": [...nodes], "bare": [...nodes]}
        self.writes: Dict[Tuple[str, str], Dict[str, List[ast.AST]]] = {}

    # -- plumbing ------------------------------------------------------

    def _emit(self, node: ast.AST, rule: str, message: str,
              held: Sequence[_Held] = ()) -> None:
        if rule in ("GL009", "GL010") and any(
                self.model.suppressed(h.with_line, rule) for h in held):
            return
        line = getattr(node, "lineno", 0)
        self.findings.append(Finding(
            path=self.model.relpath, line=line,
            col=getattr(node, "col_offset", 0) + 1,
            rule=rule, message=message,
            source=_source_line(self.model.lines, line),
        ))

    def _edge(self, src: LockInfo, dst: LockInfo, node: ast.AST) -> None:
        line = getattr(node, "lineno", 0)
        self.edges.append(_Edge(
            src=src.key, dst=dst.key, path=self.model.relpath,
            line=line, col=getattr(node, "col_offset", 0) + 1,
            source=_source_line(self.model.lines, line)))

    # -- traversal -----------------------------------------------------

    def check_tree(self, tree: ast.Module) -> None:
        self._check_scope(tree.body, None, None)
        for node in tree.body:
            if isinstance(node, _FUNC_NODES):
                self._check_function(node, None)
            elif isinstance(node, ast.ClassDef):
                for sub in ast.walk(node):
                    if isinstance(sub, _FUNC_NODES):
                        self._check_function(sub, node.name)
        self._check_gl012()

    def _check_function(self, fnode: ast.AST,
                        class_name: Optional[str]) -> None:
        self._check_scope(fnode.body, class_name,
                          fnode.name if isinstance(fnode, _FUNC_NODES)
                          else None)

    def _check_scope(self, body: Sequence[ast.stmt],
                     class_name: Optional[str],
                     func_name: Optional[str],
                     held: Optional[List[_Held]] = None) -> None:
        held = held if held is not None else []
        for stmt in body:
            self._walk(stmt, class_name, func_name, held)

    def _walk(self, node: ast.AST, class_name: Optional[str],
              func_name: Optional[str], held: List[_Held]) -> None:
        if isinstance(node, _FUNC_NODES + (ast.Lambda,)):
            return  # nested defs are checked as their own roots
        if isinstance(node, ast.With):
            acquired: List[_Held] = []
            for item in node.items:
                info = _resolve_lock(item.context_expr, class_name,
                                     self.model)
                if info is None:
                    continue
                for h in held:
                    if h.info.key == info.key:
                        if not info.reentrant:
                            self._emit(
                                node, "GL011",
                                f"non-reentrant lock `{info.key}` "
                                "re-acquired while already held — "
                                "self-deadlock",
                            )
                        break
                else:
                    for h in held:
                        self._edge(h.info, info, node)
                acquired.append(_Held(info=info, with_line=node.lineno))
            held.extend(acquired)
            for sub in node.body:
                self._walk(sub, class_name, func_name, held)
            del held[len(held) - len(acquired):]
            # the with items themselves (context expressions) need no
            # further scanning for our rules
            return
        if held and isinstance(node, ast.Call):
            self._check_call_under_lock(node, class_name, held)
        if class_name is not None and func_name not in ("__init__",
                                                        "__new__"):
            self._record_write(node, class_name, held)
        for child in ast.iter_child_nodes(node):
            self._walk(child, class_name, func_name, held)

    # -- GL009 / GL010 (direct + one-level) ----------------------------

    def _check_call_under_lock(self, node: ast.Call,
                               class_name: Optional[str],
                               held: List[_Held]) -> None:
        lock = held[-1].info.key
        b = _is_blocking_call(node)
        if b is not None:
            self._emit(
                node, "GL009",
                f"`{b}()` blocks while `{lock}` is held — every thread "
                "contending on the lock now waits on the device/disk; "
                "move the blocking wait outside the critical section",
                held=held,
            )
        k = _is_sink_call(node)
        if k is not None:
            self._emit(
                node, "GL010",
                f"`{k}()` invoked while `{lock}` is held — callbacks "
                "and telemetry sinks can re-enter the locked layer "
                "(deadlock) and stretch the hold over I/O; snapshot "
                "under the lock, fan out after releasing it",
                held=held,
            )
        summary = self._callee_summary(node, class_name)
        if summary is None:
            return
        callee = _base_name(node.func)
        if summary.blocking and b is None:
            self._emit(
                node, "GL009",
                f"`{callee}()` (called while `{lock}` is held) blocks "
                f"via `{summary.blocking[0]}()` — the hold extends over "
                "the callee's device/disk wait",
                held=held,
            )
        if summary.sinks and k is None:
            self._emit(
                node, "GL010",
                f"`{callee}()` (called while `{lock}` is held) fires "
                f"`{summary.sinks[0]}` — a reentrant sink now runs "
                "inside the critical section",
                held=held,
            )
        for key in summary.acquires:
            for h in held:
                if h.info.key == key:
                    break
            else:
                for h in held:
                    self.edges.append(_Edge(
                        src=h.info.key, dst=key,
                        path=self.model.relpath, line=node.lineno,
                        col=node.col_offset + 1,
                        source=_source_line(self.model.lines,
                                            node.lineno)))

    def _callee_summary(self, node: ast.Call,
                        class_name: Optional[str]
                        ) -> Optional[_FuncSummary]:
        """ONE level of interprocedural resolution: ``self.m()`` to the
        enclosing class's method, bare ``f()`` to a module function."""
        f = node.func
        if (isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                and f.value.id == "self" and class_name is not None):
            return self.model.summaries.get((class_name, f.attr))
        if isinstance(f, ast.Name):
            return self.model.summaries.get((None, f.id))
        return None

    # -- GL012 ---------------------------------------------------------

    def _record_write(self, node: ast.AST, class_name: str,
                      held: List[_Held]) -> None:
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            targets = [node.target]
        else:
            return
        own_locks = self.model.class_locks.get(class_name, {})
        if not own_locks:
            return
        guarded = any(h.info.key.startswith(f"{class_name}.")
                      for h in held)
        for t in targets:
            if not (isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"):
                continue
            if t.attr in own_locks:
                continue  # the lock attribute itself
            rec = self.writes.setdefault(
                (class_name, t.attr), {"guarded": [], "bare": []})
            rec["guarded" if guarded else "bare"].append(node)

    def _check_gl012(self) -> None:
        for (class_name, attr), rec in sorted(self.writes.items()):
            if not rec["guarded"] or not rec["bare"]:
                continue
            for node in rec["bare"]:
                if self.model.suppressed(getattr(node, "lineno", 0),
                                         "GL012"):
                    continue
                self.findings.append(Finding(
                    path=self.model.relpath,
                    line=getattr(node, "lineno", 0),
                    col=getattr(node, "col_offset", 0) + 1,
                    rule="GL012",
                    message=(
                        f"`self.{attr}` is written under "
                        f"`{class_name}`'s lock elsewhere but bare "
                        "here — either the guard is load-bearing (this "
                        "write races) or it isn't (drop it); pick one"),
                    source=_source_line(
                        self.model.lines, getattr(node, "lineno", 0)),
                ))


# ---------------------------------------------------------------------------
# GL011: global acquisition-order graph
# ---------------------------------------------------------------------------


def _cycle_findings(edges: Sequence[_Edge]) -> List[Finding]:
    """A finding for every acquisition edge that participates in a
    cycle (its destination can reach back to its source), reported at
    the edge's acquisition site so both halves of an inversion show."""
    adj: Dict[str, Set[str]] = {}
    for e in edges:
        adj.setdefault(e.src, set()).add(e.dst)

    def reaches(start: str, goal: str) -> bool:
        seen: Set[str] = set()
        stack = [start]
        while stack:
            node = stack.pop()
            if node == goal:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(adj.get(node, ()))
        return False

    out: List[Finding] = []
    seen_sites: Set[Tuple[str, int, str, str]] = set()
    for e in edges:
        if not reaches(e.dst, e.src):
            continue
        site = (e.path, e.line, e.src, e.dst)
        if site in seen_sites:
            continue
        seen_sites.add(site)
        out.append(Finding(
            path=e.path, line=e.line, col=e.col, rule="GL011",
            message=(
                f"acquisition order `{e.src}` -> `{e.dst}` closes a "
                "cycle in the global lock-order graph — two threads "
                "taking the pair in opposite orders deadlock; pick one "
                "order and hold to it everywhere"),
            source=e.source,
        ))
    return out


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def _run_checker(tree: ast.Module, model: _FileModel) -> _FileChecker:
    checker = _FileChecker(model)
    checker.check_tree(tree)
    return checker


def check_source(src: str, relpath: str) -> List[Finding]:
    """Single-source mode (selftest corpus): all four rules, with the
    GL011 graph local to this source."""
    tree = ast.parse(src, filename=relpath)
    model = _build_model(tree, relpath, src)
    _build_summaries(tree, model)
    checker = _run_checker(tree, model)
    findings = checker.findings
    findings.extend(_cycle_findings(checker.edges))
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def check_paths(paths: Sequence[Path]) -> List[Finding]:
    """Package mode: per-file GL009/GL010/GL012 plus ONE acquisition-
    order graph spanning every file (a lock pair inverted across two
    modules — each half order-consistent in isolation — is exactly the
    cycle a per-file view cannot see)."""
    entries: List[Tuple[ast.Module, _FileModel]] = []
    for path in iter_py_files(paths):
        src = Path(path).read_text()
        relpath = _relpath(Path(path))
        try:
            tree = ast.parse(src, filename=relpath)
        except SyntaxError:
            continue  # graftlint's parse will report it, if asked
        entries.append((tree, _build_model(tree, relpath, src)))
    _link_imported_locks([m for _, m in entries])
    findings: List[Finding] = []
    edges: List[_Edge] = []
    for tree, model in entries:
        _build_summaries(tree, model)
        checker = _run_checker(tree, model)
        findings.extend(checker.findings)
        edges.extend(checker.edges)
    findings.extend(_cycle_findings(edges))
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings
