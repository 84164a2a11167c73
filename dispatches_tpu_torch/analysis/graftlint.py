"""graftlint: an AST pass enforcing the PyTorch/CUDA discipline the port's
performance and dtype contract rest on (counterpart of
``dispatches_tpu/analysis/graftlint.py``).

The rule ids, the ``Finding`` record, the fingerprints, the baseline and
the CLI are the JAX package's.  Rules GL001-GL008 carry the torch meaning
of each JAX rule: what silently costs a device sync, breaks a
``torch.func`` transform, or changes a dtype in this package.

GL001 host-call-in-traced   float()/int()/bool()/np.asarray()/.item()/
                            .tolist()/.cpu()/.numpy() on a value inside a
                            function given to a ``torch.func`` transform
                            (vmap, grad, jacfwd, jacrev, jvp, vjp,
                            hessian, functional_call) or inside an
                            ``autograd.Function``'s forward/backward —
                            under vmap it raises; on the card it costs a
                            sync per call.
GL002 tracer-branch         Python ``if``/``while`` on a value derived
                            from such a function's arguments — data-
                            dependent control flow fails under vmap.
GL003 bad-static-argnums    ``argnums`` that is not a literal int or tuple
                            of ints, or ``in_dims``/``out_dims`` that is
                            not an int/None or a tuple (a list, a float,
                            a string, or a value computed at the top
                            level) — torch.func rejects them at call time.
GL004 hot-loop-array        tensor construction (``torch.tensor``/
                            ``as_tensor``/``zeros``/``ones``/``full``/
                            ``arange``/``empty``/``stack``/``cat``) or a
                            host read (``.cpu()``/``.item()``/
                            ``.tolist()``) inside a per-hour/per-day host
                            loop — a device round trip per hour or day.
GL005 default-float-dtype   a floating tensor built from Python floats or
                            a list (``torch.tensor``/``zeros``/``ones``/
                            ``full``/``empty``/``arange``/``linspace``)
                            with no ``dtype=`` — torch's default float32
                            silently replaces JAX's x64 float64 (the
                            port's rule: every constructor states its
                            dtype).
GL006 unregistered-env-flag ``DISPATCHES_TPU_*`` environment reads not
                            registered in ``analysis.flags``.
GL007 unfenced-timing       a ``time.perf_counter()``/``time.time()``
                            window around a call of a counted program
                            (``CountedProgram``, a plan program, a
                            ``make_*_solver`` result) or a kernel launcher
                            (``halpern_sweep``, ``avg_sweep``) with no
                            ``torch.cuda.synchronize()``, event or stream
                            ``.synchronize()`` or obs ``fence`` inside it
                            — CUDA launches are asynchronous, so the stop
                            timestamp measures the enqueue.
GL008 dispatch-outside-plan placement/dispatch decisions made outside
                            ``dispatches_tpu_torch/plan/``: placement on a
                            card chosen from several (``.to(d)`` or
                            ``device=d`` where ``d`` is taken from a
                            ``Mesh``'s devices, or a ``"cuda:<n>"``
                            literal), or a ``CountedProgram``/
                            ``ProgramCounter``/``torch.compile``/
                            ``torch.cuda.graph`` built inside the thin
                            caller layers (``serve``/``sweep``/
                            ``parallel``), which route batches through
                            ``ExecutionPlan``.

Findings are reported as ``file:line rule-id message`` and fingerprinted
by (relpath, rule, normalized source line) — line-number independent, so
the committed baseline (``graftlint.baseline``) survives unrelated
edits.  ``--check`` fails only on findings NOT in the baseline.

This module is stdlib-only (ast/hashlib/re/pathlib): it lints files as
text, so it reads either package without importing it.
"""

from __future__ import annotations

import ast
import hashlib
import re
from collections import Counter
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set

from dispatches_tpu_torch.analysis.flags import _PREFIX, REGISTERED_FLAGS

RULES: Dict[str, str] = {
    "GL001": "host-call-in-traced",
    "GL002": "tracer-branch",
    "GL003": "bad-static-argnums",
    "GL004": "hot-loop-array",
    "GL005": "default-float-dtype",
    "GL006": "unregistered-env-flag",
    "GL007": "unfenced-timing",
    "GL008": "dispatch-outside-plan",
    # GL009-GL012 are the lock-discipline pass (analysis/lockcheck.py);
    # they share this registry so findings render, fingerprint, and
    # baseline identically to the device-discipline rules above.
    "GL009": "blocking-under-lock",
    "GL010": "reentrant-sink-under-lock",
    "GL011": "lock-order-inversion",
    "GL012": "guarded-field-unguarded-write",
}

DEFAULT_BASELINE = Path(__file__).with_name("graftlint.baseline")


@dataclass(frozen=True)
class Finding:
    path: str  # posix relpath used in fingerprints
    line: int
    col: int
    rule: str
    message: str
    source: str  # stripped source line

    @property
    def fingerprint(self) -> str:
        key = f"{self.path}|{self.rule}|{self.source}"
        return hashlib.sha1(key.encode()).hexdigest()[:12]

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} " \
               f"[{RULES[self.rule]}] {self.message}"


# ---------------------------------------------------------------------------
# AST helpers
# ---------------------------------------------------------------------------

# torch.func transforms: they trace their function-valued argument
# (positional slot 0) through functorch wrappers
_TRANSFORM_ARG_SLOTS = {
    "vmap": (0,), "grad": (0,), "grad_and_value": (0,), "jacfwd": (0,),
    "jacrev": (0,), "jvp": (0,), "vjp": (0,), "hessian": (0,),
    "functional_call": (0,),
}
_TRANSFORM_FUNC_KWARGS = {"func", "fn", "f"}
# ``torch.autograd.grad(outputs, inputs)`` differentiates tensors, not a
# function: a ``grad`` reached through ``autograd`` is not a transform
_NOT_TRANSFORM_ROOTS = {"autograd"}
# an ``autograd.Function`` subclass runs these under the autograd engine
_AUTOGRAD_BASE = "Function"
_AUTOGRAD_METHODS = {"forward", "backward", "jvp", "vjp"}

_HOST_NP_NAMES = {"np", "numpy"}
_HOST_NP_ATTRS = {"asarray", "array", "float64", "float32", "concatenate",
                  "stack", "item"}
_HOST_CASTS = {"float", "int", "bool", "complex"}
_HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
_STATIC_ATTRS = {"shape", "ndim", "size", "dtype", "device", "dim", "numel"}
_STATIC_CALLS = {"len", "isinstance", "hasattr", "callable", "getattr",
                 "range", "enumerate", "sorted", "type"}
# GL004: constructions (root ``torch``) and host reads in hot loops
_TORCH_CONSTRUCTORS = {"tensor", "as_tensor", "zeros", "ones", "full",
                       "arange", "empty", "stack", "cat"}
_HOST_READS = {"cpu", "item", "tolist"}
_HOT_RE = re.compile(r"(^|[^a-z])(hour|hr|day|date)s?([^a-z]|$)")
# GL005: constructors that fall back to torch's default float dtype
_DEFAULT_DTYPE_CTORS = {"tensor", "zeros", "ones", "full", "empty",
                        "arange", "linspace"}
_DTYPE_GUARDS = {"get_default_dtype", "set_default_dtype"}
# GL007: wrappers whose result dispatches asynchronously on the card,
# and the launchers of the hand-written kernels
_PROGRAM_WRAPPERS = {"CountedProgram", "program"}
_SOLVER_BUILDER_RE = re.compile(r"^make_\w*solver$")
_KERNEL_LAUNCHERS = {"halpern_sweep", "avg_sweep"}
_TIMER_ATTRS = {"perf_counter", "perf_counter_ns", "time", "monotonic"}
_FENCE_NAMES = {"synchronize", "fence"}
# GL008: the one package allowed to make placement/dispatch decisions,
# and the thin-caller layers that must route through it
_PLAN_PACKAGE = "dispatches_tpu_torch/plan/"
_DISPATCH_DIRS = ("dispatches_tpu_torch/serve/", "dispatches_tpu_torch/sweep/",
                  "dispatches_tpu_torch/parallel/")
_COUNTER_CTORS = {"CountedProgram", "ProgramCounter"}
_CARD_RE = re.compile(r"^cuda:\d+$")


def _base_name(func: ast.expr) -> Optional[str]:
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return None


def _root_name(expr: ast.expr) -> Optional[str]:
    while isinstance(expr, ast.Attribute):
        expr = expr.value
    return expr.id if isinstance(expr, ast.Name) else None


def _strip_partial(expr: ast.expr) -> ast.expr:
    """functools.partial(f, ...) -> f (for transform-arg detection)."""
    if (isinstance(expr, ast.Call) and _base_name(expr.func) == "partial"
            and expr.args):
        return expr.args[0]
    return expr


def _is_transform(func: ast.expr) -> bool:
    base = _base_name(func)
    if base not in _TRANSFORM_ARG_SLOTS:
        return False
    return not (isinstance(func, ast.Attribute)
                and _base_name(func.value) in _NOT_TRANSFORM_ROOTS)


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _has_static_marker(node: ast.AST) -> bool:
    """Shape/dtype/None/len-style tests are fixed for every call and are
    legitimate Python branches inside a transformed function."""
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _STATIC_ATTRS:
            return True
        if isinstance(n, ast.Call):
            base = _base_name(n.func)
            if base in _STATIC_CALLS:
                return True
        if isinstance(n, ast.Compare) and any(
            isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
            for op in n.ops
        ):
            return True
        if isinstance(n, ast.Constant) and n.value is None:
            return True
    return False


def _source_line(lines: Sequence[str], lineno: int) -> str:
    if 1 <= lineno <= len(lines):
        return lines[lineno - 1].strip()
    return ""


_FUNC_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _shallow_walk(fnode: ast.AST) -> Iterable[ast.AST]:
    """Walk a function body without descending into nested functions
    (nested defs are visited as traced roots of their own)."""
    body = fnode.body if isinstance(fnode.body, list) else [fnode.body]
    stack: List[ast.AST] = list(body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, _FUNC_NODES):
            continue
        stack.extend(ast.iter_child_nodes(node))


def _kw(node: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _has_splat(node: ast.Call) -> bool:
    return any(kw.arg is None for kw in node.keywords)


def _int_const(e: ast.expr) -> bool:
    return (isinstance(e, ast.Constant) and isinstance(e.value, int)
            and not isinstance(e.value, bool))


def _float_const(e: ast.expr) -> bool:
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, (ast.USub, ast.UAdd)):
        e = e.operand
    return isinstance(e, ast.Constant) and isinstance(e.value, float)


def _bool_valued(e: ast.expr) -> bool:
    """A bool literal, comparison or logical expression (a bool fill)."""
    return ((isinstance(e, ast.Constant) and isinstance(e.value, bool))
            or isinstance(e, (ast.Compare, ast.BoolOp))
            or (isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Not)))


def _holds_float(value) -> bool:
    if isinstance(value, (list, tuple)):
        return any(_holds_float(v) for v in value)
    return isinstance(value, float)


_LIST_CALLS = {"list", "tuple", "sorted", "set", "reversed", "fromkeys"}
_LIST_METHODS = {"tolist", "ravel", "flatten"}
_ITER_CALLS = {"zip", "enumerate"}


def _is_device_list(e: ast.expr, device_lists: Set[str]) -> bool:
    """Is ``e`` a mesh's device list: ``m.devices`` (or ``.flat``,
    ``.tolist()``), a copy of one (``list(...)``, ``dict.fromkeys(...)``),
    or a name bound to one?"""
    if isinstance(e, ast.Name):
        return e.id in device_lists
    if isinstance(e, ast.Attribute):
        return e.attr == "devices" or (
            e.attr == "flat" and _is_device_list(e.value, device_lists))
    if isinstance(e, ast.Call):
        base = _base_name(e.func)
        if base in _LIST_CALLS and e.args:
            return _is_device_list(e.args[0], device_lists)
        if base in _LIST_METHODS and isinstance(e.func, ast.Attribute):
            return _is_device_list(e.func.value, device_lists)
    return False


def _iterates_devices(it: ast.expr, device_lists: Set[str]) -> bool:
    """Does a loop over ``it`` visit a mesh's devices, alone or zipped or
    enumerated?"""
    if (isinstance(it, ast.Call) and _base_name(it.func) in _ITER_CALLS):
        return any(_is_device_list(a, device_lists) for a in it.args)
    return _is_device_list(it, device_lists)


def _target_names(t: ast.AST) -> List[str]:
    return [n.id for n in ast.walk(t) if isinstance(n, ast.Name)]


# ---------------------------------------------------------------------------
# pass 1: which function nodes are traced?
# ---------------------------------------------------------------------------


class _TracedRoots(ast.NodeVisitor):
    def __init__(self) -> None:
        self.traced_names: Set[str] = set()
        self.traced_nodes: Set[int] = set()  # ids of Lambda/def nodes
        self.program_names: Set[str] = set()  # names bound to programs
        self.has_dtype_guard = False
        # GL008: names bound to a mesh's device list, and names bound to
        # one entry of it chosen by iteration or a computed index
        self.device_lists: Set[str] = set()
        self.card_names: Set[str] = set()

    def _mark(self, expr: ast.expr) -> None:
        expr = _strip_partial(expr)
        if isinstance(expr, ast.Name):
            self.traced_names.add(expr.id)
        elif isinstance(expr, ast.Lambda):
            self.traced_nodes.add(id(expr))

    def visit_Call(self, node: ast.Call) -> None:
        if _is_transform(node.func):
            for slot in _TRANSFORM_ARG_SLOTS[_base_name(node.func)]:
                if slot < len(node.args):
                    self._mark(node.args[slot])
            for kw in node.keywords:
                if kw.arg in _TRANSFORM_FUNC_KWARGS:
                    self._mark(kw.value)
        self.generic_visit(node)

    def _check_decorators(self, node) -> None:
        for dec in node.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if _is_transform(_strip_partial(target)):
                self.traced_nodes.add(id(node))
            # @partial(torch.func.vmap, ...) — partial's first arg
            if (isinstance(dec, ast.Call)
                    and _base_name(dec.func) == "partial" and dec.args
                    and _is_transform(dec.args[0])):
                self.traced_nodes.add(id(node))

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._check_decorators(node)
        self.generic_visit(node)

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        if any(_base_name(b) == _AUTOGRAD_BASE for b in node.bases):
            for sub in node.body:
                if (isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and sub.name in _AUTOGRAD_METHODS):
                    self.traced_nodes.add(id(sub))
        self.generic_visit(node)

    def _bind_devices(self, targets: Sequence[ast.AST],
                      value: ast.expr) -> None:
        names = [n for t in targets for n in _target_names(t)]
        if (isinstance(value, ast.Subscript)
                and _is_device_list(value.value, self.device_lists)):
            if not isinstance(value.slice, ast.Constant):
                self.card_names.update(names)
        elif _is_device_list(value, self.device_lists):
            self.device_lists.update(names)

    def _bind_loop(self, target: ast.AST, it: ast.expr) -> None:
        if _iterates_devices(it, self.device_lists):
            self.card_names.update(_target_names(target))

    def visit_Assign(self, node: ast.Assign) -> None:
        # solver = CountedProgram(...) / plan.program(...) /
        # make_*_solver(...) bindings (GL007): calls of these names
        # dispatch asynchronously
        if isinstance(node.value, ast.Call):
            base = _base_name(node.value.func)
            if base in _PROGRAM_WRAPPERS or (
                    base is not None and _SOLVER_BUILDER_RE.match(base)):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.program_names.add(t.id)
                    elif isinstance(t, ast.Attribute):
                        self.program_names.add(t.attr)
        self._bind_devices(node.targets, node.value)
        self.generic_visit(node)

    def visit_For(self, node: ast.For) -> None:
        self._bind_loop(node.target, node.iter)
        self.generic_visit(node)

    def visit_comprehension(self, node: ast.comprehension) -> None:
        self._bind_loop(node.target, node.iter)
        self.generic_visit(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if node.attr in _DTYPE_GUARDS:
            self.has_dtype_guard = True
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# pass 2: rule checks
# ---------------------------------------------------------------------------


class _Linter:
    def __init__(self, tree: ast.Module, relpath: str, src: str) -> None:
        self.relpath = relpath
        self.lines = src.splitlines()
        self.findings: List[Finding] = []
        roots = _TracedRoots()
        # twice, so that a device list bound after its first use in
        # source order still taints the loops over it
        roots.visit(tree)
        roots.visit(tree)
        self.roots = roots
        # resolve traced names to every def with that name (any scope)
        for node in ast.walk(tree):
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node.name in roots.traced_names):
                roots.traced_nodes.add(id(node))
        self.tree = tree

    def _emit(self, node: ast.AST, rule: str, message: str) -> None:
        line = getattr(node, "lineno", 0)
        self.findings.append(Finding(
            path=self.relpath, line=line,
            col=getattr(node, "col_offset", 0) + 1,
            rule=rule, message=message,
            source=_source_line(self.lines, line),
        ))

    def run(self) -> List[Finding]:
        self._walk(self.tree, in_traced=False, hot_depth=0)
        # GL007 operates per lexical scope: the module body plus every
        # function body (shallow — nested defs are scopes of their own)
        self._check_gl007_scope(self.tree)
        for node in ast.walk(self.tree):
            if isinstance(node, _FUNC_NODES):
                self._check_gl007_scope(node)
        # dedupe (a node can be reachable twice through traced nesting)
        seen: Set[tuple] = set()
        out = []
        for f in self.findings:
            key = (f.rule, f.line, f.col, f.message)
            if key not in seen:
                seen.add(key)
                out.append(f)
        out.sort(key=lambda f: (f.line, f.col, f.rule))
        return out

    # -- dispatch ------------------------------------------------------

    def _walk(self, node: ast.AST, in_traced: bool, hot_depth: int) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, _FUNC_NODES):
                traced = in_traced or id(child) in self.roots.traced_nodes
                if traced:
                    self._check_traced_function(child)
                # loops don't stay "hot" across a function boundary
                self._walk(child, in_traced=traced, hot_depth=0)
                continue
            if isinstance(child, ast.Call):
                self._check_call(child, in_traced, hot_depth)
            if isinstance(child, (ast.For, ast.While)) and not in_traced:
                hot = hot_depth + (1 if self._is_hot_loop(child) else 0)
                self._walk(child, in_traced, hot)
                continue
            self._walk(child, in_traced, hot_depth)

    # -- GL002 (+GL001 via _check_call during walk) --------------------

    def _check_traced_function(self, fnode: ast.AST) -> None:
        if isinstance(fnode, ast.Lambda):
            params = {a.arg for a in fnode.args.args}
        else:
            args = fnode.args
            params = {a.arg for a in
                      args.posonlyargs + args.args + args.kwonlyargs}
            if args.vararg:
                params.add(args.vararg.arg)
        params.discard("self")
        params.discard("cls")
        params.discard("ctx")  # an autograd.Function's context
        tainted = set(params)
        shallow = list(_shallow_walk(fnode))
        # fixpoint taint propagation through simple assignments
        # (_shallow_walk order is not source order)
        assigns = [n for n in shallow if isinstance(n, ast.Assign)]
        changed = True
        while changed:
            changed = False
            for node in assigns:
                if not (_names_in(node.value) & tainted):
                    continue
                # shape/len/dtype-derived values are fixed per call —
                # branching on them later is legitimate
                if _has_static_marker(node.value):
                    continue
                targets = []
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        targets.append(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        targets.extend(el.id for el in t.elts
                                       if isinstance(el, ast.Name))
                for name in targets:
                    if name not in tainted:
                        tainted.add(name)
                        changed = True
        for node in shallow:
            if isinstance(node, (ast.If, ast.While)):
                hit = _names_in(node.test) & tainted
                if hit and not _has_static_marker(node.test):
                    kind = "while" if isinstance(node, ast.While) else "if"
                    self._emit(
                        node, "GL002",
                        f"Python `{kind}` on `{sorted(hit)[0]}`, which "
                        "derives from a transformed function's argument — "
                        "data-dependent control flow fails under "
                        "torch.func.vmap; use torch.where, or hoist the "
                        "decision out of the transformed function",
                    )

    # -- call-level rules ---------------------------------------------

    def _check_call(self, node: ast.Call, in_traced: bool,
                    hot_depth: int) -> None:
        base = _base_name(node.func)

        if in_traced:
            self._check_gl001(node, base)
        if hot_depth > 0 and not in_traced:
            self._check_gl004(node, base)
        self._check_gl003(node)
        self._check_gl005(node, base)
        self._check_gl006(node, base)
        self._check_gl008(node, base)

    def _check_gl001(self, node: ast.Call, base: Optional[str]) -> None:
        if (isinstance(node.func, ast.Name) and base in _HOST_CASTS
                and node.args):
            if all(isinstance(a, ast.Constant) for a in node.args):
                return
            if any(_has_static_marker(a) for a in node.args):
                return
            self._emit(
                node, "GL001",
                f"host `{base}()` on a non-constant value inside a "
                "transformed function — raises under vmap and syncs "
                "the card per call; keep it a tensor (or hoist to the "
                "host caller)",
            )
            return
        if isinstance(node.func, ast.Attribute):
            root = _root_name(node.func)
            if root in _HOST_NP_NAMES and node.func.attr in _HOST_NP_ATTRS:
                self._emit(
                    node, "GL001",
                    f"`{root}.{node.func.attr}()` inside a transformed "
                    "function — numpy pulls the value to the host; use "
                    "the torch equivalent",
                )
            elif node.func.attr in _HOST_METHODS and not node.args:
                self._emit(
                    node, "GL001",
                    f"`.{node.func.attr}()` inside a transformed "
                    "function — host materialization of a traced value",
                )

    def _check_gl007_scope(self, scope: ast.AST) -> None:
        """Un-fenced host timing around an asynchronous launch.

        Within one lexical scope: two or more ``time.perf_counter()`` /
        ``time.time()`` reads define a timing window; a call of a name
        bound to a counted program, a plan program or a ``make_*_solver``
        result, or of a kernel launcher, inside that window with no
        ``synchronize`` (or obs-span ``fence``) in the window measures
        the enqueue, not the computation.
        """
        timers: List[int] = []
        fences: List[int] = []
        launches: List[ast.Call] = []
        for node in _shallow_walk(scope):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if (isinstance(f, ast.Attribute) and _root_name(f) == "time"
                    and f.attr in _TIMER_ATTRS):
                timers.append(node.lineno)
            elif isinstance(f, ast.Name) and f.id in _TIMER_ATTRS:
                timers.append(node.lineno)
            base = _base_name(f)
            if base in _FENCE_NAMES:
                fences.append(node.lineno)
            elif (base in self.roots.program_names
                  or base in _KERNEL_LAUNCHERS):
                launches.append(node)
        if len(timers) < 2:
            return
        lo, hi = min(timers), max(timers)
        if any(lo <= ln <= hi for ln in fences):
            return
        for call in launches:
            if lo <= call.lineno <= hi:
                self._emit(
                    call, "GL007",
                    f"`{_base_name(call.func)}()` (an asynchronous launch) "
                    "inside a host timing window with no "
                    "torch.cuda.synchronize() — CUDA launches return "
                    "before the device finishes, so the timer measures "
                    "the enqueue, not the solve; synchronize (or fence "
                    "the obs span) before the stop timestamp",
                )

    def _dims_ok(self, e: ast.expr, top: bool) -> bool:
        """An ``in_dims``/``out_dims`` spec torch.func accepts: an int or
        None, or a tuple whose leaves are ints, None or pytrees of dims
        named by the caller; never a list, float or string at the top,
        and never a float or string anywhere."""
        if isinstance(e, ast.Constant):
            return e.value is None or _int_const(e)
        if isinstance(e, ast.Tuple):
            return all(self._dims_ok(el, False) for el in e.elts)
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Add):
            # tuple concatenation: Python raises unless both sides are
            # tuples, so a named side is a tuple of dims
            return (isinstance(e.left, (ast.Tuple, ast.BinOp))
                    or isinstance(e.right, (ast.Tuple, ast.BinOp))) and (
                self._dims_ok(e.left, False) and self._dims_ok(e.right, False))
        if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Mult):
            return isinstance(e.left, ast.Tuple) and self._dims_ok(e.left, top)
        if top:
            return False
        if isinstance(e, ast.Dict):
            return all(self._dims_ok(v, False) for v in e.values)
        if isinstance(e, ast.List):
            return all(self._dims_ok(v, False) for v in e.elts)
        return isinstance(e, (ast.Name, ast.Attribute, ast.Subscript,
                              ast.DictComp, ast.IfExp))

    def _check_gl003(self, node: ast.Call) -> None:
        if not _is_transform(node.func):
            return
        for kw in node.keywords:
            if kw.arg == "argnums":
                val = kw.value
                elems = val.elts if isinstance(val, ast.Tuple) else [val]
                ok = all(_int_const(e) for e in elems)
                want = "int/tuple-of-int"
            elif kw.arg in ("in_dims", "out_dims"):
                ok = self._dims_ok(kw.value, True)
                want = "int/None/tuple of dims"
            else:
                continue
            if not ok:
                self._emit(
                    node, "GL003",
                    f"`{kw.arg}` must be a literal {want} — torch.func "
                    "rejects a list, a float or a computed value at call "
                    "time",
                )

    def _is_hot_loop(self, node) -> bool:
        if isinstance(node, ast.For):
            text = (ast.unparse(node.target) + " " +
                    ast.unparse(node.iter)).lower()
        else:
            text = ast.unparse(node.test).lower()
        if _HOT_RE.search(text):
            return True
        # range(24) / range(8760): an hours-of-{day,year} sweep
        for n in ast.walk(node.iter if isinstance(node, ast.For) else node.test):
            if (isinstance(n, ast.Call) and _base_name(n.func) == "range"
                    and n.args
                    and isinstance(n.args[-1], ast.Constant)
                    and n.args[-1].value in (24, 8760)):
                return True
        return False

    def _check_gl004(self, node: ast.Call, base: Optional[str]) -> None:
        if not isinstance(node.func, ast.Attribute):
            return
        if (_root_name(node.func) == "torch"
                and node.func.attr in _TORCH_CONSTRUCTORS):
            self._emit(
                node, "GL004",
                f"`torch.{node.func.attr}()` inside a per-hour/per-day "
                "host loop — each call is a host-to-device transfer or a "
                "launch; build the tensor once outside the loop (or vmap "
                "over the axis)",
            )
        elif node.func.attr in _HOST_READS and not node.args:
            self._emit(
                node, "GL004",
                f"`.{node.func.attr}()` inside a per-hour/per-day host "
                "loop — a device-to-host sync per iteration; move the "
                "whole result to the host once, before the loop",
            )

    def _defaults_to_float(self, node: ast.Call, attr: str) -> bool:
        """Would this constructor, with no dtype=, give torch's default
        float dtype?"""
        args = node.args
        if attr in ("zeros", "ones", "empty", "linspace"):
            return True
        if attr == "full":
            fill = args[1] if len(args) > 1 else _kw(node, "fill_value")
            return fill is not None and not (
                _int_const(fill) or _bool_valued(fill))
        if attr == "arange":
            return any(_float_const(a) for a in args)
        # torch.tensor(data): a Python float, or a list/tuple literal
        # holding one (or holding values of unknown type)
        if not args:
            return False
        try:
            value = ast.literal_eval(args[0])
        except (ValueError, TypeError):
            return isinstance(args[0], (ast.List, ast.Tuple, ast.ListComp))
        return _holds_float(value)

    def _check_gl005(self, node: ast.Call, base: Optional[str]) -> None:
        if self.roots.has_dtype_guard:
            return
        if not (isinstance(node.func, ast.Attribute)
                and _root_name(node.func) == "torch"
                and isinstance(node.func.value, ast.Name)
                and base in _DEFAULT_DTYPE_CTORS):
            return
        if _kw(node, "dtype") is not None or _kw(node, "out") is not None \
                or _has_splat(node):
            return
        if self._defaults_to_float(node, base):
            self._emit(
                node, "GL005",
                f"`torch.{base}()` builds a floating tensor with no "
                "dtype= — torch's default float32 silently replaces the "
                "reference's float64; state the dtype",
            )

    def _is_card_choice(self, e: ast.expr) -> bool:
        if isinstance(e, ast.Constant) and isinstance(e.value, str):
            return bool(_CARD_RE.match(e.value))
        if isinstance(e, ast.Name):
            return e.id in self.roots.card_names
        if (isinstance(e, ast.Subscript)
                and _is_device_list(e.value, self.roots.device_lists)):
            return not isinstance(e.slice, ast.Constant)
        return False

    def _check_gl008(self, node: ast.Call, base: Optional[str]) -> None:
        if self.relpath.startswith(_PLAN_PACKAGE):
            return
        # (a) placement on a card chosen from several, anywhere outside
        # the plan package: ``.to(d)``/``device=d`` with ``d`` one entry
        # of a mesh's devices, or a "cuda:<n>" literal (``.to(plan.
        # device)`` commits to the plan's own device and decides nothing)
        dest = _kw(node, "device")
        if dest is None and base == "to" and isinstance(
                node.func, ast.Attribute) and node.args:
            dest = node.args[0]
        if dest is not None and self._is_card_choice(dest):
            self._emit(
                node, "GL008",
                "placement on a card chosen from several outside "
                "dispatches_tpu_torch/plan/ — placement policy lives in "
                "ExecutionPlan.stage(); route the batch through the plan "
                "(or add a justified baseline entry)",
            )
            return
        # (b) building counted programs, compiled graphs or CUDA graphs
        # inside the thin-caller layers — serve/sweep/parallel submit
        # ExecutionPlan programs instead of owning their own
        if not self.relpath.startswith(_DISPATCH_DIRS):
            return
        built = None
        if base in _COUNTER_CTORS:
            built = base
        elif (isinstance(node.func, ast.Attribute)
              and _root_name(node.func) == "torch"):
            if base == "compile" and _base_name(node.func.value) == "torch":
                built = "torch.compile"
            elif (base in ("graph", "CUDAGraph")
                  and _base_name(node.func.value) == "cuda"):
                built = f"torch.cuda.{base}"
        if built is not None:
            self._emit(
                node, "GL008",
                f"`{built}()` inside {self.relpath.split('/')[1]}/ — the "
                "serve/sweep/parallel layers are thin ExecutionPlan "
                "callers; build the program with plan.program() so its "
                "signature count, donation and dispatch-ahead accounting "
                "apply",
            )

    def _flag_value(self, name: str, node: ast.AST) -> None:
        if not name.startswith(_PREFIX):
            return
        short = name[len(_PREFIX):]
        if short not in REGISTERED_FLAGS:
            self._emit(
                node, "GL006",
                f"env flag `{name}` is not registered in "
                "dispatches_tpu_torch.analysis.flags.REGISTERED_FLAGS — "
                "add it there (with a one-line meaning) in the same change",
            )

    def _check_gl006(self, node: ast.Call, base: Optional[str]) -> None:
        is_environ_get = (
            isinstance(node.func, ast.Attribute)
            and node.func.attr == "get"
            and isinstance(node.func.value, ast.Attribute)
            and node.func.value.attr == "environ"
        )
        is_getenv = base == "getenv"
        if (is_environ_get or is_getenv) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(
                node.args[0].value, str):
            self._flag_value(node.args[0].value, node)


class _SubscriptFlags(ast.NodeVisitor):
    """os.environ["DISPATCHES_TPU_X"] and `"..." in os.environ` (GL006
    forms that aren't Call nodes)."""

    def __init__(self, linter: _Linter) -> None:
        self.linter = linter

    def visit_Subscript(self, node: ast.Subscript) -> None:
        if (isinstance(node.value, ast.Attribute)
                and node.value.attr == "environ"
                and isinstance(node.slice, ast.Constant)
                and isinstance(node.slice.value, str)):
            self.linter._flag_value(node.slice.value, node)
        self.generic_visit(node)

    def visit_Compare(self, node: ast.Compare) -> None:
        if (len(node.ops) == 1
                and isinstance(node.ops[0], (ast.In, ast.NotIn))
                and isinstance(node.comparators[0], ast.Attribute)
                and node.comparators[0].attr == "environ"
                and isinstance(node.left, ast.Constant)
                and isinstance(node.left.value, str)):
            self.linter._flag_value(node.left.value, node)
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_source(src: str, relpath: str) -> List[Finding]:
    tree = ast.parse(src, filename=relpath)
    linter = _Linter(tree, relpath, src)
    findings = linter.run()
    sub = _SubscriptFlags(linter)
    linter.findings = []
    sub.visit(tree)
    findings.extend(linter.findings)
    findings.sort(key=lambda f: (f.line, f.col, f.rule))
    return findings


def package_root() -> Path:
    """Directory containing the dispatches_tpu_torch package."""
    return Path(__file__).resolve().parent.parent


def _relpath(path: Path) -> str:
    root = package_root().parent
    try:
        return path.resolve().relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


def lint_file(path: Path) -> List[Finding]:
    src = Path(path).read_text()
    return lint_source(src, _relpath(Path(path)))


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        p = Path(p)
        if p.is_dir():
            out.extend(sorted(p.rglob("*.py")))
        else:
            out.append(p)
    return out


def lint_paths(paths: Sequence[Path]) -> List[Finding]:
    findings: List[Finding] = []
    for f in iter_py_files(paths):
        findings.extend(lint_file(f))
    return findings


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def load_baseline(path: Path = DEFAULT_BASELINE) -> Counter:
    """Multiset of fingerprints the repo has accepted as legacy."""
    fps: Counter = Counter()
    if not Path(path).exists():
        return fps
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        fps[line.split()[0]] += 1
    return fps


def write_baseline(findings: Iterable[Finding],
                   path: Path = DEFAULT_BASELINE) -> int:
    lines = [
        "# graftlint baseline — accepted legacy findings.",
        "# Regenerate with: python -m dispatches_tpu_torch.analysis "
        "--write-baseline",
        "# Only the first token (fingerprint) is compared; the rest is "
        "for humans.",
    ]
    n = 0
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.rule)):
        lines.append(f"{f.fingerprint} {f.rule} {f.path}:{f.line} "
                     f"{f.source[:100]}")
        n += 1
    Path(path).write_text("\n".join(lines) + "\n")
    return n


def new_findings(findings: Sequence[Finding],
                 baseline: Counter) -> List[Finding]:
    """Findings whose fingerprint exceeds its baseline multiplicity."""
    remaining = Counter(baseline)
    out = []
    for f in findings:
        if remaining[f.fingerprint] > 0:
            remaining[f.fingerprint] -= 1
        else:
            out.append(f)
    return out
