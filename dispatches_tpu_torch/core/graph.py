"""Time-indexed flowsheet graph (counterpart of ``dispatches_tpu/core/
graph.py``).

Every time-indexed quantity is ONE tensor with a leading time axis of
length ``horizon``; constraints are residual callables ``fn(v, p)`` on
torch tensors, evaluated vectorized over that axis, and time coupling is
a shifted-slice equality (:func:`tshift`).  ``Flowsheet.fix`` removes a
variable from the decision vector and injects its value through the
params dict.  Every unit writes its ``report()`` stream table from a
solution dict, as the JAX package's units do, byte for byte.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

Scalar = Union[float, int]

_INF = math.inf


@dataclass
class VarSpec:
    """A decision variable: scalar (shape ``()``), time-indexed (``(T,)``)
    or general array-shaped."""

    name: str
    shape: Tuple[int, ...]
    lb: Union[Scalar, np.ndarray] = -_INF
    ub: Union[Scalar, np.ndarray] = _INF
    init: Union[Scalar, np.ndarray] = 0.0
    fixed: bool = False
    fixed_value: Optional[Union[Scalar, np.ndarray]] = None
    scale: float = 1.0  # typical magnitude; the solver works on x/scale

    def init_array(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.init, dtype=np.float64), self.shape).copy()

    def lb_array(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.lb, dtype=np.float64), self.shape).copy()

    def ub_array(self) -> np.ndarray:
        return np.broadcast_to(np.asarray(self.ub, dtype=np.float64), self.shape).copy()


class Vals:
    """Read-only view of variable/parameter tensors inside residual
    functions: ``v["unit.var"]``, or ``v.scoped("unit")["var"]``."""

    __slots__ = ("_d",)

    def __init__(self, d: Dict[str, torch.Tensor]):
        self._d = d

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._d[name]

    def __contains__(self, name: str) -> bool:
        return name in self._d

    def get(self, name: str, default=None):
        return self._d.get(name, default)

    def scoped(self, prefix: str) -> "ScopedVals":
        return ScopedVals(self._d, prefix)


class ScopedVals:
    __slots__ = ("_d", "_p")

    def __init__(self, d: Dict[str, torch.Tensor], prefix: str):
        self._d = d
        self._p = prefix

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._d[f"{self._p}.{name}"]


@dataclass
class Port:
    """A named bundle of variable references: ``keys`` maps stream-member
    names to fully-qualified variable names."""

    name: str
    keys: Dict[str, str] = field(default_factory=dict)

    def add(self, member: str, varname: str) -> None:
        self.keys[member] = varname


@dataclass
class _Constraint:
    name: str
    fn: Callable  # fn(v: Vals, p: Vals) -> Tensor
    kind: str  # "eq" (== 0) or "ineq" (<= 0)
    scale: float = 1.0  # residual multiplier


class Flowsheet:
    """Container for a flowsheet over a fixed horizon of ``horizon``
    periods."""

    def __init__(self, horizon: int = 1, dt_hr: float = 1.0):
        self.horizon = int(horizon)
        self.dt_hr = float(dt_hr)
        self.units: Dict[str, "UnitModel"] = {}
        self.var_specs: Dict[str, VarSpec] = {}
        self.params: Dict[str, np.ndarray] = {}
        self.constraints: List[_Constraint] = []
        # build finalizers: run once at first compile
        self._finalizers: List[Callable] = []

    # ---------------- variables / params ----------------

    def add_var(
        self,
        name: str,
        shape: Union[Tuple[int, ...], str, None] = "time",
        lb: Union[Scalar, np.ndarray] = -_INF,
        ub: Union[Scalar, np.ndarray] = _INF,
        init: Union[Scalar, np.ndarray] = 0.0,
        scale: float = 1.0,
    ) -> str:
        if shape == "time":
            shape = (self.horizon,)
        elif shape is None:
            shape = ()
        if name in self.var_specs:
            raise ValueError(f"duplicate variable {name!r}")
        if scale <= 0:
            raise ValueError("var scale must be positive")
        self.var_specs[name] = VarSpec(name, tuple(shape), lb, ub, init, scale=scale)
        return name

    def set_scale(self, name: str, scale: float) -> None:
        if scale <= 0:
            raise ValueError("var scale must be positive")
        self.var_specs[name].scale = scale

    def add_param(self, name: str, value) -> str:
        self.params[name] = np.asarray(value, dtype=np.float64)
        return name

    def fix(self, name: str, value=None) -> None:
        spec = self.var_specs[name]
        spec.fixed = True
        spec.fixed_value = np.broadcast_to(
            np.asarray(spec.init if value is None else value, dtype=np.float64), spec.shape
        ).copy()

    def unfix(self, name: str) -> None:
        spec = self.var_specs[name]
        spec.fixed = False
        spec.fixed_value = None

    def is_fixed(self, name: str) -> bool:
        return self.var_specs[name].fixed

    def set_init(self, name: str, value) -> None:
        self.var_specs[name].init = value

    def set_bounds(self, name: str, lb=None, ub=None) -> None:
        spec = self.var_specs[name]
        if lb is not None:
            spec.lb = lb
        if ub is not None:
            spec.ub = ub

    # ---------------- constraints ----------------

    def _check_new_constraint(self, name: str, scale: float) -> None:
        if scale <= 0:
            raise ValueError("constraint scale must be positive")
        if any(c.name == name for c in self.constraints):
            raise ValueError(f"duplicate constraint {name!r}")

    def add_eq(self, name: str, fn: Callable, scale: float = 1.0) -> None:
        self._check_new_constraint(name, scale)
        self.constraints.append(_Constraint(name, fn, "eq", scale))

    def add_ineq(self, name: str, fn: Callable, scale: float = 1.0) -> None:
        """Register ``fn(v, p) <= 0``.  ``scale`` must be positive (a
        negative scale would flip the inequality)."""
        self._check_new_constraint(name, scale)
        self.constraints.append(_Constraint(name, fn, "ineq", scale))

    def deactivate(self, name: str) -> None:
        self.constraints = [c for c in self.constraints if c.name != name]

    def has_constraint(self, name: str) -> bool:
        return any(c.name == name for c in self.constraints)

    # ---------------- connections ----------------

    def connect(self, src: Port, dst: Port, name: Optional[str] = None) -> None:
        """Equate every shared stream member of two ports."""
        shared = [k for k in src.keys if k in dst.keys]
        if not shared:
            raise ValueError(f"ports {src.name} and {dst.name} share no stream members")
        cname = name or f"arc_{src.name}__{dst.name}"
        pairs = [(src.keys[k], dst.keys[k]) for k in shared]

        horizon = self.horizon

        def residual(v, p, _pairs=tuple(pairs)):
            # ravel each member time-LAST, as the JAX package does, so
            # the row order (and hence K and G) match it
            parts = []
            for a, b in _pairs:
                d = v[a] - v[b]
                if d.ndim >= 2 and d.shape[0] == horizon:
                    d = torch.movedim(d, 0, -1)
                parts.append(d.reshape(-1))
            return torch.cat(parts)

        self.add_eq(cname, residual)

    # ---------------- unit registry ----------------

    def register_unit(self, unit: "UnitModel") -> None:
        if unit.name in self.units:
            raise ValueError(f"duplicate unit {unit.name!r}")
        self.units[unit.name] = unit

    # ---------------- lowering ----------------

    def compile(self, objective: Optional[Callable] = None, sense: str = "min"):
        from dispatches_tpu_torch.core.compile import CompiledNLP

        if self._finalizers:
            for f in list(self._finalizers):
                f(self)
            self._finalizers.clear()
        return CompiledNLP(self, objective=objective, sense=sense)


class UnitModel:
    """Base class for unit models.  A subclass's ``__init__`` calls
    ``super().__init__(fs, name)`` and then declares variables,
    constraints and ports on ``self.fs`` using ``self.v("local")`` for
    fully-qualified names."""

    def __init__(self, fs: Flowsheet, name: str):
        self.fs = fs
        self.name = name
        self.ports: Dict[str, Port] = {}
        fs.register_unit(self)

    def v(self, local: str) -> str:
        return f"{self.name}.{local}"

    def add_var(self, local: str, **kw) -> str:
        return self.fs.add_var(self.v(local), **kw)

    def add_param(self, local: str, value) -> str:
        return self.fs.add_param(self.v(local), value)

    def add_eq(self, local: str, fn: Callable, scale: float = 1.0) -> None:
        self.fs.add_eq(self.v(local), fn, scale)

    def add_ineq(self, local: str, fn: Callable, scale: float = 1.0) -> None:
        self.fs.add_ineq(self.v(local), fn, scale)

    def add_port(self, local: str, members: Dict[str, str]) -> Port:
        port = Port(self.v(local), dict(members))
        self.ports[local] = port
        return port

    def port(self, local: str) -> Port:
        return self.ports[local]

    # ---- operator-facing stream-table report -----------------------

    def report_columns(self, solution) -> Dict[str, Dict[str, object]]:
        """Hook for extra non-port report columns, keyed
        ``{column: {row_label: value-or-varname}}``.  Values that are
        strings are looked up in ``solution`` (and time-sliced) by
        :meth:`report`; anything else is printed as-is.  Subclasses
        override it (the battery's ``"kWh"`` state column, tank
        holdups, ...)."""
        return {}

    def _report_value(self, solution, ref, time_point: int):
        if isinstance(ref, str):
            if ref in solution:
                val = solution[ref]
                val = (val.detach().cpu().numpy() if isinstance(val, torch.Tensor)
                       else np.asarray(val))
            elif ref in self.fs.params:
                val = np.asarray(self.fs.params[ref])
            else:
                return None
        else:
            return ref
        if val.ndim >= 1 and val.shape[0] == self.fs.horizon:
            val = val[time_point]
        if val.ndim == 0:
            return float(val)
        return np.asarray(val)

    def report(self, solution, time_point: int = 0, dof: bool = False,
               ostream=None, prefix: str = "") -> str:
        """Write the unit's stream table at ``time_point`` from a solved
        variable dict (``nlp.unravel(result.x)``; tensor values are read
        back to the host) and return it.

        Layout: an 84-char banner, optional model statistics under
        ``dof=True``, then one column per port (plus any
        :meth:`report_columns` extras) with one row per stream member.
        The report is a pure function of (model, solution)."""
        import io
        import sys

        out = ostream if ostream is not None else sys.stdout
        buf = io.StringIO()

        cols: Dict[str, Dict[str, object]] = {}
        for local, port in self.ports.items():
            col = {}
            for member, varname in port.keys.items():
                v = self._report_value(solution, varname, time_point)
                if v is not None:
                    col[member] = v
            if col:
                cols[local] = col
        for cname, rows in self.report_columns(solution).items():
            col = {}
            for label, ref in rows.items():
                v = self._report_value(solution, ref, time_point)
                if v is not None:
                    col[label] = v
            if col:
                cols[cname] = col

        width = 84
        tab = " " * 4
        lead = f"{prefix}Unit : {self.name}"
        trail = f"Time: {time_point}"
        buf.write("\n" + "=" * width + "\n")
        buf.write(lead + " " * max(width - len(lead) - len(trail), 1)
                  + trail)
        if dof:
            n_vars = sum(
                int(np.prod(s.shape)) if s.shape else 1
                for n, s in self.fs.var_specs.items()
                if n.startswith(self.name + ".")
            )
            n_cons = sum(1 for c in self.fs.constraints
                         if c.name.startswith(self.name + "."))
            buf.write("\n" + "=" * width + "\n")
            buf.write(f"{prefix}{tab}Local Variable Elements: {n_vars}"
                      f"{tab}Local Constraints Declared: {n_cons}")
        if cols:
            rows = []
            for col in cols.values():
                rows.extend(k for k in col if k not in rows)
            colw = {c: max(len(c), 12) for c in cols}
            keyw = max((len(r) for r in rows), default=0) + 2
            buf.write("\n" + "-" * width + "\n")
            buf.write(f"{prefix}{tab}Stream Table\n")
            head = " " * keyw + "".join(
                f"{c:>{colw[c] + 2}}" for c in cols)
            buf.write(prefix + tab + head + "\n")
            for r in rows:
                cells = []
                for c, col in cols.items():
                    v = col.get(r)
                    if v is None:
                        s = "-"
                    elif isinstance(v, float):
                        s = f"{v:.5g}"
                    else:
                        s = str(v)
                    cells.append(f"{s:>{colw[c] + 2}}")
                buf.write(prefix + tab + f"{r:<{keyw}}"
                          + "".join(cells) + "\n")
        buf.write("=" * width + "\n")
        text = buf.getvalue()
        out.write(text)
        return text


def tshift(arr: torch.Tensor, initial: torch.Tensor) -> torch.Tensor:
    """``[initial, arr[0], ..., arr[T-2]]`` — the previous-period value of
    a time-indexed tensor, with ``initial`` (a scalar var or param) at
    t=0."""
    return torch.cat([torch.reshape(initial, (1,)), arr[:-1]])
