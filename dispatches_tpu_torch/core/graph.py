"""Time-indexed flowsheet graph (counterpart of ``dispatches_tpu/core/
graph.py``).

Every time-indexed quantity is ONE tensor with a leading time axis of
length ``horizon``; constraints are residual callables ``fn(v, p)`` on
torch tensors, evaluated vectorized over that axis, and time coupling is
a shifted-slice equality (:func:`tshift`).  ``Flowsheet.fix`` removes a
variable from the decision vector and injects its value through the
params dict.  The unit ``report()`` tables are not ported yet.
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


def tshift(arr: torch.Tensor, initial: torch.Tensor) -> torch.Tensor:
    """``[initial, arr[0], ..., arr[T-2]]`` — the previous-period value of
    a time-indexed tensor, with ``initial`` (a scalar var or param) at
    t=0."""
    return torch.cat([torch.reshape(initial, (1,)), arr[:-1]])
