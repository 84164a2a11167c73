"""Helpers shared by the parity tests of the concrete-TES branch and the
storage design studies (``tests/test_torch_concrete_tes.py``,
``test_torch_heat_exchanger_tube.py``, ``test_torch_scpc.py``,
``test_torch_storage_charge_design.py``,
``test_torch_storage_discharge_design.py``).

* ``tes_flowsheet`` / ``tube_flowsheet`` build the reference tests'
  ConcreteTES and ConcreteTubeSide cases from a package's modules, so the
  two packages' flowsheets are built the same way.
* ``assert_same_layout`` holds two compiled NLPs to one layout: names,
  order, shapes, scales and rows exactly; bounds, fixed values and
  parameters to ``rtol`` relative (bounds and fixed inlet enthalpies that
  come from a saturation solve carry the packages' saturation noise,
  ROADMAP.md §3).
* ``assert_rows_match`` holds the port's equality and inequality rows
  (and the objective) at one x to JAX's, each within ``rtol`` of the row's
  term size ``sum_j |dr_i/dx_j x_j|`` (at least 1).
* ``stop_design`` runs a design study's ``design_optimize`` with its
  square initialization (compile, solve, write-back) skipped and its
  ``ReducedSpaceNLP`` replaced by a raise that carries the compiled design
  NLP and its decisions: the design NLP is built in full from the
  flowsheet's warm start and nothing is solved.  (JAX's compile of a
  437 MW plant takes ~40 s of eager probing here; the skipped square
  compile halves the JAX side.)
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_concrete_tes import tes_data  # noqa: E402

CPU = "cpu"


def np_(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def tes_flowsheet(Flowsheet, tes_module, mode, initialize=True):
    """The reference test's ConcreteTES (``tests/test_concrete_tes.py``'s
    ``_build`` without its solve): ``(fs, tes)``."""
    data = tes_data()
    fs = Flowsheet(horizon=1)
    tes = tes_module.ConcreteTES(fs, "tes", data, operating_mode=mode)
    if mode in ("charge", "combined"):
        tes.fix_inlet("charge", flow_mol_total=data["flow_mol_charge"] * data["num_tubes"],
                      temperature=data["inlet_temperature_charge"])
    if mode in ("discharge", "combined"):
        tes.fix_inlet("discharge",
                      flow_mol_total=data["flow_mol_discharge"] * data["num_tubes"],
                      temperature=data["inlet_temperature_discharge"])
    if initialize:
        tes.initialize()
    return fs, tes


def tube_flowsheet(Flowsheet, tube_module, w95, flow_type="cocurrent", initialize=True):
    """The reference test's boil-through tube
    (``tests/test_heat_exchanger_tube.py``'s fixture): ``(fs, unit)``."""
    fs = Flowsheet(horizon=1)
    u = tube_module.ConcreteTubeSide(fs, "unit", finite_elements=20, flow_type=flow_type)
    fs.fix(u.d_tube_inner, 0.01167)
    fs.fix(u.d_tube_outer, 0.01167)
    fs.fix(u.tube_length, 4.85)
    fs.fix(u.htc, 500.0)
    fs.fix(u.inlet_state.flow_mol, 1.0)
    fs.fix(u.inlet_state.pressure, 101325.0)
    fs.fix(u.inlet_state.enth_mol, float(w95.props_tp(300.0, 101325.0, "liq")["h"]))
    if flow_type == "countercurrent":
        fs.fix(u.temperature_wall, np.linspace(900.0, 1000.0, 20)[None, :])
    else:
        fs.fix(u.temperature_wall, 1000.0)
    if initialize:
        u.initialize()
    return fs, u


def _rel_close(a, b, rtol):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return False
    both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
    fin = ~both_inf
    return bool(np.all(np.abs(a[fin] - b[fin]) <= rtol * np.maximum(1.0, np.abs(b[fin]))))


def assert_same_layout(nlp, jn, rtol=0.0):
    """Equal layouts: names, order, slices, shapes, scales and rows
    exactly; bounds, fixed values and params within ``rtol`` relative to
    max(1, |JAX's|) (exactly when ``rtol`` is 0)."""
    assert list(nlp.free_names) == list(jn.free_names)
    assert list(nlp.fixed_names) == list(jn.fixed_names)
    assert ({k: (int(a), int(b), tuple(s)) for k, (a, b, s) in nlp._slices.items()}
            == {k: (int(a), int(b), tuple(s)) for k, (a, b, s) in jn._slices.items()})
    np.testing.assert_array_equal(np.asarray(nlp.var_scale), np.asarray(jn.var_scale))
    assert dict(nlp.eq_slices) == dict(jn.eq_slices)
    assert dict(nlp.ineq_slices) == dict(jn.ineq_slices)
    for a in ("lb", "ub"):
        assert _rel_close(getattr(nlp, a), getattr(jn, a), rtol), a
    tp, jp = nlp.default_params(), jn.default_params()
    for grp in ("fixed", "p"):
        assert set(tp[grp]) == set(jp[grp]), grp
        for k in jp[grp]:
            assert _rel_close(tp[grp][k], jp[grp][k], rtol), (grp, k)


def x0_gap(nlp, jn):
    """``initialize``'s x0 of the port against JAX's, per entry relative
    to max(1, |x0|) (the scaled vector)."""
    a, b = np.asarray(nlp.x0, dtype=np.float64), np.asarray(jn.x0, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b))))


def jax_rows(jn, x):
    """JAX's equality and inequality rows and objective at the scaled
    ``x`` (numpy), jitted once."""
    import jax
    import jax.numpy as jnp

    p = jn.default_params()
    r, f = jax.jit(lambda xx: (jnp.concatenate([jn.eq(xx, p), jn.ineq(xx, p)]),
                               jn.objective(xx, p)))(jnp.asarray(x))
    return np.asarray(r), float(f)


def assert_rows_match(nlp, x, want_rows, want_obj=None, rtol=1e-10):
    """The port's ``[eq, ineq]`` rows at ``x`` (a tensor) within ``rtol``
    of each row's terms of ``want_rows`` (JAX's); with ``want_obj``, the
    objective within ``rtol`` of its terms.  Returns the worst row gap."""
    p = nlp.default_params()

    def rows(xx):
        return torch.cat([nlp.eq(xx, p), nlp.ineq(xx, p)])

    r = rows(x)
    assert r.shape[0] == len(want_rows) >= nlp.n
    J = torch.func.jacfwd(rows)(x)
    terms = np.maximum(1.0, np_((J.abs() * x.abs()).sum(1)))
    err = np.abs(np_(r) - want_rows) / terms
    assert np.all(np.isfinite(np_(r)))
    assert err.max() <= rtol, (float(err.max()), int(err.argmax()))
    if want_obj is not None:
        f = nlp.objective(x, p)
        df = torch.func.grad(lambda xx: nlp.objective(xx, p))(x)
        f_terms = max(1.0, float((df.abs() * x.abs()).sum()))
        assert abs(float(f) - want_obj) <= rtol * f_terms, (float(f), want_obj)
    return float(err.max())


class Built(Exception):
    """Raised in place of building the reduced-space solver: carries the
    design NLP that ``design_optimize`` compiled and its decisions."""

    def __init__(self, nlp, decisions):
        super().__init__("built")
        self.nlp, self.decisions = nlp, list(decisions)


def _raise_built(nlp, decisions, *_, **__):
    raise Built(nlp, decisions)


#: the square initialization NLP, not compiled: nothing to write back
_NO_SQUARE = SimpleNamespace(x0=np.zeros(0), free_names=[], unravel=lambda x: {})


def _converged_at_x0(nlp, *_, **__):
    return SimpleNamespace(x=np.asarray(nlp.x0, dtype=np.float64), converged=True,
                           max_residual=0.0, iterations=0)


def stop_design(module, m, **kw):
    """``module.design_optimize(m, **kw)`` built up to its reduced-space
    solver: the square initialization is skipped (its compile returns an
    empty stand-in, its solve "converges at x0" and writes nothing back)
    and the solver is replaced by a raise.  Returns the ``Built`` (its
    ``nlp`` and ``decisions``)."""
    compile_ = m.fs.compile

    def compile_design(objective=None, sense="min"):
        return _NO_SQUARE if objective is None else compile_(objective=objective, sense=sense)

    mp = pytest.MonkeyPatch()
    mp.setattr(m.fs, "compile", compile_design)
    mp.setattr(module, "solve_square", _converged_at_x0)
    mp.setattr(module, "ReducedSpaceNLP", _raise_built)
    try:
        module.design_optimize(m, **kw)
    except Built as built:
        return built
    finally:
        mp.undo()
    raise AssertionError("design_optimize did not build its reduced-space solver")


def decision_values(nlp, decisions):
    """The fixed values the design NLP starts its decisions at."""
    p = nlp.default_params()["fixed"]
    return np.array([float(np.ravel(p[d])[0]) for d in decisions])
