"""The PyTorch port's SolverFactory held to the JAX package on the CPU.

The cases of tests/test_factory.py: a reference-style loop builds one
solver per (nlp, options) (the second solve is a cache hit), a stale
``id()`` entry is refused, and an unknown name raises.  Also: ``ipopt``
and ``cbc`` agree on an LP and with the JAX factory (objectives within
1e-6), ``cbc`` on a non-affine model falls back to the IPM, the tee lines
carry the JAX package's fields, and ``serve`` routes to the solve
service while the service's unported parts (a device mesh) are refused."""

import gc
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.core.graph import tshift as j_tshift  # noqa: E402
from dispatches_tpu.solvers.factory import SolverFactory as JSolverFactory  # noqa: E402

from dispatches_tpu_torch.analysis import assert_no_recompiles  # noqa: E402
from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.core.graph import tshift as t_tshift  # noqa: E402
from dispatches_tpu_torch.solvers.factory import (  # noqa: E402
    _REGISTRY,
    NLPKeyedCache,
    SolverFactory,
    register_solver,
)
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"


def _model(F, tshift, xp, T=8):
    fs = F(horizon=T)
    fs.add_var("charge", lb=0, ub=2.0)
    fs.add_var("discharge", lb=0, ub=2.0)
    fs.add_var("soc", lb=0, ub=8.0)
    fs.add_param("price", np.sin(np.arange(T)) * 20 + 30)
    zero = jnp.asarray(0.0) if xp is jnp else torch.tensor(0.0, dtype=torch.float64)
    fs.add_eq("soc_evolution", lambda v, p: v["soc"] - tshift(v["soc"], zero)
              - 0.9 * v["charge"] + v["discharge"] / 0.9)
    return fs.compile(objective=lambda v, p: xp.sum(p["price"] * (v["discharge"] - v["charge"])),
                      sense="max")


def _t_model(T=8):
    return _model(TFlowsheet, t_tshift, torch, T)


def _priced(nlp, price):
    params = nlp.default_params()
    params["p"]["price"] = np.asarray(price, float)
    return params


def test_ipm_factory_builds_once():
    """A reference-style loop over param values builds one solver: the
    second and later solves hit the cache."""
    nlp = _t_model()
    factory = SolverFactory("ipm", max_iter=120, device=CPU)
    rng = np.random.default_rng(0)
    first = factory.solve(nlp, _priced(nlp, 30 + 10 * rng.standard_normal(8)))
    assert bool(first.converged) and len(factory._cache) == 1
    built = factory._cache.get(nlp, (("max_iter", 120),))
    for _ in range(3):
        res = factory.solve(nlp, _priced(nlp, 30 + 10 * rng.standard_normal(8)))
        assert bool(res.converged)
    assert len(factory._cache) == 1
    assert factory._cache.get(nlp, (("max_iter", 120),)) is built


def test_ipm_factory_solves_without_recompiling():
    """tests/test_factory.py's steady-state contract on the port: after
    the first solve, a loop over new prices builds no program; the one
    build is counted under the JAX package's label."""
    nlp = _t_model()
    factory = SolverFactory("ipm", max_iter=120, device=CPU)
    rng = np.random.default_rng(0)
    first = factory.solve(nlp, _priced(nlp, 30 + 10 * rng.standard_normal(8)))
    assert bool(first.converged)
    with assert_no_recompiles():
        for _ in range(4):
            res = factory.solve(nlp, _priced(nlp, 30 + 10 * rng.standard_normal(8)))
            assert bool(res.converged)
    counter = factory._cache.get(nlp, (("max_iter", 120),))[0]._graft_counter
    assert (counter.label, counter.count) == ("factory.ipm", 1)


def test_factory_cache_two_sequential_nlps():
    """Models built, solved and dropped in sequence through one factory:
    shapes differ, so a stale hit could not pass."""
    factory = SolverFactory("ipm", max_iter=120, device=CPU)
    for T in (8, 10):
        nlp = _t_model(T)
        res = factory.solve(nlp)
        assert tuple(res.x.shape) == (nlp.n,)
        assert bool(res.converged)
        del nlp
        gc.collect()


def test_nlp_keyed_cache_rejects_stale_id_entry():
    class Obj:
        pass

    cache = NLPKeyedCache()
    a, b = Obj(), Obj()
    cache.set(a, "k", "value-for-a")
    assert cache.get(a, "k") == "value-for-a"
    assert cache.get(b, "k") is None
    # id(b) landing on a's old address: move a's entry onto b's key
    cache._entries[(id(b), "k")] = cache._entries.pop((id(a), "k"))
    del a
    gc.collect()
    assert cache.get(b, "k") is None  # stale entry refused...
    assert len(cache) == 0            # ...and evicted
    cache.set(b, "k", "value-for-b")
    assert cache.get(b, "k") == "value-for-b"


def test_factory_unknown_solver():
    with pytest.raises(ValueError, match="unknown solver"):
        SolverFactory("gurobi", device=CPU)


def test_serve_is_not_ported():
    """``serve`` itself is ported (tests/test_torch_serve.py holds it to
    the JAX service), its mesh option too."""
    from dispatches_tpu_torch.serve import SolveService, set_default_service

    prev = set_default_service(None)
    try:
        assert SolverFactory("serve", device=CPU).service.plan.device.type == "cpu"
    finally:
        set_default_service(prev)
    from dispatches_tpu_torch.parallel import scenario_mesh
    from dispatches_tpu_torch.serve import ServeOptions

    svc = SolveService(ServeOptions(mesh=scenario_mesh(2, device=CPU)), device=CPU)
    assert svc.plan.mesh.shape == {"scenario": 2} and svc.plan.device.type == "cpu"


def test_register_solver():
    class Dummy:
        def __init__(self, **kw):
            self.kw = kw

    register_solver("Dummy-Test", Dummy)
    try:
        assert SolverFactory("dummy-test", a=1).kw == {"a": 1}
    finally:
        del _REGISTRY["dummy-test"]


def _fields(line):
    return re.findall(r"(\w+)=", line)


def test_ipopt_and_cbc_agree_with_jax(capsys):
    """The storage LP: ipopt (IPM) and cbc (PDLP) agree within 1e-6, and
    each agrees with the JAX factory's solver of the same name; tee lines
    carry the JAX package's fields in the same order."""
    jn, tn = _model(JFlowsheet, j_tshift, jnp), _t_model()
    objs = {}
    for name in ("ipopt", "cbc"):
        got = SolverFactory(name, device=CPU).solve(tn, tee=True)
        t_line = capsys.readouterr().out.strip().splitlines()[-1]
        want = JSolverFactory(name).solve(jn, tee=True)
        j_line = capsys.readouterr().out.strip().splitlines()[-1]
        assert t_line.split()[0] == j_line.split()[0]
        assert _fields(t_line) == _fields(j_line)
        assert float(got.obj) == pytest.approx(float(want.obj), rel=1e-6)
        objs[name] = float(got.obj)
    assert objs["cbc"] == pytest.approx(objs["ipopt"], rel=1e-6)


def test_cbc_falls_back_to_ipm_on_nonaffine(capsys):
    fs = TFlowsheet()
    fs.add_var("x", shape=(), lb=0.0, init=2.0)
    fs.add_var("y", shape=(), init=2.0)
    fs.add_eq("hyper", lambda v, p: v["x"] * v["y"] - 1.0)
    nlp = fs.compile(objective=lambda v, p: v["x"] ** 2 + v["y"] ** 2)
    factory = SolverFactory("cbc", device=CPU)
    res = factory.solve(nlp, tee=True)
    out = capsys.readouterr().out
    assert "model not affine; using IPM" in out and "[dispatches_tpu.ipm]" in out
    assert bool(res.converged) and float(res.obj) == pytest.approx(2.0, abs=1e-6)
    assert factory._cache.get(nlp, ())[0] == "ipm"
    # options are split by name: kkt= reaches the fallback IPM
    res2 = factory.solve(nlp, kkt="dense", dtype="float32")
    assert float(res2.obj) == pytest.approx(2.0, abs=1e-6)
