"""The PyTorch port's parallel layer (``dispatches_tpu_torch.parallel``)
held to the JAX package's on the CPU, in float64.

The JAX side runs on its 8-device virtual CPU mesh (tests/conftest.py);
the port's CPU mesh names the one CPU device 1, 3 or 8 times, so a batch
is split into contiguous lane shards that run one after another.  The
cases of tests/test_parallel.py:

- ``scenario_sharded_solver`` with the default IPM on the T = 8 storage
  LP, 13 scenarios (uneven on every mesh): objectives within the IPM
  parity tolerance of tests/test_torch_ipm.py (1e-7 relative, 1e-9
  absolute) of JAX's 8-device run, on meshes of 1, 3 and 8 entries;
  ``full_result`` strips the pad from every leaf;
- the same solves against the port's unsplit run (no mesh): equal
  iterations and objectives within 1e-12 relative — the IPM's lanes do
  not interact; and the batch PDLP (the card's solver, float64, tol 1e-8,
  its plain sweep here) at 13 lanes on a mesh of 4 (3 pad lanes): equal
  iteration counts, objectives within 1e-8 relative (the solve's own
  tolerance).  The measured gap is 1.0e-9, and it is not the mesh's: a
  4-lane sub-batch through the same solver, with no mesh, parts from the
  13-lane batch by the same 1.0e-9 after the refinement tail, and a
  shard's lanes are bitwise that sub-batch's;
- an undeclared key, a scalar or ragged batch, and the
  ``options``/``max_iter``/``solver`` conflicts raise as in JAX;
- ``scenario_mesh`` and the plan's placement (``sharding_for``, ``slot``);
- ``dryrun_multichip(3, device="cpu")`` (7 scenarios of the horizon-8
  price-taker on a 3-entry mesh) against the same IPM unsplit, within
  1e-12 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.core.graph import tshift as j_tshift  # noqa: E402
from dispatches_tpu.parallel import scenario_mesh as j_scenario_mesh  # noqa: E402
from dispatches_tpu.parallel import scenario_sharded_solver as j_sharded  # noqa: E402

from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.core.graph import tshift as t_tshift  # noqa: E402
from dispatches_tpu_torch.parallel import Mesh, scenario_mesh, scenario_sharded_solver  # noqa: E402
from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions  # noqa: E402
from dispatches_tpu_torch.solvers import (  # noqa: E402
    BatchPDLPOptions,
    IPMOptions,
    make_ipm_solver,
    make_pdlp_batch_solver,
)
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"
T = 8
N_SCEN = 13
IPM_RTOL, IPM_ATOL = 1e-7, 1e-9   # tests/test_torch_ipm.py's parity tolerance
LANE_RTOL = 1e-12                  # IPM mesh against the unsplit run
PDLP_LANE_RTOL = 1e-8              # batch-PDLP mesh against the unsplit run


def _storage_nlp(Flowsheet, tshift, xp):
    fs = Flowsheet(horizon=T)
    fs.add_var("charge", lb=0, ub=1)
    fs.add_var("discharge", lb=0, ub=1)
    fs.add_var("soc", lb=0, ub=3)
    fs.add_var("soc0", shape=(), lb=0)
    fs.fix("soc0", 0.0)
    fs.add_param("price", np.ones(T))
    fs.add_eq("soc", lambda v, p: v["soc"] - tshift(v["soc"], v["soc0"])
              - v["charge"] + v["discharge"])
    return fs.compile(
        objective=lambda v, p: xp.sum(p["price"] * (v["discharge"] - v["charge"])),
        sense="max")


@pytest.fixture(scope="module")
def nlps():
    return (_storage_nlp(JFlowsheet, j_tshift, jnp),
            _storage_nlp(TFlowsheet, t_tshift, torch))


@pytest.fixture(scope="module")
def prices():
    return np.random.default_rng(1).uniform(1.0, 10.0, (N_SCEN, T))


@pytest.fixture(scope="module")
def j_full(nlps, prices):
    """JAX's sharded IPM over its 8-device mesh (13 scenarios pad to 16)."""
    solve = j_sharded(nlps[0], j_scenario_mesh(8), batched_keys=("price",),
                      max_iter=60, full_result=True)
    return jax.tree_util.tree_map(np.asarray, solve({"price": prices}))


@pytest.fixture(scope="module")
def t_unsplit(nlps, prices):
    params = nlps[1].default_params()
    params["p"]["price"] = prices
    return make_ipm_solver(nlps[1], IPMOptions(max_iter=60), device=CPU)(params)


@pytest.mark.parametrize("n_mesh", [1, 3, 8])
def test_sharded_ipm_matches_jax_and_the_unsplit_run(nlps, prices, j_full, t_unsplit, n_mesh):
    mesh = scenario_mesh(n_mesh, device=CPU)
    full = scenario_sharded_solver(nlps[1], mesh, batched_keys=("price",), max_iter=60,
                                   full_result=True)({"price": prices})
    objs = scenario_sharded_solver(nlps[1], mesh, batched_keys=("price",),
                                   max_iter=60)({"price": prices})
    assert tuple(objs.shape) == (N_SCEN,) and torch.equal(objs, full.obj)
    # full_result: every leaf trimmed to the 13 live scenarios
    for name, leaf in full._asdict().items():
        if isinstance(leaf, torch.Tensor) and leaf.ndim:
            assert leaf.shape[0] == N_SCEN, name
    np.testing.assert_allclose(objs.numpy(), j_full.obj, rtol=IPM_RTOL, atol=IPM_ATOL)
    np.testing.assert_array_equal(full.iterations.numpy(), t_unsplit.iterations.numpy())
    np.testing.assert_allclose(objs.numpy(), t_unsplit.obj.numpy(), rtol=LANE_RTOL, atol=0)
    assert (full.status.numpy() == 0).all()


def test_batch_pdlp_lanes_do_not_interact(nlps, prices):
    """The card's solver (the batch PDLP, float64, tol 1e-8; here its
    plain sweep) on a 4-entry mesh: 13 lanes pad to 16; each lane's
    iteration count equals the unsplit run's, its objective within the
    solve's tolerance, as a 4-lane sub-batch without a mesh does."""
    solver = make_pdlp_batch_solver(nlps[1], BatchPDLPOptions(tol=1e-8, dtype="float64"),
                                    device=CPU)
    params = nlps[1].default_params()
    params["p"]["price"] = prices
    ref = solver(params)
    got = scenario_sharded_solver(nlps[1], scenario_mesh(4, device=CPU), batched_keys=("price",),
                                  solver=solver, full_result=True)({"price": prices})
    np.testing.assert_array_equal(got.iters.numpy(), ref.iters.numpy())
    gap = float(((got.obj - ref.obj).abs() / ref.obj.abs()).max())
    params["p"]["price"] = prices[8:12]
    sub = solver(params)
    sub_gap = float(((sub.obj - ref.obj[8:12]).abs() / ref.obj[8:12].abs()).max())
    print(f"batch PDLP: mesh vs unsplit {gap:.3e}, 4-lane sub-batch vs unsplit {sub_gap:.3e}")
    assert gap <= PDLP_LANE_RTOL and sub_gap <= PDLP_LANE_RTOL
    # the gap is the batch size's, not the mesh's: a shard is bitwise the
    # solve of its own 4 lanes
    assert torch.equal(got.obj[8:12], sub.obj) and torch.equal(got.iters[8:12], sub.iters)


def test_contract_errors_match_jax(nlps):
    jnlp, tnlp = nlps
    for pkg_nlp, mesh, sharded in ((jnlp, j_scenario_mesh(4), j_sharded),
                                   (tnlp, scenario_mesh(4, device=CPU), scenario_sharded_solver)):
        solve = sharded(pkg_nlp, mesh, batched_keys=("price",), max_iter=5)
        with pytest.raises(KeyError):
            solve({"not_a_key": np.zeros((4, T))})
        with pytest.raises(ValueError, match="scalar"):
            solve({"price": np.float64(1.0)})
        with pytest.raises(ValueError, match="inconsistent"):
            sharded(pkg_nlp, mesh, batched_keys=("price", "soc0"),
                    max_iter=5)({"price": np.zeros((4, T)), "soc0": np.zeros(3)})
        with pytest.raises(ValueError, match="empty"):
            solve({})
        with pytest.raises(ValueError):
            sharded(pkg_nlp, mesh, options=object(), max_iter=50)
        with pytest.raises(ValueError):
            sharded(pkg_nlp, mesh, solver=lambda p: p, max_iter=10)


def test_scenario_mesh_and_plan_placement():
    m = scenario_mesh(3, axis="day", device=CPU)
    assert m.axis_names == ("day",) and m.shape == {"day": 3} and m.size == 3
    assert [str(d) for d in m.devices] == ["cpu"] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            scenario_mesh(2)
    with pytest.raises(ValueError):
        Mesh([])
    plan = ExecutionPlan(PlanOptions(mesh=Mesh([CPU] * 4), donate=False))
    assert plan.device == torch.device(CPU)
    assert plan.sharding_for(8) == [torch.device(CPU)] * 4 and plan.sharding_for(6) is None
    prog = plan.program(lambda t: t["x"] + t["b"], label="parallel.place", donate_argnums=())
    x = np.arange(16.0).reshape(8, 2)
    tree = {"x": x, "b": np.ones(2)}
    for lanes, kw in ((8, {}), (8, {"slot": 5})):
        staged = plan.stage(tree, lanes=lanes, donate=False,
                            batched={"x": True, "b": False}, **kw)
        out = plan.collect(plan.submit(prog, (staged,), n_live=lanes, lanes=lanes))
        np.testing.assert_array_equal(out.numpy(), x + 1.0)
    # a caller-owned tensor is never handed to a donating program
    owned = torch.arange(8.0)
    staged = plan.stage({"x": owned}, lanes=8, donate=True)
    for part in staged.parts:
        part["x"].zero_()
    assert torch.equal(owned, torch.arange(8.0))


def test_dryrun_multichip_matches_the_unsplit_solve():
    """The dry run's 7 scenarios over a 3-entry CPU mesh (pad 2) against
    the same IPM on the 7 lanes unsplit (the IPM itself is held to JAX's
    in tests/test_torch_ipm.py)."""
    from dispatches_tpu_torch.entry import _build_nlp, _lmp_batch, dryrun_multichip

    objs = dryrun_multichip(3, device=CPU)
    assert tuple(objs.shape) == (7,)
    nlp = _build_nlp(horizon=8)
    params = nlp.default_params()
    params["p"]["lmp"] = _lmp_batch(7, 8)
    ref = make_ipm_solver(nlp, IPMOptions(max_iter=60), device=CPU)(params)
    np.testing.assert_allclose(objs.numpy(), ref.obj.numpy(), rtol=LANE_RTOL, atol=0)
