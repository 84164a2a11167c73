"""The port's analysis package (``dispatches_tpu_torch.analysis``) held to
the JAX package's on the CPU.

* graftlint: every torch GL001-GL008 bad snippet fires its rule at its
  JAX original's lines and every good snippet stays clean; findings
  render ``path:line rule-id``; the baseline survives line shifts and
  masks no new finding; ``python -m dispatches_tpu_torch.analysis
  --check`` exits 0 on the port as committed and 1 on a seeded
  violation; the flags the port reads are registered with the JAX
  registry's names.
* recompile accounting: ``CountedProgram``/``ProgramCounter`` count
  argument signatures, ``recompile_counts()`` keys collisions as
  ``label#k``, ``assert_no_recompiles`` passes on reuse and raises on a
  new signature or a program built in the block, ``allow`` exempts, and
  ``DISPATCHES_TPU_WARN_RECOMPILE`` warns; ``recompile_counts()`` equals
  the JAX package's label for label after the same factory loop and the
  same two serve rounds (JAX's side recorded, ``slow`` check); the 3-day
  wind-battery double loop of tests/test_analysis.py runs days 2-3 under
  ``assert_no_recompiles``.
* ``checkified`` raises on the first NaN an aten op writes.
* the faults the lint found: the day-batch bidder makes one host
  transfer of its solutions (bids bitwise the per-day loop's), and the
  kernel library's build lock carries its pragma.
* importing the package, its CLI and ``chip_smoke.py`` leaves ``jax``
  and ``dispatches_tpu`` out of ``sys.modules``.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu import Flowsheet as JFlowsheet  # noqa: E402
from dispatches_tpu.analysis import CORPUS as J_CORPUS  # noqa: E402
from dispatches_tpu.analysis import RULES as J_RULES  # noqa: E402
from dispatches_tpu.analysis import lint_source as j_lint_source  # noqa: E402
from dispatches_tpu.analysis.flags import REGISTERED_FLAGS as J_FLAGS  # noqa: E402

from dispatches_tpu_torch.analysis import (  # noqa: E402
    CORPUS,
    DEFAULT_BASELINE,
    REGISTERED_FLAGS,
    RULES,
    CountedProgram,
    ProgramCounter,
    RecompileWarning,
    assert_no_recompiles,
    check_paths,
    checkified,
    lint_source,
    load_baseline,
    new_findings,
    recompile_counts,
    reset_recompile_counts,
    run_selftest,
    write_baseline,
)
from dispatches_tpu_torch.analysis.graftlint import lint_paths, package_root  # noqa: E402
from dispatches_tpu_torch.core.graph import Flowsheet as TFlowsheet  # noqa: E402
from dispatches_tpu_torch.serve import ServeOptions, SolveService  # noqa: E402
from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp  # noqa: E402
from dispatches_tpu_torch.solvers.factory import SolverFactory  # noqa: E402

import torch_records  # noqa: E402
from test_torch_factory import _model, _t_model  # noqa: E402
from test_torch_stacked import make_bidder, one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"
COUNTS_RECORD = "analysis_recompile_counts_jax"
LINT_RULES = [f"GL00{i}" for i in range(1, 9)]


def _lines(findings, rule):
    return sorted({f.line for f in findings if f.rule == rule})


# ---------------------------------------------------------------------------
# graftlint: rules, corpus, machinery, CLI
# ---------------------------------------------------------------------------


def test_selftest_corpus():
    assert run_selftest() == []


def test_rule_registry_is_the_jax_registry():
    """The same ids; every name but GL005's, whose torch meaning is a
    constructor falling back to float32."""
    assert list(RULES) == list(J_RULES)
    assert {k for k in RULES if RULES[k] != J_RULES[k]} == {"GL005"}
    assert RULES["GL005"] == "default-float-dtype"
    for rule in RULES:
        assert set(CORPUS[rule]) == {"bad", "good"}


@pytest.mark.parametrize("rule", LINT_RULES)
def test_torch_snippet_fires_at_the_jax_lines(rule):
    """Each torch bad snippet fires its rule at the lines where JAX's
    original fires, and nothing else; each good snippet stays clean."""
    want = _lines(j_lint_source(textwrap.dedent(J_CORPUS[rule]["bad"]), "<bad>"), rule)
    got = lint_source(textwrap.dedent(CORPUS[rule]["bad"]), "<bad>")
    assert want and _lines(got, rule) == want
    assert {f.rule for f in got} == {rule}
    assert lint_source(textwrap.dedent(CORPUS[rule]["good"]), "<good>") == []


def test_finding_renders_path_line_rule():
    src = textwrap.dedent(
        """
        import torch

        def f(x):
            return float(x) + 1.0

        g = torch.func.vmap(f)
        """
    )
    findings = lint_source(src, "pkg/mod.py")
    assert len(findings) == 1
    f = findings[0]
    assert (f.rule, f.path, f.line) == ("GL001", "pkg/mod.py", 5)
    assert f.render().startswith("pkg/mod.py:5") and "GL001" in f.render()


_SRC = (
    "import torch\n"
    "def f(x):\n"
    "    return float(x)\n"
    "g = torch.func.grad(f)\n"
)


def test_baseline_survives_line_shifts(tmp_path):
    base_file = tmp_path / "baseline"
    write_baseline(lint_source(_SRC, "m.py"), base_file)
    shifted = "# comment\n# more\n\n" + _SRC
    assert new_findings(lint_source(shifted, "m.py"), load_baseline(base_file)) == []


def test_baseline_does_not_mask_new_findings(tmp_path):
    base_file = tmp_path / "baseline"
    write_baseline(lint_source(_SRC, "m.py"), base_file)
    grown = _SRC + "def h(x):\n    return x.item()\nk = torch.func.vmap(h)\n"
    fresh = new_findings(lint_source(grown, "m.py"), load_baseline(base_file))
    assert [(f.rule, f.line) for f in fresh] == [("GL001", 6)]


def test_repo_lints_clean_against_committed_baseline():
    findings = lint_paths([package_root()]) + check_paths([package_root()])
    fresh = new_findings(findings, load_baseline(DEFAULT_BASELINE))
    assert fresh == [], "\n".join(f.render() for f in fresh)
    # what stays baselined is GL008 only (per-card placement outside the
    # plan); no lock finding is baselined
    assert {f.rule for f in findings} == {"GL008"}
    assert sum(load_baseline(DEFAULT_BASELINE).values()) == len(findings)


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "dispatches_tpu_torch.analysis", *args],
                          capture_output=True, text=True, cwd=REPO)


def test_cli_check_and_selftest_exit_zero():
    proc = _cli("--check")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 new" in proc.stdout
    proc = _cli("--selftest")
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_check_fails_on_new_violation(tmp_path):
    bad = tmp_path / "fresh_violation.py"
    bad.write_text(
        "import torch\n"
        "def f(x):\n"
        "    if x > 0:\n"
        "        return x\n"
        "    return -x\n"
        "g = torch.func.vmap(f)\n"
    )
    proc = _cli("--check", str(bad))
    assert proc.returncode == 1
    assert "GL002" in proc.stdout


def test_gl004_hot_loop_and_gl006_flags():
    src = textwrap.dedent(
        """
        import os
        import torch

        def build(x, days):
            for hour in range(24):
                a = torch.zeros(4, dtype=torch.float64)
                b = x[hour].item()
            return os.environ.get("DISPATCHES_TPU_FRBNZ")
        """
    )
    assert [(f.rule, f.line) for f in lint_source(src, "m.py")] == [
        ("GL004", 7), ("GL004", 8), ("GL006", 9)]


@pytest.mark.parametrize("src, fires", [
    ("torch.zeros(3)", True),
    ("torch.zeros(3, dtype=torch.float64)", False),
    ("torch.tensor(0.5)", True),
    ("torch.tensor([1, 2])", False),
    ("torch.tensor([x, y])", True),
    ("torch.tensor(arr)", False),
    ("torch.full((3,), 2)", False),
    ("torch.full((3,), flag > 0)", False),
    ("torch.full((3,), v)", True),
    ("torch.arange(4)", False),
    ("torch.arange(0.0, 1.0, 0.25)", True),
    ("torch.linspace(0, 1, 5, **kw)", False),
])
def test_gl005_default_float_dtype(src, fires):
    got = [f.rule for f in lint_source(f"import torch\ny = {src}\n", "m.py")]
    assert got == (["GL005"] if fires else [])


@pytest.mark.parametrize("src, fires", [
    ("torch.func.vmap(f, in_dims=(0, axes))", False),
    ("torch.func.vmap(f, in_dims=(0,) + dims)", False),
    ("torch.func.vmap(f, in_dims=(0, axes) + (0,) * n)", False),
    ("torch.func.vmap(f, in_dims=[0, 0])", True),
    ("torch.func.vmap(f, in_dims=dims)", True),
    ("torch.func.vmap(f, out_dims=1.0)", True),
    ("torch.func.jacrev(f, argnums=(0, 1))", False),
    ("torch.func.jacrev(f, argnums=[0, 1])", True),
    ("torch.autograd.grad(y, x, argnums=n)", False),
])
def test_gl003_transform_arguments(src, fires):
    got = [f.rule for f in lint_source(f"import torch\ny = {src}\n", "m.py")]
    assert got == (["GL003"] if fires else [])


def test_gl007_fenced_by_event_or_stream_synchronize():
    src = textwrap.dedent(
        """
        import time
        import torch

        def bench(make_pdlp_solver, nlp, p):
            solver = make_pdlp_solver(nlp)
            t0 = time.perf_counter()
            res = solver(p)
            torch.cuda.current_stream().synchronize()
            return res, time.perf_counter() - t0

        def launch(halpern_sweep, a):
            t0 = time.perf_counter()
            out = halpern_sweep(*a)
            return out, time.perf_counter() - t0
        """
    )
    assert [(f.rule, f.line) for f in lint_source(src, "m.py")] == [("GL007", 14)]


@pytest.mark.parametrize("relpath, fires", [
    ("dispatches_tpu_torch/serve/x.py", True),
    ("dispatches_tpu_torch/plan/x.py", False),
    ("dispatches_tpu_torch/grid/x.py", False),
])
def test_gl008_programs_built_in_the_caller_layers(relpath, fires):
    src = ("import torch\n"
           "p = CountedProgram(f, label='x')\n"
           "g = torch.compile(f)\n"
           "with torch.cuda.graph(cg):\n"
           "    pass\n")
    got = [(f.rule, f.line) for f in lint_source(src, relpath)]
    assert got == ([("GL008", 2), ("GL008", 3), ("GL008", 4)] if fires else [])


def test_gl008_card_literal_and_computed_index():
    src = ("import torch\n"
           "a = x.to('cuda:1')\n"
           "b = torch.zeros(2, dtype=torch.float64, device=mesh.devices[i])\n"
           "c = x.to(mesh.devices[0])\n"
           "d = x.to('cuda')\n")
    assert [(f.rule, f.line) for f in lint_source(src, "m.py")] == [("GL008", 2), ("GL008", 3)]


def test_port_flags_are_registered_under_jax_names():
    """Every flag the port reads keeps its JAX name (one setting steers
    both packages), and the three this slice registers are there."""
    assert set(REGISTERED_FLAGS) <= set(J_FLAGS)
    assert {"DATA", "RTS_GMLC", "WARN_RECOMPILE"} <= set(REGISTERED_FLAGS)
    assert not {"COMPILE_CACHE", "NO_COMPILE_CACHE", "NO_X64"} & set(REGISTERED_FLAGS)
    readers = [package_root() / "case_studies/renewables/load_parameters.py",
               package_root() / "workflow/managed.py"]
    assert [f for f in lint_paths(readers) if f.rule == "GL006"] == []


# ---------------------------------------------------------------------------
# the faults the lint found
# ---------------------------------------------------------------------------


def test_kernel_build_lock_pragma(tmp_path):
    """The kernel library's build lock is held across nvcc on purpose:
    its pragma keeps GL009 quiet, and without it the hold is reported at
    the library_path() call."""
    src = (package_root() / "kernels/pdhg_sweep.py").read_text()
    assert check_paths([package_root() / "kernels/pdhg_sweep.py"]) == []
    bare = tmp_path / "pdhg_sweep.py"
    bare.write_text(src.replace("  # lockcheck: intentional(GL009)", ""))
    got = check_paths([bare])
    assert [f.rule for f in got] == ["GL009"] and "library_path()" in got[0].message


def _old_day_loop(bidder, batched, res, dates, ov_keys):
    """The per-day loop before the fix: a host transfer per day."""
    blk, H = bidder.day_ahead_model, bidder.day_ahead_horizon
    out = {}
    for i, d in enumerate(dates):
        day_params = {"p": {**batched["p"],
                            "energy_price": batched["p"]["energy_price"][i],
                            **{k: np.asarray(batched["p"][k][i], float) for k in ov_keys}},
                      "fixed": batched["fixed"]}
        powers = blk.stacked.scenario_profiles(res.x[i], day_params)
        out[d] = bidder._format_bids(blk, batched["p"]["energy_price"][i], powers,
                                     res.x[i].detach().cpu().numpy(), H)
    return out


@pytest.mark.parametrize("kind", ["first_stage", "monotone"])
def test_day_batch_bids_take_one_host_transfer(kind, monkeypatch):
    """compute_day_ahead_bids_batch moves the solutions and the day
    profiles to the host once each (two .cpu() calls for any number of
    days, spied with the solve's result held fixed), and its bids are
    bitwise the per-day loop's."""
    dates = ["2020-01-02", "2020-01-03", "2020-01-04"]
    bidder = make_bidder("torch", kind)
    blk = bidder.day_ahead_model
    # the day batch's cached program, wrapped to keep what it was given
    # and what it returned
    ck = (len(dates), ("windpower.capacity_factor",))
    program = CountedProgram(blk.solver_fn, label="bidder.batch_solve[D=3]")
    seen = {}

    def capture(batched):
        seen["batched"], seen["res"] = batched, program(batched)
        return seen["res"]

    blk._batch_solvers = {ck: capture}
    got = bidder.compute_day_ahead_bids_batch(dates)
    want = _old_day_loop(bidder, seen["batched"], seen["res"], dates, ck[1])
    assert got == want

    blk._batch_solvers[ck] = lambda batched: seen["res"]
    calls = []
    real_cpu = torch.Tensor.cpu

    def spy(self, *a, **k):
        calls.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", spy)
    again = bidder.compute_day_ahead_bids_batch(dates)
    monkeypatch.undo()
    assert again == want
    S, n = bidder.n_scenario, seen["res"].x.shape[-1]
    assert calls == [(3, S, bidder.day_ahead_horizon), (3, n)]


# ---------------------------------------------------------------------------
# recompile accounting
# ---------------------------------------------------------------------------


def test_counted_program_counts_signatures():
    f = CountedProgram(lambda x: x * 2.0, label="t.double")
    a = torch.arange(4.0, dtype=torch.float64)
    assert torch.equal(f(a), a * 2)
    f(a + 1.0)  # same shape/dtype: reused
    assert f._graft_counter.count == 1
    f(torch.arange(8.0, dtype=torch.float64))  # new shape: a new build
    assert f._graft_counter.count == 2
    assert recompile_counts()["t.double"] == 2


def test_label_collision_keys():
    g1 = CountedProgram(lambda x: x + 1, label="t.same")
    g2 = CountedProgram(lambda x: x + 2, label="t.same")
    g1(torch.zeros(2, dtype=torch.float64))
    counts = recompile_counts()
    assert counts["t.same"] == 1 and counts["t.same#1"] == 0
    g2(torch.zeros(2, dtype=torch.float64))
    assert recompile_counts()["t.same#1"] == 1


def test_assert_no_recompiles_passes_on_reuse():
    f = CountedProgram(lambda x: x - 1.0, label="t.steady")
    f(torch.zeros(3, dtype=torch.float64))
    with assert_no_recompiles():
        for _ in range(4):
            f(torch.ones(3, dtype=torch.float64))
    assert f._graft_counter.count == 1


def test_assert_no_recompiles_raises_on_a_new_signature():
    f = CountedProgram(lambda x: x * 3.0, label="t.churn")
    f(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(AssertionError, match="t.churn"):
        with assert_no_recompiles():
            f(torch.zeros(5, dtype=torch.float64))


def test_assert_no_recompiles_catches_a_program_built_inside():
    with pytest.raises(AssertionError, match="t.late"):
        with assert_no_recompiles():
            ProgramCounter("t.late").observe(("sig",))


def test_assert_no_recompiles_allow_exempts_label():
    f = CountedProgram(lambda x: x, label="t.exempt")
    with assert_no_recompiles(allow=("t.exempt",)):
        f(torch.zeros(2, dtype=torch.float64))


def test_reset_keeps_programs_warm():
    f = CountedProgram(lambda x: x, label="t.reset")
    f(torch.zeros(2, dtype=torch.float64))
    reset_recompile_counts()
    assert "t.reset" not in recompile_counts() and f._graft_counter.count == 0
    f(torch.zeros(2, dtype=torch.float64))  # seen before the reset
    assert f._graft_counter.count == 0


def test_warn_recompile_flag(monkeypatch):
    f = CountedProgram(lambda x: x + 5.0, label="t.warn")
    f(torch.zeros(2, dtype=torch.float64))
    monkeypatch.setenv("DISPATCHES_TPU_WARN_RECOMPILE", "1")
    with pytest.warns(RecompileWarning, match="t.warn"):
        f(torch.zeros(7, dtype=torch.float64))


def _nonaffine(F):
    fs = F()
    fs.add_var("x", shape=(), lb=0.0, init=2.0)
    fs.add_var("y", shape=(), init=2.0)
    fs.add_eq("hyper", lambda v, p: v["x"] * v["y"] - 1.0)
    return fs.compile(objective=lambda v, p: v["x"] ** 2 + v["y"] ** 2)


def _factory_loop(nlp, nonaffine, factory, reset, counts):
    """Three IPM solves, three cbc (PDLP) solves over new prices, and two
    cbc solves of a non-affine model (the IPM fallback)."""
    reset()
    rng = np.random.default_rng(0)

    def priced():
        p = nlp.default_params()
        p["p"]["price"] = 30 + 10 * rng.standard_normal(8)
        return p

    ipm = factory("ipm", max_iter=120)
    for _ in range(3):
        ipm.solve(nlp, priced())
    cbc = factory("cbc")
    for _ in range(3):
        cbc.solve(nlp, priced())
    for _ in range(2):
        cbc.solve(nonaffine)
    return counts()


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _serve_rounds(service, nlp8, nlp12, reset, counts):
    """tests/test_serve.py's steady-state pattern: 2 waves of (8 PDLP at
    T = 8, 8 IPM at T = 12) a round, max_batch 16, two identical rounds;
    the counts after each round and the service's metrics."""
    reset()
    clock = FakeClock()
    svc = service(clock)
    rng = np.random.default_rng(0)

    def params(nlp, T):
        d = nlp.default_params()
        return {"p": {**d["p"], "price": 30 + 10 * rng.standard_normal(T)}, "fixed": d["fixed"]}

    reqs = []
    for _ in range(2):
        reqs += [("pdlp", nlp8, params(nlp8, 8)) for _ in range(8)]
        reqs += [("ipm", nlp12, params(nlp12, 12)) for _ in range(8)]

    def run_round():
        handles = []
        for kind, nlp, p in reqs:
            clock.t += 1e-4
            handles.append(svc.submit(nlp, p, solver=kind, options=(
                {"tol": 1e-9} if kind == "pdlp" else {"max_iter": 200})))
        svc.flush_all()
        return [h.result().status for h in handles]

    out = {"round1": run_round()}
    out["counts1"] = counts()
    out["round2"] = run_round()
    out["counts2"] = counts()
    m = svc.metrics()
    out["metrics"] = {k: m[k] for k in ("programs", "compile_count", "solved")}
    return out


def jax_record():
    """JAX's recompile_counts() after the factory loop and the serve
    rounds (recorded: the JAX IPM compiles for ~15 s on the CPU)."""
    from dispatches_tpu.analysis import recompile_counts as jcounts
    from dispatches_tpu.analysis import reset_recompile_counts as jreset
    from dispatches_tpu.core.graph import tshift as j_tshift
    from dispatches_tpu.serve import ServeOptions as JServeOptions
    from dispatches_tpu.serve import SolveService as JSolveService
    from dispatches_tpu.serve.__main__ import _arbitrage_nlp as j_arbitrage_nlp
    from dispatches_tpu.solvers.factory import SolverFactory as JSolverFactory

    factory = _factory_loop(_model(JFlowsheet, j_tshift, jnp), _nonaffine(JFlowsheet),
                            JSolverFactory, jreset, jcounts)
    serve = _serve_rounds(
        lambda clock: JSolveService(JServeOptions(max_batch=16, max_wait_ms=1e9,
                                                  warm_start=False), clock=clock),
        j_arbitrage_nlp(8), j_arbitrage_nlp(12), jreset, jcounts)
    jreset()
    return {"factory": factory, "serve": serve}


@pytest.mark.slow
def test_counts_jax_record_is_current():
    assert torch_records.matches(COUNTS_RECORD, jax_record())


def test_recompile_counts_equal_jax_after_the_factory_loop():
    want = torch_records.read(COUNTS_RECORD)["factory"]
    got = _factory_loop(_t_model(), _nonaffine(TFlowsheet),
                        lambda name, **kw: SolverFactory(name, device=CPU, **kw),
                        reset_recompile_counts, recompile_counts)
    assert got == want == {"factory.ipm": 1, "factory.pdlp": 1,
                           "factory.pdlp_ipm_fallback": 1}


def test_recompile_counts_equal_jax_after_two_serve_rounds():
    want = torch_records.read(COUNTS_RECORD)["serve"]
    got = _serve_rounds(
        lambda clock: SolveService(ServeOptions(max_batch=16, max_wait_ms=1e9,
                                                warm_start=False), clock=clock, device=CPU),
        _arbitrage_nlp(8), _arbitrage_nlp(12), reset_recompile_counts, recompile_counts)
    assert got["counts1"] == want["counts1"] and got["counts2"] == want["counts2"]
    assert got["metrics"] == want["metrics"]
    assert got["round1"] + got["round2"] == want["round1"] + want["round2"]


# ---------------------------------------------------------------------------
# checkified
# ---------------------------------------------------------------------------


def test_checkified_raises_on_nan():
    cf = checkified(torch.log)
    assert torch.equal(cf(torch.tensor([1.0], dtype=torch.float64)),
                       torch.tensor([0.0], dtype=torch.float64))
    with pytest.raises(FloatingPointError, match="nan"):
        cf(torch.tensor([-1.0], dtype=torch.float64))


def test_checkified_sees_every_op_inside():
    def f(x):
        y = torch.sqrt(x - 2.0)  # the NaN is born here
        return torch.nan_to_num(y)  # and scrubbed before the output

    assert torch.equal(f(torch.ones(2, dtype=torch.float64)),
                       torch.zeros(2, dtype=torch.float64))
    with pytest.raises(FloatingPointError, match="nan generated by primitive aten.sqrt"):
        checkified(f)(torch.ones(2, dtype=torch.float64))


# ---------------------------------------------------------------------------
# acceptance: the 3-day double loop in steady state
# ---------------------------------------------------------------------------


def _wind_battery_coordinator(n_tracking_hour=2, da_horizon=8, rt_horizon=4):
    from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (
        MultiPeriodWindBattery,
    )
    from dispatches_tpu_torch.grid import (
        DoubleLoopCoordinator,
        RenewableGeneratorModelData,
        SelfScheduler,
        Tracker,
    )

    rng = np.random.default_rng(7)
    cfs = 0.3 + 0.4 * rng.random(24 * 4)
    md = RenewableGeneratorModelData(gen_name="4_WIND", bus="4", p_min=0.0, p_max=120.0)

    def make_mp():
        return MultiPeriodWindBattery(model_data=md, wind_capacity_factors=cfs,
                                      wind_pmax_mw=120, battery_pmax_mw=15,
                                      battery_energy_capacity_mwh=60)

    class _Forecaster:
        def forecast_day_ahead_prices(self, date, hour, bus, horizon, n):
            base = 25.0 + 5.0 * np.sin(np.arange(horizon) + hour)
            return np.stack([base * (1.0 + 0.1 * s) for s in range(n)])

        forecast_real_time_prices = forecast_day_ahead_prices

    bidder = SelfScheduler(bidding_model_object=make_mp(), day_ahead_horizon=da_horizon,
                           real_time_horizon=rt_horizon, n_scenario=1,
                           forecaster=_Forecaster(), max_iter=120, device=CPU)
    tracker = Tracker(tracking_model_object=make_mp(), tracking_horizon=rt_horizon,
                      n_tracking_hour=n_tracking_hour, max_iter=120, device=CPU)
    projection = Tracker(tracking_model_object=make_mp(), tracking_horizon=da_horizon,
                         n_tracking_hour=n_tracking_hour, max_iter=120, device=CPU)
    return DoubleLoopCoordinator(bidder, tracker, projection)


def _run_day(coord, date, pushes_per_day, n_hr):
    coord.request_da_bids(date)
    for k in range(pushes_per_day):
        hour = k * n_hr
        bids = coord.request_rt_bids(date, hour)
        coord.push_rt_dispatch(date, hour, bids[0]["4_WIND"]["p_max"], {"4": 27.0})


def test_double_loop_steady_state_no_recompiles():
    """tests/test_analysis.py's acceptance on the port: after a 1-day
    warm-up, two more co-sim days (a DA bid solve, 12 RT bid solves and
    12 tracking solves each) build no program — one build per solver
    callable over the 3 days; the projection tracker stays cold."""
    n_hr = 2
    coord = _wind_battery_coordinator(n_tracking_hour=n_hr)
    pushes = coord._pushes_per_day
    assert pushes == 12
    dates = [f"2020-07-1{k}" for k in range(3)]
    _run_day(coord, dates[0], pushes, n_hr)
    counters = [coord.bidder.day_ahead_model.solve._graft_counter,
                coord.bidder.real_time_model.solve._graft_counter,
                coord.tracker._solve._graft_counter]
    assert [c.count for c in counters] == [1, 1, 1]
    with assert_no_recompiles():
        for date in dates[1:]:
            _run_day(coord, date, pushes, n_hr)
    assert [c.count for c in counters] == [1, 1, 1]
    assert coord.projection_tracker._solve._graft_counter.count == 0
    assert len(coord.tracker.implemented_stats) == 3 * pushes
    assert coord.bidder.day_ahead_model._time_idx == 3 * 24


# ---------------------------------------------------------------------------
# import isolation
# ---------------------------------------------------------------------------


def test_import_leaves_jax_out():
    code = ("import sys, runpy\n"
            "import dispatches_tpu_torch.analysis\n"
            "import dispatches_tpu_torch.analysis.__main__\n"
            "import chip_smoke\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
            "             or m == 'dispatches_tpu' or m.startswith('dispatches_tpu.'))\n"
            "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
