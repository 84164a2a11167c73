"""The PyTorch port's cost cards (``dispatches_tpu_torch.obs.profile``) held
to the JAX package's ``obs.profile`` on the CPU.

The JAX package takes a card from XLA's AOT artifact at each compile;
the port takes it around the first call of each new argument signature
of a plan program.  On tests/test_obs.py's small serve workload (6
requests, ``max_batch`` 4, so lane counts 4 and 2) in both packages:

- the same program labels carry cards, with the same counts (one per
  signature), the same ``backend`` and argument shapes, and the JAX
  card's keys where the port can count them (``label``, ``count``,
  ``backend``, ``shapes``, ``argument_bytes``, ``output_bytes``,
  ``flops``); ``service.metrics()["cost_cards"]`` names the same buckets.
  The flops differ by design: the port counts the matmuls of every
  iteration its first call ran, XLA's estimate counts a loop body once;
- the admission estimate's card prior is set before the first dispatch
  completes, from the card's ``flops`` over the nominal peak of its
  backend;
- with the flag off, programs take the plain call path, no card is
  recorded, and the results are bitwise those of a profiled run.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.obs import profile as jprofile  # noqa: E402
from dispatches_tpu.obs import trace as jtrace  # noqa: E402
from dispatches_tpu.serve import ServeOptions as JServeOptions  # noqa: E402
from dispatches_tpu.serve import SolveService as JSolveService  # noqa: E402
from dispatches_tpu.serve.__main__ import _arbitrage_nlp as j_arbitrage  # noqa: E402

from dispatches_tpu_torch.obs import profile as tprofile  # noqa: E402
from dispatches_tpu_torch.obs import trace as ttrace  # noqa: E402
from dispatches_tpu_torch.plan import execution as texec  # noqa: E402
from dispatches_tpu_torch.serve import ServeOptions, SolveService  # noqa: E402
from dispatches_tpu_torch.serve import admission as tadmission  # noqa: E402
from dispatches_tpu_torch.serve.__main__ import _arbitrage_nlp as t_arbitrage  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _profiling_restored(monkeypatch):
    """The flag is process-wide in both packages: restore it after."""
    for prof, tr in ((jprofile, jtrace), (tprofile, ttrace)):
        monkeypatch.setattr(prof, "_ENABLED", prof._ENABLED)
        monkeypatch.setattr(tr, "_SPAN_HOOK", tr._SPAN_HOOK)
        prof.reset()
    yield
    jprofile.reset()
    tprofile.reset()


def _workload(n_requests=6, horizon=6):
    rng = np.random.default_rng(0)
    return [30.0 + 10.0 * rng.standard_normal(horizon) for _ in range(n_requests)]


def _serve(pkg, prices, horizon=6, max_batch=4):
    if pkg == "jax":
        service = JSolveService(JServeOptions(max_batch=max_batch, max_wait_ms=1e9))
        nlp = j_arbitrage(horizon)
    else:
        service = SolveService(ServeOptions(max_batch=max_batch, max_wait_ms=1e9),
                               device=CPU)
        nlp = t_arbitrage(horizon)
    defaults = nlp.default_params()
    handles = [service.submit(nlp, {"p": {**defaults["p"], "price": p},
                                    "fixed": defaults["fixed"]}, solver="pdlp")
               for p in prices]
    service.flush_all()
    results = [h.result() for h in handles]
    assert all(r.status == "DONE" for r in results)
    return service, results


def test_cards_match_jax_for_the_same_labels():
    jprofile.enable(True)
    tprofile.enable(True)
    prices = _workload()
    jsvc, _ = _serve("jax", prices)
    tsvc, _ = _serve("torch", prices)
    jcards, tcards = jprofile.cards_for("serve."), tprofile.cards_for("serve.")
    assert sorted((c["label"], c["count"]) for c in tcards) == \
        sorted((c["label"], c["count"]) for c in jcards)
    assert len(tcards) == 2  # lane counts 4 and 2
    by_key = {(c["label"], c["count"]): c for c in jcards}
    for card in tcards:
        want = by_key[(card["label"], card["count"])]
        assert card["backend"] == want["backend"] == "cpu"
        assert card["shapes"] == want["shapes"]
        assert set(card) - {"first_call_ms"} <= set(want), set(card) - set(want)
        assert card["flops"] > 0 and card["argument_bytes"] > 0 and card["output_bytes"] > 0
        print(f"{card['label']}#{card['count']}: flops {card['flops']:.0f} (XLA "
              f"{want['flops']:.0f}), argument bytes {card['argument_bytes']} (XLA "
              f"{want['argument_bytes']}), output bytes {card['output_bytes']} (XLA "
              f"{want['output_bytes']})")
    assert set(tsvc.metrics()["cost_cards"]) == set(jsvc.metrics()["cost_cards"]) == {"pdlp#0"}
    assert [b.compiles for b in tsvc._buckets.values()] == \
        [b.compiles for b in jsvc._buckets.values()]
    insts = [e for e in ttrace.events() if e["name"] == "compile.cost"]
    assert insts == [] or len(insts) == 2  # instants only when tracing is on


def test_admission_prior_before_the_first_dispatch_completes(monkeypatch):
    tprofile.enable(True)
    seen = []
    observe = tadmission.ServiceTimeEstimate.observe_ms

    def spy(self, ms):
        if self.samples == 0:  # the first dispatch just completed
            seen.append((self.estimate_ms(), self._card_prior_ms()))
        observe(self, ms)

    monkeypatch.setattr(tadmission.ServiceTimeEstimate, "observe_ms", spy)
    svc, _ = _serve("torch", _workload())
    (est, prior), = seen
    assert prior is not None and est == prior > 0
    # the newest card when the first dispatch completed: the 4-lane one
    card = next(c for c in tprofile.cards_for("serve.pdlp#0") if c["count"] == 1)
    peak_flops, _ = tadmission._NOMINAL_PEAKS["cpu"]
    assert prior == card["flops"] / peak_flops * 1e3
    assert tadmission._NOMINAL_PEAKS["gpu"] == (67e12, 3.35e12)
    # off: no prior, and the estimate waits for a measured dispatch
    tprofile.enable(False)
    assert tadmission.ServiceTimeEstimate("pdlp#0").estimate_ms() is None


def test_flag_off_changes_nothing(monkeypatch):
    tprofile.enable(False)
    calls = []
    prices = _workload()
    with monkeypatch.context() as m:
        m.setattr(tprofile, "profiled_call", lambda *a, **k: calls.append(a))
        svc, off = _serve("torch", prices)
    assert calls == [] and tprofile.cost_cards() == []
    assert svc.metrics()["cost_cards"] == {}
    for b in svc._buckets.values():
        assert b.program._run.__func__ is texec.PlanProgram._run_plain
    tprofile.enable(True)
    svc_on, on = _serve("torch", prices)
    assert all(b.program._run.__func__ is texec.PlanProgram._run_profiled
               for b in svc_on._buckets.values())
    for a, b in zip(off, on):
        assert torch.equal(torch.as_tensor(a.result.obj), torch.as_tensor(b.result.obj))
        assert torch.equal(torch.as_tensor(a.result.x), torch.as_tensor(b.result.x))
    assert tprofile.sample_memory() == {}  # no CUDA in this process
