"""Where the f32 batch PDLP of the port parts from the JAX package's, on
the main path's scenarios: by rounding amplified by the f32 PDHG dynamics,
not by a dtype (its own file, beside tests/test_torch_pdlp_batch.py, so
that the parallel tier-1 run spreads the JAX compiles)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.case_studies.renewables.wind_battery_lmp import (  # noqa: E402
    wind_battery_pricetaker_nlp as j_pricetaker,
)
from dispatches_tpu.solvers.pdlp import make_lp_data as j_make_lp_data  # noqa: E402
from dispatches_tpu.solvers.pdlp_batch import (  # noqa: E402
    BatchPDLPOptions as JBatchOptions,
    make_pdlp_batch_solver as j_make_solver,
)

from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import (  # noqa: E402
    wind_battery_pricetaker_nlp as t_pricetaker,
)
from dispatches_tpu_torch.interop import lp_data_from_numpy  # noqa: E402
from dispatches_tpu_torch.solvers import BatchPDLPOptions, make_pdlp_batch_solver  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

T = 24


def test_f32_trajectories_part_by_rounding_not_by_dtype():
    """Where the f32 batch solvers of the two packages part, on the main
    path's scenarios (``chip_smoke.py``'s, the first 64 of its B = 366):
    every per-lane state leaf has the same dtype in both (no promotion);
    after the first check the best KKT errors are equal and the primal
    weights differ by a few float32 ulps (exp/log of the weight update);
    one check later the errors differ by ~1e-3, and a one-ulp nudge of the
    port's own weights at the first check moves them by the same order.
    So the packages part by rounding amplified by the f32 PDHG dynamics,
    not by a dtype."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from dispatches_tpu.solvers import pdlp_batch as jpb
    from dispatches_tpu_torch.solvers import pdlp_batch as tpb

    lmps, cfs = chip_smoke.scenarios(366, np.random.default_rng(0))
    lmps, cfs = lmps[:64], cfs[:64]
    pin = {"wind_mw": chip_smoke.WIND_MW, "batt_mw": chip_smoke.BATT_MW, "design_opt": False,
           "extant_wind": True, "capacity_factors": cfs[0], "DA_LMPs": lmps[0]}
    _, jn = j_pricetaker(T, pin)
    _, tn = t_pricetaker(T, pin)
    data = j_make_lp_data(jn)
    d = jn.default_params()
    keys = ("k", "stall", "e_b", "e_r", "omega", "done")
    opts = dict(tol=1e-5, dtype="float32")

    jrec = []
    orig = jax.lax.while_loop

    def while_loop(cond, body, init):
        if not (isinstance(init, dict) and "e_b" in init):
            return orig(cond, body, init)

        def body2(s):
            out = body(s)
            jax.debug.callback(lambda *v: jrec.append([np.array(a) for a in v]),
                               out["it"], *(out[k] for k in keys))
            return out
        return orig(cond, body2, init)

    jax.lax.while_loop = while_loop
    try:
        jax.jit(j_make_solver(jn, JBatchOptions(sweep="xla", **opts), lp_data=data))(
            {"p": {**d["p"], "lmp": jnp.asarray(lmps * 1e-3),
                   "windpower.capacity_factor": jnp.asarray(cfs)}, "fixed": d["fixed"]})
    finally:
        jax.lax.while_loop = orig
    jrec.sort(key=lambda r: int(r[0]))

    def port_run(nudge):
        rec = []

        def hook(it, s):
            if nudge and it == 40:
                s["omega"] = torch.nextafter(s["omega"], torch.full_like(s["omega"], 1e9))
            rec.append([np.array(it)] + [s[k].numpy().copy() for k in keys])

        tpb._CHECK_HOOK = hook
        try:
            make_pdlp_batch_solver(tn, BatchPDLPOptions(**opts), lp_data=lp_data_from_numpy(data),
                                   device="cpu")({"p": {**d["p"], "lmp": lmps * 1e-3,
                                                        "windpower.capacity_factor": cfs},
                                                  "fixed": d["fixed"]})
        finally:
            tpb._CHECK_HOOK = None
        return rec

    trec, nudged = port_run(False), port_run(True)
    assert [a.dtype for a in jrec[0][1:]] == [a.dtype for a in trec[0][1:]]
    assert trec[0][3].dtype == np.float32 and trec[0][5].dtype == np.float32

    def rel(a, b):
        return float(np.max(np.abs(a - b) / np.abs(b)))

    # check 0 (it 40): the same errors; weights a few ulps apart
    assert int(jrec[0][0]) == int(trec[0][0]) == 40
    assert rel(trec[0][3], jrec[0][3]) <= 1e-6
    assert 0.0 < rel(trec[0][5], jrec[0][5]) <= 4e-6
    # check 1: ~1e-3 apart, and one ulp of the port's own weights does as much
    part = rel(trec[1][3], jrec[1][3])
    self_part = rel(nudged[1][3], trec[1][3])
    print(f"f32 parting: omega after check 0 {rel(trec[0][5], jrec[0][5]):.3e} rel; best KKT "
          f"error after check 1: port vs JAX {part:.3e}, port vs port nudged 1 ulp {self_part:.3e}")
    assert part > 1e-5 and self_part > 0.1 * part
