"""Flowsheets shared by the storage-chain parity tests
(``tests/test_torch_salt_hx.py``, ``test_torch_reduced.py``): each is
built the same way by the JAX package and by the port, from the module
set passed in, so the two compiled layouts are equal.

The salt heat-exchanger cases use the inlet conditions of the integrated
plant's initialization checkpoint (``tests/data/integrated_storage_usc_
init``): the charge HX condenses HP steam from reheater 1 against cold
solar salt, the discharge HX heats supercritical feedwater after the BFP
with hot salt.  ``_hx_sweep`` writes each unit's warm start.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np

from dispatches_tpu_torch.case_studies.fossil.storage_integrated import (
    HX_UNIT_CASES as HX_CASES,
)


def jax_modules():
    from dispatches_tpu.case_studies.fossil import storage_integrated as isp
    from dispatches_tpu.core.graph import Flowsheet
    from dispatches_tpu.models import salt_hx

    return SimpleNamespace(Flowsheet=Flowsheet, salt_hx=salt_hx, isp=isp)


def torch_modules():
    from dispatches_tpu_torch.case_studies.fossil import storage_integrated as isp
    from dispatches_tpu_torch.core.graph import Flowsheet
    from dispatches_tpu_torch.models import salt_hx

    return SimpleNamespace(Flowsheet=Flowsheet, salt_hx=salt_hx, isp=isp)


def hx_flowsheet(mods, case, film="inlet", F_salt=None, area=None, inits_from=None):
    """One salt HX with fixed water and salt inlets and area, warm-started
    by ``_hx_sweep``, or with the inits of the flowsheet ``inits_from``
    copied over (sweep_out None).  Returns ``(fs, hx, sweep_out)``."""
    side, w_in, w_out, steam, F0, T_in, A0 = HX_CASES[case]
    F_salt = F0 if F_salt is None else F_salt
    area = A0 if area is None else area
    fs = mods.Flowsheet(horizon=1)
    hx = mods.salt_hx.SaltSteamHX(fs, "hx", salt_side=side, water_in_phase=w_in,
                                  water_out_phase=w_out, water_film_phase=film)
    win, sin = hx.water_in, hx.salt_in
    fs.fix(win.flow_mol, steam["F"])
    fs.fix(win.enth_mol, steam["h"])
    fs.fix(win.pressure, steam["P"])
    fs.fix(sin.flow_mass, F_salt)
    fs.fix(sin.temperature, T_in)
    fs.fix(sin.pressure, 101325.0)
    fs.fix(hx.area, area)
    if inits_from is not None:
        for name, spec in inits_from.var_specs.items():
            fs.set_init(name, np.array(spec.init, dtype=np.float64))
        return fs, hx, None
    out = mods.isp._hx_sweep(fs, hx, dict(steam), F_salt, T_in, area,
                             water_hot=(side == "tube"))
    return fs, hx, out


def reduced_problem(mods, xp, inits_from=None):
    """The reduced-space test problem on the discharge HX: decisions the
    salt flow and the area (scaled 100 and 1e3), one outer inequality (the
    hot-end approach temperature at least 4.9 K, as ``add_bounds``), and
    an objective that prices the area and the salt flow's distance from
    180 kg/s against the water outlet temperature's distance from 830 K
    (an interior optimum near 212 kg/s and 1,477 m2).
    Returns ``(nlp, decisions)``."""
    fs, hx, _ = hx_flowsheet(mods, "discharge", inits_from=inits_from)
    Tw, A, F = hx.water_out.temperature, hx.area, hx.salt_in.flow_mass
    dTi = hx.delta_temperature_in
    fs.add_param("t_target", 830.0)
    fs.add_ineq("dTin_lo", lambda v, p: 4.9 - v[dTi], scale=1e-1)

    def objective(v, p):
        return (xp.sum((v[Tw] - p["t_target"]) ** 2) * 1e-2
                + (v[A] * 1e-3) ** 2 * 0.5
                + xp.sum((v[F] * 1e-2 - 1.8) ** 2) * 5.0)

    nlp = fs.compile(objective=objective, sense="min")
    return nlp, [F, A]


def layout(nlp):
    """Everything a compiled layout is: names, order, shapes, bounds,
    scales, fixed values, params and residual rows."""
    return {
        "free": list(nlp.free_names),
        "fixed": list(nlp.fixed_names),
        "slices": {k: (int(a), int(b), tuple(s)) for k, (a, b, s) in nlp._slices.items()},
        "scale": np.asarray(nlp.var_scale).tobytes(),
        "lb": np.asarray(nlp.lb).tobytes(),
        "ub": np.asarray(nlp.ub).tobytes(),
        "x0": np.asarray(nlp.x0).shape,
        "fixed_values": {k: np.asarray(v).tobytes()
                         for k, v in nlp.default_params()["fixed"].items()},
        "params": {k: np.asarray(v).tobytes() for k, v in nlp.default_params()["p"].items()},
        "eq": dict(nlp.eq_slices),
        "ineq": dict(nlp.ineq_slices),
    }
