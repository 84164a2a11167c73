"""Entry point of the port: the scenario-batched IPM solve on the
flagship wind+battery price-taker (counterpart of ``entry()`` in the
repository's ``__graft_entry__.py``).

``entry(device=None)`` returns ``(fn, example_args)``: ``fn(batched)``
solves the IPM (``IPMOptions(max_iter=60)``, float64, the KKT path chosen
by ``kkt="auto"``) over the 8 LMP lanes of ``example_args`` and returns
the per-lane objectives.  ``dryrun_multichip(n_devices, device=None)`` is the
counterpart of the repository's multichip dry run: the same IPM over an
``n_devices``-entry scenario mesh.
"""

from __future__ import annotations

import numpy as np

from dispatches_tpu_torch import resolve_device


def _build_nlp(horizon=24):
    """The production price-taker program: the wind+battery flowsheet
    (Wind_Power + ElectricalSplitter + BatteryStorage units, periodic SoC,
    NPV objective) with the battery size fixed."""
    from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import (
        wind_battery_pricetaker_nlp,
    )

    rng = np.random.default_rng(7)
    params = {
        "wind_mw": 200.0,
        "batt_mw": 25.0,
        "design_opt": False,
        "extant_wind": True,
        "capacity_factors": 0.3 + 0.5 * rng.random(horizon),
        "DA_LMPs": 30.0 + 20.0 * np.sin(np.arange(horizon) / 24 * 2 * np.pi),
    }
    _, nlp = wind_battery_pricetaker_nlp(horizon, params)
    return nlp


def _lmp_batch(n_scenarios, horizon):
    """LMP lanes in $/kWh."""
    return 1e-3 * np.stack([
        np.abs(np.sin(np.arange(horizon) + s)) * 50 + 10
        for s in range(n_scenarios)
    ])


def entry(device=None):
    """(fn, example_args): the scenario-batched IPM solve of the
    wind+battery price-taker on ``device`` (``cuda`` unless given)."""
    from dispatches_tpu_torch.solvers import IPMOptions, make_ipm_solver

    dev = resolve_device(device)
    nlp = _build_nlp()
    solver = make_ipm_solver(nlp, IPMOptions(max_iter=60), device=dev)

    params = nlp.default_params()
    batched = {
        "p": {**params["p"], "lmp": _lmp_batch(8, 24)},
        "fixed": params["fixed"],
    }

    def fn(batched_params):
        return solver(batched_params).obj

    return fn, (batched,)


def dryrun_multichip(n_devices: int, device=None):
    """Split the scenario batch over an ``n_devices``-entry mesh and run
    one full solve (horizon 8, ``max_iter=60``), returning the per-lane
    objectives.

    2n+1 scenarios do not divide the mesh, so the pad/trim path runs.
    The mesh takes the first ``n_devices`` visible cards when that many
    are visible; with fewer (one H100), or on the CPU, its entries name
    ``device`` (``cuda:0`` unless given) ``n_devices`` times — the
    counterpart of the JAX dry run's virtual CPU devices."""
    import torch

    from dispatches_tpu_torch.parallel import Mesh, scenario_mesh, scenario_sharded_solver

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= n_devices:
        mesh = scenario_mesh(n_devices, device=dev)
    else:
        mesh = Mesh([dev] * n_devices, axis_names=("scenario",))
    nlp = _build_nlp(horizon=8)
    # odd count: exercises the uneven-batch pad/trim path
    n_scenarios = 2 * n_devices + 1
    solve = scenario_sharded_solver(nlp, mesh, batched_keys=("lmp",),
                                    max_iter=60)
    objs = solve({"lmp": _lmp_batch(n_scenarios, 8)})
    assert tuple(objs.shape) == (n_scenarios,)
    assert bool(torch.isfinite(objs).all())
    return objs
