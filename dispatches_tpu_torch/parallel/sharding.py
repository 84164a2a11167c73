"""Scenario-batch sharding of solver sweeps over a device mesh
(counterpart of ``dispatches_tpu/parallel/sharding.py``).

A port mesh is a small class with the surface the JAX package's code
reads from a ``jax.sharding.Mesh``: ``devices`` (an array of devices),
``axis_names`` and ``shape[axis]``.  Its entries are torch devices, and
one device may be named more than once: a mesh of ``cuda:0`` four times
splits a batch into four lane shards that run one after another on that
card, the counterpart of the virtual CPU devices the JAX package's tests
force.  :func:`scenario_mesh` on ``cuda`` takes the first n visible cards.

:func:`scenario_sharded_solver` is a thin caller of
:class:`dispatches_tpu_torch.plan.ExecutionPlan`: it keeps the public
contract (key validation, mesh-multiple padding by repeating the last
scenario, pad trimming, ``full_result``, the ``options``/``solver``
conflicts) and delegates placement and dispatch to the plan.  Nothing the
caller passes is donated.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.solvers.ipm import IPMOptions, make_ipm_solver
from dispatches_tpu_torch.utils.tree import tree_leaves, tree_map

__all__ = ["Mesh", "scenario_mesh", "scenario_sharded_solver"]


def _device(dev) -> torch.device:
    """``dev`` as a torch device with its index filled in for CUDA, so
    ``cuda`` and ``cuda:0`` name one mesh entry."""
    d = torch.device(dev)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A 1-D device mesh: ``devices`` along one named axis.  Entries may
    repeat (see the module docstring)."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("scenario",)):
        devs = [_device(d) for d in devices]
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(tuple(axis_names)) != 1:
            raise ValueError("a port mesh has exactly one axis")
        self.devices = np.empty(len(devs), dtype=object)
        self.devices[:] = devs
        self.axis_names = tuple(axis_names)
        self.shape = {self.axis_names[0]: len(devs)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names})")


def scenario_mesh(n_devices: Optional[int] = None, axis: str = "scenario",
                  device=None) -> Mesh:
    """1-D mesh over the available devices (the scenario/data axis).

    On ``cuda`` (the default) the mesh takes the first ``n_devices``
    visible cards (all of them when None) and raises when fewer are
    visible; a mesh that names one card more than once is built with
    :class:`Mesh` directly.  On the CPU, which is one device, the mesh
    names it ``n_devices`` times."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        visible = torch.cuda.device_count()
        n = visible if n_devices is None else int(n_devices)
        if n > visible:
            raise ValueError(
                f"scenario_mesh({n}) needs {n} CUDA devices and {visible} "
                "are visible; name a device more than once with "
                "Mesh([...]) to split lanes on fewer cards")
        return Mesh([torch.device("cuda", i) for i in range(n)], axis_names=(axis,))
    return Mesh([dev] * (1 if n_devices is None else int(n_devices)),
                axis_names=(axis,))


def scenario_sharded_solver(
    nlp,
    mesh: Mesh,
    batched_keys: Sequence[str] = (),
    batched_fixed_keys: Sequence[str] = (),
    options: Optional[IPMOptions] = None,
    max_iter: Optional[int] = None,
    axis: str = "scenario",
    full_result: bool = False,
    solver=None,
    plan=None,
):
    """Build ``solve(batched) -> objs`` where ``batched`` maps param (or
    fixed-var) names to arrays with a leading scenario axis; that axis is
    split over ``mesh`` and each mesh entry runs its shard of solves.

    ``solver`` is any lane-batched ``callable(params) -> result`` with an
    ``.obj`` field (e.g. ``make_batch_pdlp_solver(nlp, ...)``), which runs
    on the device it was built for; by default an IPM is built from
    ``options`` / ``max_iter`` on each distinct device of the mesh.
    ``plan`` injects a caller-owned
    :class:`~dispatches_tpu_torch.plan.ExecutionPlan` (it must carry
    ``mesh``); None builds a non-donating plan around ``mesh``.

    Batches that do not divide the mesh size are padded by repeating the
    last scenario and the padding is trimmed from the result.  With
    ``full_result=True`` the solver's whole result tree is returned
    (leading axis = scenario) instead of just objectives.
    """
    if options is not None and max_iter is not None:
        raise ValueError("pass either options or max_iter, not both")
    if solver is None:
        opts = options or IPMOptions(max_iter=max_iter or 100)
        solvers = {}
        for d in mesh.devices:
            if d not in solvers:
                solvers[d] = make_ipm_solver(nlp, opts, device=d)

        def solver(params):
            # each shard runs on the IPM built for its own device
            dev = next((t.device for t in tree_leaves(params)
                        if isinstance(t, torch.Tensor)), mesh.devices[0])
            return solvers.get(_device(dev), solvers[mesh.devices[0]])(params)
    elif options is not None or max_iter is not None:
        raise ValueError(
            "options/max_iter configure the default IPM; when passing a "
            "prebuilt solver, configure it at construction instead"
        )

    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions

    xplan = plan if plan is not None else ExecutionPlan(
        PlanOptions(mesh=mesh, axis=axis, donate=False))

    defaults = nlp.default_params()
    in_axes_p = {k: (0 if k in batched_keys else None) for k in defaults["p"]}
    in_axes_f = {
        k: (0 if k in batched_fixed_keys else None) for k in defaults["fixed"]
    }
    kernel = solver if full_result else (lambda params: solver(params).obj)
    program = xplan.program(
        kernel, label="parallel.mesh",
        vmap_axes=({"p": in_axes_p, "fixed": in_axes_f},),
        donate_argnums=())

    n_dev = int(mesh.shape[axis])  # the batch axis only needs to divide
    # its own mesh dimension

    def solve(batched: Dict[str, np.ndarray]):
        declared = set(batched_keys) | set(batched_fixed_keys)
        sizes = set()
        for k, v in batched.items():
            shape = tuple(v.shape) if isinstance(v, torch.Tensor) else np.shape(v)
            if not shape:
                raise ValueError(
                    f"{k!r} must carry a leading scenario axis; got a "
                    "scalar"
                )
            sizes.add(shape[0])
        if len(sizes) > 1:
            raise ValueError(
                f"inconsistent scenario-batch sizes: {sorted(sizes)}"
            )
        if not sizes:
            raise ValueError(
                "batched is empty: pass at least one array with a leading "
                "scenario axis (a misspelled key would otherwise solve "
                "the defaults once per device)"
            )
        n_scen = sizes.pop()
        pad = (-n_scen) % n_dev
        lanes = n_scen + pad

        p = dict(defaults["p"])
        f = dict(defaults["fixed"])
        for k, vals in batched.items():
            if k not in declared:
                raise KeyError(
                    f"{k!r} was not declared in batched_keys at build time"
                )
            arr = (vals if isinstance(vals, torch.Tensor)
                   else torch.as_tensor(np.asarray(vals, dtype=np.float64)))
            if pad:  # repeat the last scenario to fill the mesh evenly
                arr = torch.cat([arr, arr[-1:].expand(pad, *arr.shape[1:])])
            if k in p:
                p[k] = arr
            elif k in f:
                f[k] = arr
            else:
                raise KeyError(f"unknown param/fixed var {k!r}")
        mask = {
            "p": {k: k in batched for k in p},
            "fixed": {k: k in batched for k in f},
        }
        staged = xplan.stage({"p": p, "fixed": f}, lanes=lanes,
                             donate=False, batched=mask)
        ticket = xplan.submit(program, (staged,),
                              n_live=n_scen, lanes=lanes)
        out = xplan.collect(ticket)
        if pad:
            out = tree_map(lambda a: a[:n_scen], out)
        return out

    return solve
