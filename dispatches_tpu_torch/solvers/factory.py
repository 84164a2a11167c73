"""SolverFactory-style entry point (counterpart of
``dispatches_tpu/solvers/factory.py``).

The factory hands out solver objects with a ``solve(nlp, params=...)``
method so reference-style drivers read like the reference's Pyomo code:
``SolverFactory("cbc")`` (LP) maps to the per-scenario PDLP solver with an
IPM fallback for non-affine models, ``SolverFactory("ipopt")`` (NLP) to
the interior-point solver.  Each solver object caches what it built per
(nlp, options), so a driver that calls ``solve()`` in a loop builds once
(the JAX package's ``graft_jit`` compile cache has no torch counterpart:
the cache of built solvers is what keeps "build once per nlp+options").

``device`` (a constructor argument, ``cuda`` unless given) is where every
solver this object builds runs.
"""

from __future__ import annotations

import weakref

from dispatches_tpu_torch import resolve_device
from dispatches_tpu_torch.solvers.ipm import IPMOptions, make_ipm_solver
from dispatches_tpu_torch.solvers.pdlp import (
    PDLPOptions,
    make_pdlp_solver,
    resolve_pdlp_algorithm,
    resolve_pdlp_precision,
)


class NLPKeyedCache:
    """``(nlp, frozen-options) -> value`` cache that is safe against
    ``id()`` reuse: each entry pins a weakref to its nlp, and a hit
    requires the referent to still BE the lookup object; a dead or
    swapped referent is a miss (and the stale entry is dropped)."""

    def __init__(self):
        self._entries = {}

    def get(self, nlp, key):
        entry = self._entries.get((id(nlp), key))
        if entry is None:
            return None
        ref, value = entry
        if ref() is not nlp:  # address reuse after GC: stale entry
            del self._entries[(id(nlp), key)]
            return None
        return value

    def set(self, nlp, key, value) -> None:
        self._entries[(id(nlp), key)] = (weakref.ref(nlp), value)

    def __len__(self) -> int:
        return len(self._entries)


def _ipm_tee(res, prec=None):
    head = f"[dispatches_tpu.ipm] precision={prec} " if prec else "[dispatches_tpu.ipm] "
    print(
        f"{head}iters={int(res.iterations)} "
        f"kkt_error={float(res.kkt_error):.3e} converged={bool(res.converged)} "
        f"status={int(res.status)} obj={float(res.obj):.8g}"
    )


class _IPMSolver:
    name = "ipm"

    def __init__(self, device=None, **options):
        self.device = resolve_device(device)
        self.options = options
        # (nlp, frozen options) -> (built solver, resolved precision)
        self._cache = NLPKeyedCache()

    def solve(self, nlp, params=None, x0=None, tee: bool = False, **opt_overrides):
        opts = dict(self.options)
        opts.update(opt_overrides)
        params = nlp.default_params() if params is None else params
        key = tuple(sorted(opts.items()))
        entry = self._cache.get(nlp, key)
        if entry is None:
            ipm_opts = IPMOptions(**opts)
            # resolved once, at build time (env override included), so
            # tee reports the precision the cached solver was built with
            entry = (make_ipm_solver(nlp, ipm_opts, device=self.device),
                     resolve_pdlp_precision(ipm_opts.precision))
            self._cache.set(nlp, key, entry)
        solver, prec = entry
        res = solver(params) if x0 is None else solver(params, x0)
        if tee:
            _ipm_tee(res, prec)
        return res


class _PDLPSolver:
    """LP path (the reference's CBC role).  Falls back to the IPM when the
    model's affinity probe fails, so reference-style drivers can call
    SolverFactory("cbc") without knowing whether their flowsheet is
    linear.  Options are split by name between the two solvers so e.g.
    ``kkt=`` (IPM-only) or ``dtype=`` (PDLP-only) survive whichever path
    runs."""

    name = "pdlp"

    _PDLP_FIELDS = set(PDLPOptions.__dataclass_fields__)
    _IPM_FIELDS = set(IPMOptions._fields)

    def __init__(self, device=None, **options):
        self.device = resolve_device(device)
        self.options = options
        # (nlp, frozen options) -> ("pdlp"|"ipm", built solver, meta)
        self._cache = NLPKeyedCache()

    def solve(self, nlp, params=None, x0=None, tee: bool = False, **opt_overrides):
        """``x0`` is honored only on the IPM fallback path: the PDLP path
        always cold-starts (flagged on ``tee``)."""
        opts = dict(self.options)
        opts.update(opt_overrides)
        params = nlp.default_params() if params is None else params
        key = tuple(sorted(opts.items()))
        kind_solver = self._cache.get(nlp, key)
        if kind_solver is None:
            lp_kw = {k: v for k, v in opts.items() if k in self._PDLP_FIELDS}
            lp_kw.setdefault("tol", 1e-8)
            lp_kw.setdefault("dtype", "float64")
            try:
                # resolved once, at build time, so tee reports the
                # algorithm/precision the cached solver runs
                algo = resolve_pdlp_algorithm(lp_kw.get("algorithm"))
                prec = resolve_pdlp_precision(lp_kw.get("precision"))
                kind_solver = (
                    "pdlp",
                    make_pdlp_solver(nlp, PDLPOptions(**lp_kw), device=self.device),
                    (algo, prec),
                )
            except ValueError:  # not affine: hand off to the NLP solver
                if tee:
                    print("[dispatches_tpu.pdlp] model not affine; using IPM")
                ipm_kw = {k: v for k, v in opts.items() if k in self._IPM_FIELDS}
                kind_solver = (
                    "ipm", make_ipm_solver(nlp, IPMOptions(**ipm_kw), device=self.device),
                    None)
            self._cache.set(nlp, key, kind_solver)
        kind, solver, meta = kind_solver
        if kind == "ipm":
            res = solver(params) if x0 is None else solver(params, x0)
            if tee:
                _ipm_tee(res)
            return res
        if x0 is not None and tee:
            print("[dispatches_tpu.pdlp] x0 ignored (PDHG cold start)")
        res = solver(params)
        if tee:
            algo, prec = meta
            print(
                f"[dispatches_tpu.pdlp] algo={algo} precision={prec} "
                f"iters={int(res.iters)} "
                f"refined={int(res.refined)} "
                f"pr={float(res.pr_err):.3e} du={float(res.du_err):.3e} "
                f"gap={float(res.gap):.3e} converged={bool(res.converged)} "
                f"obj={float(res.obj):.8g}"
            )
        return res


class _ServeSolver:
    """``SolverFactory("serve")``: the micro-batching solve service is not
    ported yet."""

    name = "serve"

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "SolverFactory('serve') needs the solve service, which is not "
            "ported yet (ROADMAP.md queue 1, item 8: serve and learn)"
        )


_REGISTRY = {
    "ipm": _IPMSolver,
    "pdlp": _PDLPSolver,
    "serve": _ServeSolver,
    # aliases so reference-style driver code ports verbatim: the
    # reference's LP workhorse (CBC) maps to the first-order LP solver,
    # its NLP workhorse (IPOPT) to the interior-point solver
    "ipopt": _IPMSolver,
    "cbc": _PDLPSolver,
}


def SolverFactory(name: str, **options):
    """A solver object by name (``ipopt``/``ipm``, ``cbc``/``pdlp``);
    ``options`` are solver options plus ``device``."""
    try:
        cls = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(
            f"unknown solver {name!r}; available: {sorted(_REGISTRY)}"
        ) from None
    return cls(**options)


def register_solver(name: str, cls) -> None:
    _REGISTRY[name.lower()] = cls
