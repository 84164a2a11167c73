"""Carry the JAX package's host-side state into the port.

Both packages keep their model parameters and LP data as numpy on the
host, so moving them across is a matter of types and devices:

* :func:`params_from_numpy` turns a ``nlp.default_params()``-shaped dict
  (numpy leaves, optionally batched) into tensors;
* :func:`lp_data_from_numpy` turns the JAX ``make_lp_data`` output
  (K, G, lb, ub) into the form the port's ``make_pdlp_batch_solver``
  takes as ``lp_data``;
* :func:`ipm_start_from_numpy` turns a JAX ``IPMResult``'s ``x_phys`` and
  ``lam`` into the port's IPM ``x0`` / ``lam0``;
* :func:`predictor_from_numpy` turns a JAX ``StartPredictor``'s numpy
  params into the port's ``learn.predictor.forward`` weights;
* :func:`x_from_numpy` carries a JAX ``CompiledNLP``'s decision vector
  into the port's, after checking that the two layouts are equal;
* :func:`u_from_numpy` does the same for the scaled decisions of a
  reduced-space NLP: a ``ReducedSpaceNLP``'s u, or a
  ``BatchedReducedSpaceNLP``'s (T, m_u) U (a JAX warm start such as a
  saved ``WARM_U`` or a solved ``U``).

Neither imports JAX: callers pass numpy arrays (``np.asarray`` of a JAX
array is one).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(params, device, dtype=torch.float64):
    """``params`` (nested dicts of numpy arrays or scalars) as tensors of
    ``dtype`` on ``device``, same structure."""
    if isinstance(params, dict):
        return {k: params_from_numpy(v, device, dtype) for k, v in params.items()}
    return torch.as_tensor(np.asarray(params), device=device).to(dtype)


def lp_data_from_numpy(data):
    """The JAX ``make_lp_data`` dict as float64 numpy arrays (the port's
    LP-data form)."""
    return {k: np.asarray(data[k], dtype=np.float64) for k in ("K", "G", "lb", "ub")}


def ipm_start_from_numpy(x_phys, lam, device):
    """An IPM warm start carried across: ``x_phys`` and ``lam`` of a JAX
    ``IPMResult`` (numpy, one row per lane or one vector) as the port's
    ``solve(params, x0, lam0)`` arguments, float64 on ``device``.
    ``x_phys`` is physical, as ``x0`` is (never feed ``IPMResult.x``)."""
    def t(a):
        # a copy: numpy views of JAX arrays are read-only
        return torch.tensor(np.array(a, dtype=np.float64), device=device)
    return t(x_phys), t(lam)


def predictor_from_numpy(params, device):
    """A JAX ``StartPredictor.params`` dict (numpy float32) as the port's
    predictor weights: float32 tensors on ``device``, same keys."""
    return {k: torch.tensor(np.array(v, dtype=np.float32), device=device)
            for k, v in params.items()}


def x_from_numpy(x, source_nlp, nlp, device):
    """A decision vector of ``source_nlp`` (a JAX ``CompiledNLP``: scaled,
    as its ``x0`` and a solver's ``x``) as ``nlp``'s, float64 on
    ``device``.  The two layouts must be equal — the same free variables in
    the same order, slices and scales — and then the vector carries over
    unchanged; a different layout raises ``ValueError``."""
    if list(source_nlp.free_names) != list(nlp.free_names):
        raise ValueError("the two NLPs have different free variables")
    if {k: tuple(v[:2]) for k, v in source_nlp._slices.items()} != \
            {k: tuple(v[:2]) for k, v in nlp._slices.items()}:
        raise ValueError("the two NLPs slice their decision vectors differently")
    if not np.array_equal(np.asarray(source_nlp.var_scale), nlp.var_scale):
        raise ValueError("the two NLPs scale their variables differently")
    x = np.array(x, dtype=np.float64)
    if x.shape != (nlp.n,):
        raise ValueError(f"x has shape {x.shape}, the NLP has n = {nlp.n}")
    return torch.tensor(x, device=device)



def _reduced_layout(rs):
    base = getattr(rs, "base", rs)
    return ([str(d) for d in base.decisions],
            {str(d): (int(a), int(b), tuple(shape), float(scale))
             for d, (a, b, shape, scale) in base._u_layout.items()},
            int(base.m_u))


def u_from_numpy(u, source_rs, rs, device):
    """Scaled decisions of ``source_rs`` (a JAX ``ReducedSpaceNLP`` or
    ``BatchedReducedSpaceNLP``: a u of shape (m_u,), or a U of shape
    (T, m_u) for a batched one) as ``rs``'s, float64 on ``device``.  The
    two must have the same decisions in the same order, slices and
    scales (and, batched, the same T); then the values carry over
    unchanged, and a different layout raises ``ValueError``."""
    sd, sl, sm = _reduced_layout(source_rs)
    dd, dl, dm = _reduced_layout(rs)
    if sd != dd:
        raise ValueError("the two reduced-space NLPs have different decisions")
    for d in dd:
        if sl[d][:3] != dl[d][:3]:
            raise ValueError(f"the two reduced-space NLPs slice decision {d!r} differently")
        if sl[d][3] != dl[d][3]:
            raise ValueError(f"the two reduced-space NLPs scale decision {d!r} differently")
    T = getattr(rs, "T", None)
    if T is not None and getattr(source_rs, "T", None) != T:
        raise ValueError("the two batched NLPs have different horizons")
    u = np.array(u, dtype=np.float64)
    want = (dm,) if T is None else (T, dm)
    if u.shape != want:
        raise ValueError(f"u has shape {u.shape}, the reduced-space NLP takes {want}")
    return torch.tensor(u, device=device)
