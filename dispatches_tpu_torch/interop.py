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
  params into the port's ``learn.predictor.forward`` weights.

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
