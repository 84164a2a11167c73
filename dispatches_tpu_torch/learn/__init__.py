"""Learned warm starts (counterpart of ``dispatches_tpu.learn``): the MLP
head (``predictor``, with ``snap_to_bounds``) and its full-batch Adam fit
(also offline from a sweep store or a warm index) plus the serve-side
online trainer (``train``)."""

from dispatches_tpu_torch.learn.predictor import (  # noqa: F401
    StartPredictor,
    default_hidden,
    forward,
    init_params,
    predict_enabled,
    snap_to_bounds,
)
from dispatches_tpu_torch.learn.train import (  # noqa: F401
    OnlineTrainer,
    ReplayBuffer,
    default_refit_every,
    fit,
    fit_from_index,
    fit_from_store,
)

__all__ = [
    "OnlineTrainer",
    "ReplayBuffer",
    "StartPredictor",
    "default_hidden",
    "default_refit_every",
    "fit",
    "fit_from_index",
    "fit_from_store",
    "forward",
    "init_params",
    "predict_enabled",
    "snap_to_bounds",
]
