"""Learned warm starts (counterpart of ``dispatches_tpu.learn``): the MLP
head (``predictor``) and its full-batch Adam fit plus the serve-side
online trainer (``train``)."""

from dispatches_tpu_torch.learn.predictor import (  # noqa: F401
    StartPredictor,
    default_hidden,
    forward,
    init_params,
    predict_enabled,
)
from dispatches_tpu_torch.learn.train import (  # noqa: F401
    OnlineTrainer,
    ReplayBuffer,
    default_refit_every,
    fit,
)

__all__ = [
    "OnlineTrainer",
    "ReplayBuffer",
    "StartPredictor",
    "default_hidden",
    "default_refit_every",
    "fit",
    "forward",
    "init_params",
    "predict_enabled",
]
