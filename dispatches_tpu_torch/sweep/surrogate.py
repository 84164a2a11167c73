"""Sweep -> surrogate handoff: train revenue MLPs straight off a finished
:class:`~.store.ResultStore` (counterpart of
``dispatches_tpu/sweep/surrogate.py``).

The store already holds both halves of a training set — design
coordinates (``inputs``) and objectives (``obj``, the revenue labels) —
so :class:`SweepData` adapts a store to the ``SimulationData`` surface
``workflow.surrogates.TrainNNSurrogates`` consumes (``_input_data_dict`` /
``_dispatch_dict`` / ``read_rev_data``) and the whole training path
(scaling metadata, held-out R2, model checkpointing) is reused unchanged.
Quarantined / non-finite points are filtered by
``ResultStore.training_data`` and never become labels.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from dispatches_tpu_torch.sweep.store import ResultStore

__all__ = ["SweepData", "train_revenue_surrogate"]


class SweepData:
    """``SimulationData``-shaped adapter over a finished sweep store."""

    def __init__(self, store: ResultStore):
        X, y = store.training_data()
        if len(y) == 0:
            raise ValueError(
                "sweep store holds no usable points (all quarantined?)")
        self.store = store
        self._input_data_dict = {i: X[i] for i in range(len(y))}
        # keys drive label/input alignment in TrainNNSurrogates; sweep
        # stores carry no dispatch profiles, only revenue labels
        self._dispatch_dict = {i: None for i in range(len(y))}
        self._revenues = {i: float(y[i]) for i in range(len(y))}

    def read_rev_data(self, _rev_path) -> dict:
        """Revenue labels from the sweep objectives (the ``data_file``
        argument is vestigial here — labels live in the store)."""
        return dict(self._revenues)


def train_revenue_surrogate(store: ResultStore,
                            NN_size: Optional[Sequence[int]] = None,
                            epochs: int = 500,
                            batch_size: Optional[int] = None,
                            mesh=None, device=None) -> Tuple[object, list]:
    """Train a revenue MLP on a finished sweep, on ``device`` (``cuda``
    unless given); returns ``(trainer, params)`` where ``trainer`` is the
    fitted ``TrainNNSurrogates`` (scaling metadata in ``_model_params``,
    ``save_model``/``predict`` available) and ``params`` the MLP weights
    in the JAX package's layout."""
    from dispatches_tpu_torch.workflow.surrogates import TrainNNSurrogates

    trainer = TrainNNSurrogates.from_sweep(store, device=device)
    d = len(store.input_names) or len(
        next(iter(trainer.simulation_data._input_data_dict.values())))
    size = list(NN_size) if NN_size is not None else [d, 32, 32, 1]
    params = trainer.train_NN_revenue(size, epochs=epochs,
                                      batch_size=batch_size, mesh=mesh)
    return trainer, params
