"""Workflow layer of the port (counterpart of ``dispatches_tpu.workflow``):
the market-surrogate training pipeline — ``SimulationData`` (sweep-output
parsing), ``TimeSeriesClustering`` (day-slice k-means and soft-DTW
k-means), ``TrainNNSurrogates`` (float64 torch MLPs trained with Adam) and
the shipped pre-trained surrogates — and the managed-data workflow.
"""

from dispatches_tpu_torch.workflow.simulation_data import SimulationData
from dispatches_tpu_torch.workflow.clustering import TimeSeriesClustering
from dispatches_tpu_torch.workflow.surrogates import (
    TrainNNSurrogates,
    load_pretrained_surrogate,
    pretrained_surrogates,
)
from dispatches_tpu_torch.workflow.managed import (
    Dataset,
    DatasetFactory,
    ManagedWorkflow,
)

__all__ = [
    "SimulationData",
    "TimeSeriesClustering",
    "TrainNNSurrogates",
    "load_pretrained_surrogate",
    "pretrained_surrogates",
    "ManagedWorkflow",
    "Dataset",
    "DatasetFactory",
]
