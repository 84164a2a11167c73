"""Flowsheet graph and its lowering to a flat NLP."""

from dispatches_tpu_torch.core.compile import CompiledNLP
from dispatches_tpu_torch.core.graph import Flowsheet, Port, UnitModel, VarSpec, tshift

__all__ = ["CompiledNLP", "Flowsheet", "Port", "UnitModel", "VarSpec", "tshift"]
