"""Generator model-data containers (counterpart of
``dispatches_tpu/grid/model_data.py``, a copy: the module is pure
Python).

Typed records of generator parameters handed to the bidder/tracker and
pushed into the market model by the coordinator.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict
from typing import List, Optional, Tuple


@dataclass
class GeneratorModelData:
    gen_name: str
    bus: str
    p_min: float
    p_max: float
    fixed_commitment: Optional[bool] = None

    @property
    def generator_type(self) -> str:
        raise NotImplementedError

    def to_dict(self) -> dict:
        d = asdict(self)
        d["generator_type"] = self.generator_type
        return d


@dataclass
class RenewableGeneratorModelData(GeneratorModelData):
    """Renewable (non-dispatchable cost) generator."""

    p_cost: float = 0.0

    @property
    def generator_type(self) -> str:
        return "renewable"


@dataclass
class ThermalGeneratorModelData(GeneratorModelData):
    """Thermal generator with UC attributes and piecewise cost curves."""

    min_down_time: float = 0.0
    min_up_time: float = 0.0
    ramp_up_60min: float = 1e6
    ramp_down_60min: float = 1e6
    shutdown_capacity: float = 1e6
    startup_capacity: float = 1e6
    initial_status: int = 1
    initial_p_output: float = 0.0
    production_cost_bid_pairs: List[Tuple[float, float]] = field(
        default_factory=list
    )
    startup_cost_pairs: List[Tuple[float, float]] = field(default_factory=list)

    @property
    def generator_type(self) -> str:
        return "thermal"
