"""Unit models of the port: those the wind+battery main path uses.  The
other models of ``dispatches_tpu.models`` are not ported yet."""

from dispatches_tpu_torch.models.battery import BatteryStorage
from dispatches_tpu_torch.models.elec_splitter import ElectricalSplitter
from dispatches_tpu_torch.models.wind_power import (
    WindPower,
    atb2018_capacity_factors,
    sam_pdf_capacity_factors,
    sam_weibull_capacity_factors,
    sam_windpower_capacity_factors,
)

__all__ = [
    "BatteryStorage",
    "ElectricalSplitter",
    "WindPower",
    "atb2018_capacity_factors",
    "sam_pdf_capacity_factors",
    "sam_weibull_capacity_factors",
    "sam_windpower_capacity_factors",
]
