"""Renewables case study: the wind + battery price-taker (the PEM, tank,
turbine and double-loop studies are not ported yet)."""

from dispatches_tpu_torch.case_studies.renewables.flowsheet import create_model
from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import (
    PriceTakerResult,
    wind_battery_model,
    wind_battery_optimize,
    wind_battery_pricetaker_nlp,
)

__all__ = ["PriceTakerResult", "create_model", "wind_battery_model",
           "wind_battery_optimize", "wind_battery_pricetaker_nlp"]
