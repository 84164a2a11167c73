"""Renewables case study: the wind + battery price-taker, the wind +
battery + PEM price-taker and the full hybrid (wind + battery + PEM +
hydrogen tank + hydrogen turbine) price-taker, and the double-loop market
study (``MultiPeriodWindBattery`` and ``run_double_loop``)."""

from dispatches_tpu_torch.case_studies.renewables.flowsheet import create_model
from dispatches_tpu_torch.case_studies.renewables.wind_battery_double_loop import (
    MultiPeriodWindBattery,
)
from dispatches_tpu_torch.case_studies.renewables.wind_battery_lmp import (
    PriceTakerResult,
    wind_battery_model,
    wind_battery_optimize,
    wind_battery_pricetaker_nlp,
)
from dispatches_tpu_torch.case_studies.renewables.wind_battery_pem_lmp import (
    wind_battery_pem_model,
    wind_battery_pem_optimize,
)
from dispatches_tpu_torch.case_studies.renewables.wind_battery_pem_tank_turbine_lmp import (
    wind_battery_pem_tank_turb_nlp,
    wind_battery_pem_tank_turb_optimize,
)

__all__ = ["MultiPeriodWindBattery", "PriceTakerResult", "create_model", "wind_battery_model",
           "wind_battery_optimize", "wind_battery_pricetaker_nlp",
           "wind_battery_pem_model", "wind_battery_pem_optimize",
           "wind_battery_pem_tank_turb_nlp", "wind_battery_pem_tank_turb_optimize"]
