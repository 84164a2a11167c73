"""Unit models of the port (counterpart of ``dispatches_tpu.models``):
the wind, PV, battery, splitter, PEM electrolyzer, simple and detailed
hydrogen tanks, translator, mixer and hydrogen turbine, the IAPWS-95
steam-cycle units (``steam_cycle``), the molten-salt / steam heat
exchanger (``salt_hx``), the concrete thermal-energy storage
(``concrete_tes``) and the tube-side heat exchanger against a wall
profile (``heat_exchanger_tube``)."""

from dispatches_tpu_torch.models.base import StateBundle
from dispatches_tpu_torch.models.battery import BatteryStorage
from dispatches_tpu_torch.models.concrete_tes import ConcreteTES
from dispatches_tpu_torch.models.elec_splitter import ElectricalSplitter
from dispatches_tpu_torch.models.heat_exchanger_tube import ConcreteTubeSide
from dispatches_tpu_torch.models.hydrogen_tank import HydrogenTank
from dispatches_tpu_torch.models.hydrogen_tank_simplified import SimpleHydrogenTank
from dispatches_tpu_torch.models.hydrogen_turbine import HydrogenTurbine
from dispatches_tpu_torch.models.mixer import Mixer
from dispatches_tpu_torch.models.pem_electrolyzer import PEMElectrolyzer
from dispatches_tpu_torch.models.salt_hx import HXGeometry, SaltSteamHX
from dispatches_tpu_torch.models.solar_pv import SolarPV
from dispatches_tpu_torch.models.translator import Translator
from dispatches_tpu_torch.models.wind_power import (
    WindPower,
    atb2018_capacity_factors,
    sam_pdf_capacity_factors,
    sam_weibull_capacity_factors,
    sam_windpower_capacity_factors,
)

__all__ = [
    "Translator",
    "Mixer",
    "StateBundle",
    "BatteryStorage",
    "ElectricalSplitter",
    "WindPower",
    "atb2018_capacity_factors",
    "sam_pdf_capacity_factors",
    "sam_weibull_capacity_factors",
    "sam_windpower_capacity_factors",
    "SolarPV",
    "PEMElectrolyzer",
    "SimpleHydrogenTank",
    "HydrogenTank",
    "HydrogenTurbine",
    "HXGeometry",
    "SaltSteamHX",
    "ConcreteTubeSide",
    "ConcreteTES",
]
