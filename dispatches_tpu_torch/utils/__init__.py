"""Utilities of the port: nested-container helpers (``tree``), the
warm-start half of ``checkpoint``, cash-flow metrics (``cashflow``, the
TEAL counterpart) and ARMA synthetic histories (``synhist``, the RAVEN
counterpart)."""

from dispatches_tpu_torch.utils.cashflow import (
    CashFlowSettings,
    Capex,
    Recurring,
    build_cashflows,
    irr,
    macrs_amortization,
    npv,
    profitability_index,
)
from dispatches_tpu_torch.utils.synhist import (
    ARMAModel,
    RavenARMAROM,
    generate_clustered_realizations,
    generate_syn_realizations,
)

__all__ = [
    "CashFlowSettings",
    "Capex",
    "Recurring",
    "npv",
    "irr",
    "profitability_index",
    "macrs_amortization",
    "build_cashflows",
    "ARMAModel",
    "RavenARMAROM",
    "generate_clustered_realizations",
    "generate_syn_realizations",
]
