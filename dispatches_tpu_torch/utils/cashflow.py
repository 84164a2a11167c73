"""Cash-flow economics: NPV / IRR / PI with MACRS amortization
(counterpart of ``dispatches_tpu/utils/cashflow.py``).

The cash-flow algebra is plain float64 torch over a yearly cash array,
so it is differentiable and usable inside an optimization objective.
A function given a tensor runs on that tensor's device; given numpy (or
Python numbers) it runs on ``device`` — ``cuda`` unless the caller
passes ``device="cpu"`` (the port's device rule, ``resolve_device``).

Cash-flow model (TEAL conventions): capex at year 0 (optionally
amortized via MACRS depreciation with a tax shield), recurring yearly
revenues/costs over the project life, discounted at the WACC/discount
rate; IRR by damped Newton on the NPV polynomial.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from dispatches_tpu_torch import resolve_device

__all__ = ["MACRS", "CashFlowSettings", "Capex", "Recurring",
           "macrs_amortization", "build_cashflows", "npv", "irr",
           "profitability_index"]

#: IRS MACRS half-year-convention depreciation schedules (fractions)
MACRS = {
    3: [0.3333, 0.4445, 0.1481, 0.0741],
    5: [0.20, 0.32, 0.192, 0.1152, 0.1152, 0.0576],
    7: [0.1429, 0.2449, 0.1749, 0.1249, 0.0893, 0.0892, 0.0893, 0.0446],
    10: [0.10, 0.18, 0.144, 0.1152, 0.0922, 0.0737, 0.0655, 0.0655,
         0.0656, 0.0655, 0.0328],
    15: [0.05, 0.095, 0.0855, 0.077, 0.0693, 0.0623, 0.059, 0.059, 0.0591,
         0.059, 0.0591, 0.059, 0.0591, 0.059, 0.0591, 0.0295],
    20: [0.0375, 0.07219, 0.06677, 0.06177, 0.05713, 0.05285, 0.04888,
         0.04522, 0.04462, 0.04461, 0.04462, 0.04461, 0.04462, 0.04461,
         0.04462, 0.04461, 0.04462, 0.04461, 0.04462, 0.04461, 0.02231],
}


@dataclass
class CashFlowSettings:
    """Global economics settings (reference getSettings/TEAL settings)."""

    discount_rate: float = 0.08
    tax_rate: float = 0.0
    inflation: float = 0.0
    project_life: int = 30


@dataclass
class Capex:
    name: str
    amount: float  # $ at year 0 (positive cost)
    amortize_years: Optional[int] = None  # MACRS schedule key


@dataclass
class Recurring:
    name: str
    yearly_amount: float  # $ per year; positive = revenue, negative = cost


def _f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor: a tensor stays on its device, anything
    else lands on ``device`` (``cuda`` unless given)."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=resolve_device(device))


def macrs_amortization(amount, years: int, device=None) -> torch.Tensor:
    """Yearly depreciation amounts for a MACRS class (reference
    ``teal_integration.py`` MACRS handling)."""
    amount = _f64(amount, device)
    return amount * torch.as_tensor(MACRS[years], dtype=torch.float64,
                                    device=amount.device)


def build_cashflows(capex: Sequence[Capex], recurring: Sequence[Recurring],
                    settings: CashFlowSettings, device=None) -> torch.Tensor:
    """Yearly net cash array (year 0 .. project_life)."""
    n = settings.project_life
    cash = torch.zeros(n + 1, dtype=torch.float64, device=resolve_device(device))
    for cf in capex:
        cash[0] -= cf.amount
        if cf.amortize_years:
            dep = macrs_amortization(cf.amount, cf.amortize_years, cash.device)
            # tax shield of depreciation
            shield = settings.tax_rate * dep
            upto = min(len(dep), n)
            cash[1: upto + 1] += shield[:upto]
    for r in recurring:
        net = r.yearly_amount * (1.0 - settings.tax_rate) if r.yearly_amount > 0 \
            else r.yearly_amount
        cash[1:] += net
    return cash


def npv(cash, rate, device=None) -> torch.Tensor:
    """Net present value of a yearly cash array at ``rate``."""
    cash = _f64(cash, device)
    years = torch.arange(cash.shape[-1], dtype=torch.float64, device=cash.device)
    return torch.sum(cash / (1.0 + rate) ** years, dim=-1)


def irr(cash, guess: float = 0.1, iters: int = 60, device=None) -> torch.Tensor:
    """Internal rate of return via damped Newton on NPV(r) = 0 (the role
    of TEAL's IRR output): ``iters`` steps, the derivative by autograd,
    a zero step where it vanishes, the rate clipped to [-0.99, 10]."""
    cash = _f64(cash, device)
    r = torch.tensor(guess, dtype=torch.float64, device=cash.device)
    grad = torch.func.grad(lambda rr: npv(cash, rr))
    for _ in range(iters):
        f = npv(cash, r)
        df = grad(r)
        step = torch.where(torch.abs(df) > 1e-12, f / df, torch.zeros_like(f))
        r = torch.clamp(r - step, -0.99, 10.0)
    return r


def profitability_index(cash, rate, device=None) -> torch.Tensor:
    """PI = PV of in-flows (years >= 1) / |initial investment|."""
    cash = _f64(cash, device)
    years = torch.arange(1, cash.shape[-1], dtype=torch.float64, device=cash.device)
    pv = torch.sum(cash[1:] / (1.0 + rate) ** years)
    return pv / torch.abs(cash[0])
