"""Shared building blocks for unit models (counterpart of
``dispatches_tpu/models/base.py``).

A material stream is a :class:`StateBundle`: time-indexed vars
(flow_mol, temperature, pressure, and component flows for mixtures) plus
a Port, with property evaluations as pure functions in residuals.
"""

from __future__ import annotations

from typing import Optional

import torch

from dispatches_tpu_torch.core.graph import Port, UnitModel
from dispatches_tpu_torch.properties.ideal_gas import IdealGasPackage


class StateBundle:
    """Material-stream state vars + port for a unit model.

    For a single-component package the state is FTPx-degenerate:
    (flow_mol, T, P).  For mixtures, component molar flows
    ``flow_mol_comp`` are primary (balances stay linear) and total flow
    is tied by an equality.
    """

    def __init__(
        self,
        unit: UnitModel,
        local: str,
        props: IdealGasPackage,
        port: bool = True,
    ):
        self.unit = unit
        self.local = local
        self.props = props
        fs = unit.fs
        T = fs.horizon

        flo, fi, fhi = props.flow_bounds
        tlo, ti, thi = props.temperature_bounds
        plo, pi, phi = props.pressure_bounds

        self.flow_mol = unit.add_var(
            f"{local}.flow_mol", lb=flo, ub=fhi, init=fi, scale=max(fi, 1.0)
        )
        self.temperature = unit.add_var(
            f"{local}.temperature", lb=tlo, ub=thi, init=ti, scale=100.0
        )
        self.pressure = unit.add_var(
            f"{local}.pressure", lb=plo, ub=phi, init=pi, scale=1e5
        )

        members = {
            "flow_mol": self.flow_mol,
            "temperature": self.temperature,
            "pressure": self.pressure,
        }

        if props.n_comp > 1:
            self.flow_mol_comp = unit.add_var(
                f"{local}.flow_mol_comp",
                shape=(T, props.n_comp),
                lb=0.0,
                ub=fhi,
                init=fi / props.n_comp,
                scale=max(fi, 1.0),
            )
            unit.add_eq(
                f"{local}.flow_sum",
                lambda v, p, fc=self.flow_mol_comp, f=self.flow_mol: (
                    torch.sum(v[fc], dim=-1) - v[f]
                ),
            )
            members["flow_mol_comp"] = self.flow_mol_comp
        else:
            self.flow_mol_comp = None

        self.port: Optional[Port] = (
            unit.add_port(local, members) if port else None
        )

    # ---- property evaluations inside residuals -----------------------

    def y(self, v):
        """Mole fractions (T, C), guarded for zero total flow."""
        if self.flow_mol_comp is None:
            return None
        f = torch.clamp(v[self.flow_mol][..., None], min=1e-12)
        return v[self.flow_mol_comp] / f

    def enth_mol(self, v):
        """Molar enthalpy h(T, y), J/mol (relative to 298.15 K)."""
        return self.props.enth_mol(v[self.temperature], self.y(v))

    def entr_mol(self, v):
        """Molar entropy s(T, P, y), J/mol/K."""
        return self.props.entr_mol(v[self.temperature], v[self.pressure], self.y(v))

    def total_enthalpy(self, v):
        """Enthalpy flow, J/s."""
        return v[self.flow_mol] * self.enth_mol(v)

    def fix_state(self, flow_mol=None, temperature=None, pressure=None):
        fs = self.unit.fs
        if flow_mol is not None:
            fs.fix(self.flow_mol, flow_mol)
        if temperature is not None:
            fs.fix(self.temperature, temperature)
        if pressure is not None:
            fs.fix(self.pressure, pressure)
