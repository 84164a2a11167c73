"""Electrical splitter unit model (counterpart of
``dispatches_tpu/models/elec_splitter.py``): one electricity inlet split
to N named outlets with a power balance and optional split-fraction
variables."""

from __future__ import annotations

from typing import List, Optional

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel


class ElectricalSplitter(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "splitter",
        outlet_list: Optional[List[str]] = None,
        num_outlets: Optional[int] = None,
        add_split_fraction_vars: bool = False,
    ):
        super().__init__(fs, name)
        if outlet_list is None:
            if not num_outlets:
                raise ValueError("provide outlet_list or num_outlets")
            outlet_list = [f"outlet_{i+1}" for i in range(num_outlets)]
        self.outlet_list = list(outlet_list)

        elec = self.add_var("electricity", lb=0, scale=1e3)
        self.add_port("electricity_in", {"electricity": elec})

        outs = []
        for o in self.outlet_list:
            ov = self.add_var(f"{o}_elec", lb=0, scale=1e3)
            outs.append(ov)
            self.add_port(f"{o}_port", {"electricity": ov})

        # power balance
        self.add_eq(
            "sum_split",
            lambda v, p, outs=tuple(outs): sum(v[o] for o in outs) - v[elec],
        )

        if add_split_fraction_vars:
            for o, ov in zip(self.outlet_list, outs):
                sf = self.add_var(f"split_fraction_{o}", lb=0.0, ub=1.0,
                                  init=1.0 / len(outs))
                self.add_eq(
                    f"split_fraction_definition_{o}",
                    lambda v, p, sf=sf, ov=ov: v[ov] - v[sf] * v[elec],
                )
