"""Solar PV unit model (counterpart of ``dispatches_tpu/models/
solar_pv.py``): capacity factors are given directly and production is
bounded by ``system_capacity * capacity_factor[t]``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from dispatches_tpu_torch.core.graph import Flowsheet, UnitModel


class SolarPV(UnitModel):
    def __init__(
        self,
        fs: Flowsheet,
        name: str = "pv",
        capacity_factors: Sequence[float] = (),
    ):
        super().__init__(fs, name)
        cfs = np.asarray(capacity_factors, dtype=np.float64)[: fs.horizon]
        if cfs.shape != (fs.horizon,):
            raise ValueError(
                f"capacity factors must cover the horizon ({fs.horizon})"
            )

        cap = self.add_var("system_capacity", shape=(), lb=0, ub=1e8, scale=1e3)
        cf = self.add_param("capacity_factor", cfs)
        elec = self.add_var("electricity", lb=0, scale=1e3)

        self.add_ineq(
            "elec_from_capacity_factor",
            lambda v, p: v[elec] - v[cap] * p[cf],
        )

        self.add_port("electricity_out", {"electricity": elec})
