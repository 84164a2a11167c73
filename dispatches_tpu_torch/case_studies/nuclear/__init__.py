"""Nuclear case study (counterpart of ``dispatches_tpu/case_studies/
nuclear``): nuclear plant + PEM + H2 tank + H2 turbine co-production, its
multiperiod price-taker and the ``MultiPeriodNuclear`` double-loop
protocol object."""

from dispatches_tpu_torch.case_studies.nuclear.flowsheet import (
    MW_H2,
    build_ne_flowsheet,
    fix_dof_and_initialize,
)
from dispatches_tpu_torch.case_studies.nuclear.multiperiod import (
    MultiPeriodNuclear,
    create_multiperiod_nuclear_model,
    ne_price_taker_optimize,
    unfix_dof,
)

__all__ = ["MW_H2", "build_ne_flowsheet", "fix_dof_and_initialize",
           "MultiPeriodNuclear", "create_multiperiod_nuclear_model",
           "ne_price_taker_optimize", "unfix_dof"]
