"""Fossil case study of the port (counterpart of
``dispatches_tpu.case_studies.fossil``): the ultra-supercritical
pulverized-coal plant (``usc_plant``), the plant integrated with
molten-salt storage (``storage_integrated``), its multiperiod
price-taker (``storage_multiperiod``), its double-loop participant
(``multiperiod_double_loop``), the charge and discharge storage design
studies (``storage_charge_design``, ``storage_discharge_design``) and
the 692 MW supercritical plant with the concrete TES (``scpc_plant``)."""

from dispatches_tpu_torch.case_studies.fossil.usc_plant import (  # noqa: F401
    build_plant_model,
    initialize,
    model_analysis,
    solve_plant,
)
from dispatches_tpu_torch.case_studies.fossil.storage_multiperiod import (  # noqa: F401
    MultiPeriodUscModel,
    create_multiperiod_usc_model,
    run_pricetaker_analysis,
)
from dispatches_tpu_torch.case_studies.fossil.multiperiod_double_loop import (  # noqa: F401
    MultiPeriodUsc,
    UscSelfScheduler,
    UscTracker,
)
from dispatches_tpu_torch.case_studies.fossil.scpc_plant import (  # noqa: F401
    ScpcModel,
    build_scpc_flowsheet,
    unfix_dof_for_optimization,
)
