"""Fossil case study of the port: the ultra-supercritical pulverized-coal
plant (counterpart of ``dispatches_tpu.case_studies.fossil``; the
molten-salt storage designs and the multiperiod models come later)."""

from dispatches_tpu_torch.case_studies.fossil.usc_plant import (  # noqa: F401
    build_plant_model,
    initialize,
    model_analysis,
    solve_plant,
)
