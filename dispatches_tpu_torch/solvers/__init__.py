"""LP solvers of the port: PDLP data extraction and the batch PDLP
solver.  The IPM, the per-scenario PDLP solver and the solver factory
are not ported yet."""

from dispatches_tpu_torch.solvers.pdlp import (
    LPResult,
    PDLPOptions,
    START_COLD,
    START_EXACT,
    START_NEIGHBOR,
    START_PREDICTED,
    make_lp_data,
    resolve_pdlp_algorithm,
    resolve_pdlp_precision,
    resolve_pdlp_refine_rounds,
)
from dispatches_tpu_torch.solvers.pdlp_batch import (
    BatchPDLPOptions,
    make_pdlp_batch_solver,
)

__all__ = [
    "BatchPDLPOptions",
    "LPResult",
    "PDLPOptions",
    "START_COLD",
    "START_EXACT",
    "START_NEIGHBOR",
    "START_PREDICTED",
    "make_lp_data",
    "make_pdlp_batch_solver",
    "resolve_pdlp_algorithm",
    "resolve_pdlp_precision",
    "resolve_pdlp_refine_rounds",
]
