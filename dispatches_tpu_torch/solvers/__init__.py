"""Solvers of the port: the interior-point NLP solver, the per-scenario
and batch PDLP LP solvers, and the solver factory.  The Newton and
reduced-space solvers are not ported yet."""

from dispatches_tpu_torch.solvers.ipm import (
    IPMOptions,
    IPMResult,
    format_iteration_trace,
    make_ipm_solver,
    solve_nlp,
)
from dispatches_tpu_torch.solvers.pdlp import (
    PDLP_PRECISIONS,
    LPResult,
    PDLPOptions,
    START_COLD,
    START_EXACT,
    START_NEIGHBOR,
    START_PREDICTED,
    make_lp_data,
    make_pdlp_solver,
    resolve_pdlp_algorithm,
    resolve_pdlp_precision,
    resolve_pdlp_refine_rounds,
)
from dispatches_tpu_torch.solvers.pdlp_batch import (
    BatchPDLPOptions,
    make_pdlp_batch_solver,
)
from dispatches_tpu_torch.solvers.factory import SolverFactory

__all__ = [
    "BatchPDLPOptions",
    "IPMOptions",
    "IPMResult",
    "LPResult",
    "PDLP_PRECISIONS",
    "PDLPOptions",
    "START_COLD",
    "START_EXACT",
    "START_NEIGHBOR",
    "START_PREDICTED",
    "SolverFactory",
    "format_iteration_trace",
    "make_ipm_solver",
    "make_lp_data",
    "make_pdlp_batch_solver",
    "make_pdlp_solver",
    "resolve_pdlp_algorithm",
    "resolve_pdlp_precision",
    "resolve_pdlp_refine_rounds",
    "solve_nlp",
]
