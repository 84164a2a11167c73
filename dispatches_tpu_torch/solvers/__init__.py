"""Solvers of the port: the interior-point NLP solver, the square-system
Newton solver (with a lane-batched form), the reduced-space solver, the
per-scenario and batch PDLP LP solvers, and the solver factory."""

from dispatches_tpu_torch.solvers.ipm import (
    IPMOptions,
    IPMResult,
    format_iteration_trace,
    make_ipm_solver,
    solve_nlp,
)
from dispatches_tpu_torch.solvers.newton import (
    NewtonOptions,
    NewtonResult,
    make_batched_newton_solver,
    make_newton_solver,
    solve_square,
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
from dispatches_tpu_torch.solvers.reduced import (
    BatchedReducedResult,
    BatchedReducedSpaceNLP,
    ReducedResult,
    ReducedSpaceNLP,
)
from dispatches_tpu_torch.solvers.factory import SolverFactory

__all__ = [
    "BatchPDLPOptions",
    "BatchedReducedResult",
    "BatchedReducedSpaceNLP",
    "IPMOptions",
    "IPMResult",
    "LPResult",
    "NewtonOptions",
    "NewtonResult",
    "PDLP_PRECISIONS",
    "PDLPOptions",
    "ReducedResult",
    "ReducedSpaceNLP",
    "START_COLD",
    "START_EXACT",
    "START_NEIGHBOR",
    "START_PREDICTED",
    "SolverFactory",
    "format_iteration_trace",
    "make_ipm_solver",
    "make_batched_newton_solver",
    "make_lp_data",
    "make_newton_solver",
    "make_pdlp_batch_solver",
    "make_pdlp_solver",
    "resolve_pdlp_algorithm",
    "resolve_pdlp_precision",
    "resolve_pdlp_refine_rounds",
    "solve_nlp",
    "solve_square",
]
