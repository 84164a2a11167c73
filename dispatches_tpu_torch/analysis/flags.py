"""Registry of the ``DISPATCHES_TPU_*`` environment flags the port reads.

The port keeps the JAX package's flag names, so one setting steers both
packages.  Only the flags this package reads are registered here; a
flag is added in the same change that reads it.  Stdlib only.
"""

from __future__ import annotations

import os

# name (without the DISPATCHES_TPU_ prefix) -> what setting it does
REGISTERED_FLAGS = {
    "SANITIZE": "enable runtime NaN/Inf guards on solver iterates "
    "(analysis.runtime.nan_guard; costs one device sync per guard)",
    "PDLP_ALGO": "override PDLPOptions.algorithm ('avg' | 'halpern') "
    "(solvers.pdlp.resolve_pdlp_algorithm; read at solver-build time)",
    "PDLP_PRECISION": "override PDLPOptions.precision ('f32' | "
    "'bf16x-f32' | 'f32-f64') (solvers.pdlp.resolve_pdlp_precision; "
    "read at solver-build time)",
    "PDLP_REFINE_ROUNDS": "override PDLPOptions.refine_rounds, the max "
    "high-tier refinement epochs after a low-precision PDLP solve "
    "(solvers.pdlp.resolve_pdlp_refine_rounds)",
}

_PREFIX = "DISPATCHES_TPU_"


def flag_name(short: str) -> str:
    """Full environment-variable name for a registered flag."""
    if short not in REGISTERED_FLAGS:
        raise KeyError(
            f"{_PREFIX}{short} is not registered in "
            "dispatches_tpu_torch.analysis.flags.REGISTERED_FLAGS"
        )
    return _PREFIX + short


def flag_enabled(short: str) -> bool:
    """Truthiness of a registered boolean flag ('' and '0' are off)."""
    val = os.environ.get(flag_name(short), "")
    return val not in ("", "0", "false", "False")
