"""Static analysis + runtime sanitizers of the port (counterpart of
``dispatches_tpu.analysis``).

Three halves share this package:

* ``graftlint`` — an AST pass (rules GL001-GL008) catching the patterns
  that silently cost a device sync, break a ``torch.func`` transform or
  change a dtype: host calls inside transformed functions, Python
  branches on their values, bad ``argnums``/``in_dims``, tensor
  construction and host reads in per-hour/per-day loops, constructors
  that fall back to float32, unregistered ``DISPATCHES_TPU_*`` flags,
  unsynchronized timing of asynchronous launches, and placement or
  program building outside the plan.  Run it with
  ``python -m dispatches_tpu_torch.analysis --check``.
* ``lockcheck`` — a second AST pass (rules GL009-GL012) enforcing the
  serve/plan/fleet/net lock discipline: no device/disk waits or
  reentrant sinks under a held lock, a cycle-free global
  acquisition-order graph, and consistently guarded fields.  Same CLI,
  same baseline.
* ``runtime`` — :class:`CountedProgram` (``graft_jit``'s counterpart:
  a solver callable with a program-build counter) with
  ``recompile_counts()``/``assert_no_recompiles()`` for steady-state
  tests, ``nan_guard`` and ``checkified`` (NaN checks, the first behind
  ``DISPATCHES_TPU_SANITIZE``), and ``sanitized_lock`` (the lock-order
  sanitizer behind the same flag — GL011's runtime counterpart).
"""

from dispatches_tpu_torch.analysis.flags import (
    REGISTERED_FLAGS,
    flag_enabled,
    flag_name,
)
from dispatches_tpu_torch.analysis.graftlint import (
    DEFAULT_BASELINE,
    RULES,
    Finding,
    lint_paths,
    lint_source,
    load_baseline,
    new_findings,
    write_baseline,
)
from dispatches_tpu_torch.analysis.lockcheck import (
    LOCKCHECK_RULES,
    check_paths,
    check_source,
)
from dispatches_tpu_torch.analysis.runtime import (
    CountedProgram,
    LockOrderError,
    ProgramCounter,
    RecompileWarning,
    SanitizedLock,
    SanitizeWarning,
    assert_no_recompiles,
    checkified,
    drain_sanitize_events,
    lock_order_report,
    nan_guard,
    recompile_counts,
    reset_lock_order,
    reset_recompile_counts,
    sanitize_enabled,
    sanitized_lock,
)
from dispatches_tpu_torch.analysis.selftest import CORPUS, run_selftest

__all__ = [
    "CORPUS",
    "CountedProgram",
    "DEFAULT_BASELINE",
    "Finding",
    "LOCKCHECK_RULES",
    "LockOrderError",
    "ProgramCounter",
    "REGISTERED_FLAGS",
    "RULES",
    "RecompileWarning",
    "SanitizeWarning",
    "SanitizedLock",
    "assert_no_recompiles",
    "check_paths",
    "check_source",
    "checkified",
    "drain_sanitize_events",
    "flag_enabled",
    "flag_name",
    "lint_paths",
    "lint_source",
    "load_baseline",
    "lock_order_report",
    "nan_guard",
    "new_findings",
    "recompile_counts",
    "reset_lock_order",
    "reset_recompile_counts",
    "run_selftest",
    "sanitize_enabled",
    "sanitized_lock",
    "write_baseline",
]
