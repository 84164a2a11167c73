"""Flags and runtime sanitizers of the port (``dispatches_tpu.analysis``
counterpart; the lint passes are not ported yet)."""

from dispatches_tpu_torch.analysis.flags import flag_enabled, flag_name
from dispatches_tpu_torch.analysis.runtime import (
    CountedProgram,
    LockOrderError,
    ProgramCounter,
    SanitizeWarning,
    drain_sanitize_events,
    lock_order_report,
    nan_guard,
    reset_lock_order,
    sanitize_enabled,
    sanitized_lock,
)

__all__ = [
    "CountedProgram",
    "LockOrderError",
    "ProgramCounter",
    "SanitizeWarning",
    "drain_sanitize_events",
    "flag_enabled",
    "flag_name",
    "lock_order_report",
    "nan_guard",
    "reset_lock_order",
    "sanitize_enabled",
    "sanitized_lock",
]
