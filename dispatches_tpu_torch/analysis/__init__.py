"""Flags and runtime sanitizers of the port (``dispatches_tpu.analysis``
counterpart; the lint passes are not ported yet)."""

from dispatches_tpu_torch.analysis.flags import flag_enabled, flag_name
from dispatches_tpu_torch.analysis.runtime import (
    SanitizeWarning,
    drain_sanitize_events,
    nan_guard,
    sanitize_enabled,
)

__all__ = [
    "SanitizeWarning",
    "drain_sanitize_events",
    "flag_enabled",
    "flag_name",
    "nan_guard",
    "sanitize_enabled",
]
