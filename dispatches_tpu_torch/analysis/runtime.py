"""Runtime sanitizers: opt-in NaN/Inf guards on solver iterates.

Counterpart of the NaN-guard part of ``dispatches_tpu/analysis/
runtime.py``.  PyTorch runs eagerly, so where the JAX guard inserts a
host callback into the trace, this one checks the tensors directly — a
device sync per guard, paid only when ``DISPATCHES_TPU_SANITIZE`` is set.
"""

from __future__ import annotations

import threading
import warnings
from typing import List

import torch

from dispatches_tpu_torch.analysis.flags import flag_enabled

__all__ = [
    "SanitizeWarning",
    "drain_sanitize_events",
    "nan_guard",
    "sanitize_enabled",
]


class SanitizeWarning(UserWarning):
    """A nan_guard found a non-finite value."""


_lock = threading.Lock()
_EVENTS: List[str] = []


def sanitize_enabled() -> bool:
    """Whether nan_guard checks its tensors (DISPATCHES_TPU_SANITIZE)."""
    return flag_enabled("SANITIZE")


def _unwrapped(t: torch.Tensor) -> torch.Tensor:
    # inside torch.func.vmap/grad a tensor is a functorch wrapper, and
    # bool() on it would be data-dependent control flow; check the
    # underlying tensor (all lanes at once) instead
    while torch._C._functorch.is_functorch_wrapped_tensor(t):
        t = torch._C._functorch.get_unwrapped(t)
    return t


def nan_guard(label: str, *tensors) -> None:
    """Opt-in non-finite check on intermediate iterates.

    No-op unless DISPATCHES_TPU_SANITIZE is set.  When set, records
    ``label`` for ``drain_sanitize_events`` and warns if any tensor holds
    a NaN or Inf.  Safe inside ``torch.func`` transforms."""
    if not sanitize_enabled():
        return
    flat = [_unwrapped(t) for t in tensors if t is not None]
    if not flat or all(bool(torch.isfinite(t).all()) for t in flat):
        return
    with _lock:
        _EVENTS.append(label)
    warnings.warn(
        f"sanitize: non-finite value in '{label}'",
        SanitizeWarning,
        stacklevel=2,
    )


def drain_sanitize_events() -> List[str]:
    """Return and clear the labels recorded by nan_guard."""
    with _lock:
        out = list(_EVENTS)
        _EVENTS.clear()
    return out
