"""Utilities of the port: nested-container helpers (``tree``) and the
warm-start half of ``checkpoint``.  The cash-flow and synthetic-history
modules of ``dispatches_tpu.utils`` are not ported yet."""
