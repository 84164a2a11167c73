"""Wire transport + RPC for the multi-process fleet tier (counterpart of
``dispatches_tpu/net/``).

* :mod:`~dispatches_tpu_torch.net.wire` — length-prefixed framed messages
  with the bitwise pytree payload codec;
* :mod:`~dispatches_tpu_torch.net.rpc` — request/response RPC with per-call
  deadlines, retry/backoff, and ``net.*`` fault sites;
* :mod:`~dispatches_tpu_torch.net.worker` — the
  ``python -m dispatches_tpu_torch.net --worker [--device cpu|cuda]``
  process hosting a real SolveService behind the RPC server.

Heavy imports (the worker pulls in the serve stack and torch) stay out
of this package init; import the submodule you need.
"""
