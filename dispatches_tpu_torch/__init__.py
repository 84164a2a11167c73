"""PyTorch/CUDA port of ``dispatches_tpu`` for NVIDIA Hopper (H100).

The JAX package ``dispatches_tpu`` stays the reference; this package
mirrors its module paths so each counterpart is found by name.  It
imports ``torch``, numpy and scipy only — never JAX and never
``dispatches_tpu`` (importing that package would switch JAX's x64 mode
and compile cache on as a side effect).

Device rule: the entry points (``make_lp_data``, the PDLP and IPM solver
builders, ``detect_time_structure``, ``make_structured_kkt``,
``SolverFactory``, ``wind_battery_optimize``, ``entry.entry``) run on
``cuda`` unless the caller passes ``device="cpu"``; with no card and no
``device=`` they raise instead of carrying on quietly on the CPU.

Ported so far: the wind+battery batch-PDLP main path (flowsheet graph
and lowering, the wind/splitter/battery models, the price-taker case
study, LP data extraction and preconditioning, the batch PDLP solver and
its two PDHG sweep kernels in ``csrc/pdhg_sweep.cu``); the interior-point
path (the IPM with its dense and structured KKT solves,
``wind_battery_optimize`` and ``entry``); the per-scenario PDLP solver
and ``SolverFactory``.
"""

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda``.  Raises when CUDA is asked for (explicitly or by default)
    and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "dispatches_tpu_torch runs on cuda by default and no CUDA device "
            "is available; pass device='cpu' to run on the CPU"
        )
    return dev
