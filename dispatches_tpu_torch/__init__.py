"""PyTorch/CUDA port of ``dispatches_tpu`` for NVIDIA Hopper (H100).

The JAX package ``dispatches_tpu`` stays the reference; this package
mirrors its module paths so each counterpart is found by name.  It
imports ``torch``, numpy and scipy only — never JAX and never
``dispatches_tpu`` (importing that package would switch JAX's x64 mode
and compile cache on as a side effect).

Device rule: the entry points (``make_lp_data``, the PDLP and IPM solver
builders, ``detect_time_structure``, ``make_structured_kkt``,
``SolverFactory``, ``wind_battery_optimize``,
``wind_battery_pem_optimize``, ``wind_battery_pem_tank_turb_optimize``,
``entry.entry``, ``ne_price_taker_optimize``, the grid layer's
``Tracker``/``Bidder``/``SelfScheduler``/``MarketSimulator`` and
``run_double_loop`` (``--device``),
``SolveService``, ``ExecutionPlan`` via ``PlanOptions.device``,
``learn.fit``, ``sweep.run_sweep`` (its own plan or service; a caller's
``plan=``/``service=`` brings its own device), ``train_revenue_surrogate``,
``TrainNNSurrogates`` (``predict`` too), ``_train_mlp`` and ``mlp_apply``
given numpy, ``kmeans_fit``, ``kmeans_fit_softdtw``,
``RavenARMAROM.train_from_artifact``, ``ARMAModel.sample``,
``generate_syn_realizations`` and the cash-flow functions given numpy) run on ``cuda`` unless the caller
passes ``device="cpu"``;
with no card and no ``device=`` they raise instead of carrying on quietly
on the CPU.

Ported so far: the wind+battery batch-PDLP main path (flowsheet graph
and lowering, the wind/splitter/battery models, the price-taker case
study, LP data extraction and preconditioning, the batch PDLP solver and
its two PDHG sweep kernels in ``csrc/pdhg_sweep.cu``); the interior-point
path (the IPM with its dense and structured KKT solves,
``wind_battery_optimize`` and ``entry``); the PDLP solver with an
optional lane axis and ``SolverFactory``; the serve path (``serve``,
``plan``, ``learn``, ``obs``, ``faults``); the hydrogen hybrid (the
ideal-gas and H2-combustion property packages, the PEM electrolyzer,
simple and detailed hydrogen tanks, translator, mixer, hydrogen turbine
and PV models, every ``create_model`` branch, the unit ``report()``
tables, ``wind_battery_pem_optimize`` and
``wind_battery_pem_tank_turb_optimize``); the double loop (``core/
config.py``, ``core/stacked.py``, ``grid/`` — model data, forecasters,
tracker, bidders, coordinator, the RUC/SCED market and its readers —
``MultiPeriodWindBattery`` and ``run_double_loop``), the nuclear case
study (``case_studies/nuclear``); and the design-space sweep engine with
its result store, CLI and sweep->surrogate handoff (``sweep/``), the
market-surrogate workflow (``workflow/``: clustering with soft-DTW, the
surrogate MLPs and the six shipped surrogates, ``SimulationData``,
``ManagedWorkflow``), cash flows and synthetic histories (``utils/``).
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
