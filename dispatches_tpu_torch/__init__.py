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
``generate_syn_realizations``, the cash-flow functions given numpy,
``solve_square``, ``make_newton_solver``, ``make_batched_newton_solver``,
``solve_plant``, ``model_analysis``, ``ReducedSpaceNLP``,
``BatchedReducedSpaceNLP``, the storage plant's ``main`` and
``model_analysis``, ``MultiPeriodUscModel``, ``run_pricetaker_analysis``,
``MultiPeriodUsc``, the supercritical plant's ``solve_plant``, and the
charge and discharge design studies' ``design_optimize`` and
``run_design_study``, ``parallel.scenario_mesh`` and
``entry.dryrun_multichip``) run on ``cuda`` unless the caller
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
``ManagedWorkflow``), cash flows and synthetic histories (``utils/``); and
serve durability (``serve/journal.py``, ``serve/snapshot.py``,
``serve/traffic.py``) with the fossil base: IAPWS-95 and its transport
properties, the liquid salts, the square-system Newton solver, the
steam-cycle units and the USC plant (``case_studies/fossil``); and the
molten-salt storage chain: the salt/steam heat exchanger
(``models/salt_hx.py``), the lane-batched Newton solver, the
reduced-space solver (``solvers/reduced.py``), the USC plant integrated
with storage, its multiperiod price-taker and its double-loop participant
(``case_studies/fossil``); and the charge and discharge storage design
studies, the concrete TES (``models/concrete_tes.py``), the tube-side
heat exchanger (``models/heat_exchanger_tube.py``) and the 692 MW
supercritical plant with the TES (``case_studies/fossil/scpc_plant.py``);
and the rest of the execution layer: scenario meshes and sharding
(``parallel/``), the plan's mesh placement, the adaptive in-flight depth
controller (``plan/adaptive.py``), the multichip dry run, and the obs
modules they read (``obs/online.py``, ``obs/timeline.py``,
``obs/profile.py``); the rest of the obs host tier and the multi-process
tier (``obs/``, ``net/``, ``fleet/``); and the analysis passes
(``analysis/``: graftlint with torch rules, lockcheck, the self-test
corpus, ``python -m dispatches_tpu_torch.analysis``, and the recompile
accounting of ``analysis/runtime.py``).  Every module of the JAX package
has its counterpart here.
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
