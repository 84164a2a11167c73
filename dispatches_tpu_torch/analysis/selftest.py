"""Self-test corpus: one minimal bad snippet per lint rule (must fire)
and one near-miss good snippet (must stay clean); counterpart of
``dispatches_tpu/analysis/selftest.py``.

This is the linter's own regression net — `python -m
dispatches_tpu_torch.analysis --selftest` (and
tests/test_torch_analysis.py) fail if a rule stops firing on its
canonical violation or starts flagging the disciplined version of the
same code.  The GL001-GL008 snippets are torch translations of the JAX
package's, each bad one firing at its original's lines; the GL009-GL012
snippets are the JAX package's text, since those rules do not depend on
the array library.
"""

from __future__ import annotations

from textwrap import dedent
from typing import Dict, List

from dispatches_tpu_torch.analysis.graftlint import RULES, lint_source
from dispatches_tpu_torch.analysis.lockcheck import LOCKCHECK_RULES, check_source

CORPUS: Dict[str, Dict[str, str]] = {
    "GL001": {
        "bad": """
            import torch
            import numpy as np

            def f(x):
                y = np.asarray(x)
                return float(x[0]) + y.item()

            solve = torch.func.vmap(f)
        """,
        "good": """
            import torch

            def f(x):
                return torch.as_tensor(x)[0] * 2.0

            solve = torch.func.vmap(f)
        """,
    },
    "GL002": {
        "bad": """
            import torch

            def f(x):
                r = x * 2
                if r > 0:
                    return r
                return -r

            solve = torch.func.vmap(f)
        """,
        "good": """
            import torch

            def f(x):
                if x.ndim == 1:
                    x = x[None, :]
                return torch.where(x > 0, x, -x)

            solve = torch.func.vmap(f)
        """,
    },
    "GL003": {
        "bad": """
            import torch

            nums = [0, 1]
            dfdab = torch.func.grad(lambda a, b: (a * b).sum(), argnums=nums)
        """,
        "good": """
            import torch

            dfdab = torch.func.grad(lambda a, b: (a * b).sum(), argnums=(0, 1))
        """,
    },
    "GL004": {
        "bad": """
            import torch

            out = []
            for hour in range(24):
                out.append(torch.tensor([float(hour), 1.0], dtype=torch.float64))
        """,
        "good": """
            import torch

            hours = torch.arange(24, dtype=torch.float64)
            out = torch.stack([hours, torch.ones(24, dtype=torch.float64)], dim=1)
        """,
    },
    "GL005": {
        "bad": """
            import torch

            def polish(x):
                w = 0.5
                return x * torch.tensor([w, 1.0 - w])
        """,
        "good": """
            import torch

            def polish(x):
                w = 0.5
                return x * torch.tensor([w, 1.0 - w], dtype=x.dtype)
        """,
    },
    "GL007": {
        "bad": """
            import time
            from dispatches_tpu_torch.analysis import CountedProgram

            solver = CountedProgram(lambda p: p * 2.0, label="bench")

            def bench(params):
                t0 = time.perf_counter()
                res = solver(params)
                elapsed = time.perf_counter() - t0
                return res, elapsed
        """,
        "good": """
            import time
            import torch
            from dispatches_tpu_torch.analysis import CountedProgram

            solver = CountedProgram(lambda p: p * 2.0, label="bench")

            def bench(params):
                t0 = time.perf_counter()
                res = solver(params)
                torch.cuda.synchronize()
                elapsed = time.perf_counter() - t0
                return res, elapsed
        """,
    },
    "GL006": {
        "bad": """
            import os

            turbo = os.environ.get("DISPATCHES_TPU_TURBO")
            if "DISPATCHES_TPU_LUDICROUS" in os.environ:
                speed = os.environ["DISPATCHES_TPU_LUDICROUS"]
            chunk = os.environ.get("DISPATCHES_TPU_SWEEP_TURBO_CHUNK")
            led = os.environ.get("DISPATCHES_TPU_OBS_LEDGER")
            exp = os.environ.get("DISPATCHES_TPU_OBS_EXPORT")
            soak = os.environ.get("DISPATCHES_TPU_SOAK_SPEC_PATH")
            cool = os.environ.get("DISPATCHES_TPU_OBS_FLIGHT_COOLDOWN")
            pred = os.environ.get("DISPATCHES_TPU_WARMSTART_PREDICT_N")
            nret = os.environ.get("DISPATCHES_TPU_NET_RETRIES")
            nhb = os.environ.get("DISPATCHES_TPU_NET_HEARTBEAT_TIMEOUT_MS")
        """,
        "good": """
            import os

            data = os.environ.get("DISPATCHES_TPU_DATA")
            rts = os.environ.get("DISPATCHES_TPU_RTS_GMLC")
            warn = os.environ.get("DISPATCHES_TPU_WARN_RECOMPILE")
            san = os.environ.get("DISPATCHES_TPU_SANITIZE")
            chunk = os.environ.get("DISPATCHES_TPU_SWEEP_CHUNK")
            prof = os.environ.get("DISPATCHES_TPU_OBS_PROFILE")
            led_dir = os.environ.get("DISPATCHES_TPU_OBS_LEDGER_DIR")
            flight = os.environ.get("DISPATCHES_TPU_OBS_FLIGHT_DIR")
            slo = os.environ.get("DISPATCHES_TPU_OBS_SLO")
            exp_dir = os.environ.get("DISPATCHES_TPU_OBS_EXPORT_DIR")
            exp_int = os.environ.get("DISPATCHES_TPU_OBS_EXPORT_INTERVAL_S")
            exp_nf = os.environ.get("DISPATCHES_TPU_OBS_EXPORT_MAX_FILES")
            exp_nr = os.environ.get("DISPATCHES_TPU_OBS_EXPORT_MAX_RECORDS")
            algo = os.environ.get("DISPATCHES_TPU_PDLP_ALGO")
            prec = os.environ.get("DISPATCHES_TPU_PDLP_PRECISION")
            rounds = os.environ.get("DISPATCHES_TPU_PDLP_REFINE_ROUNDS")
            inflight = os.environ.get("DISPATCHES_TPU_PLAN_INFLIGHT")
            ndev = os.environ.get("DISPATCHES_TPU_PLAN_DEVICES")
            soak_spec = os.environ.get("DISPATCHES_TPU_SOAK_SPEC")
            soak_dur = os.environ.get("DISPATCHES_TPU_SOAK_DURATION_S")
            soak_out = os.environ.get("DISPATCHES_TPU_SOAK_REPORT_DIR")
            cool = os.environ.get("DISPATCHES_TPU_OBS_FLIGHT_COOLDOWN_S")
            warm = os.environ.get("DISPATCHES_TPU_WARMSTART")
            warm_k = os.environ.get("DISPATCHES_TPU_WARMSTART_K")
            warm_r = os.environ.get("DISPATCHES_TPU_WARMSTART_RADIUS")
            faults = os.environ.get("DISPATCHES_TPU_FAULTS")
            retries = os.environ.get("DISPATCHES_TPU_PLAN_MAX_RETRIES")
            backoff = os.environ.get("DISPATCHES_TPU_PLAN_RETRY_BACKOFF_MS")
            shed = os.environ.get("DISPATCHES_TPU_SERVE_SHED_QUEUE_DEPTH")
            dg_mp = os.environ.get("DISPATCHES_TPU_SERVE_DEGRADE_MISPREDICTS")
            dg_rf = os.environ.get("DISPATCHES_TPU_SERVE_DEGRADE_REFINE_FAILS")
            sched = os.environ.get("DISPATCHES_TPU_PLAN_SCHEDULE")
            in_max = os.environ.get("DISPATCHES_TPU_PLAN_INFLIGHT_MAX")
            adw = os.environ.get("DISPATCHES_TPU_SERVE_ADAPTIVE_WAIT")
            hold = os.environ.get("DISPATCHES_TPU_SERVE_HOLD_MAX_MS")
            jdir = os.environ.get("DISPATCHES_TPU_SERVE_JOURNAL_DIR")
            snap = os.environ.get("DISPATCHES_TPU_SERVE_SNAPSHOT_INTERVAL_S")
            fence = os.environ.get("DISPATCHES_TPU_PLAN_FENCE_TIMEOUT_MS")
            freps = os.environ.get("DISPATCHES_TPU_FLEET_REPLICAS")
            fhb = os.environ.get("DISPATCHES_TPU_FLEET_HEARTBEAT_MS")
            fgos = os.environ.get("DISPATCHES_TPU_FLEET_GOSSIP_INTERVAL_S")
            wpred = os.environ.get("DISPATCHES_TPU_WARMSTART_PREDICT")
            wphid = os.environ.get("DISPATCHES_TPU_WARMSTART_PREDICT_HIDDEN")
            wpref = os.environ.get("DISPATCHES_TPU_WARMSTART_PREDICT_REFIT_N")
            nport = os.environ.get("DISPATCHES_TPU_NET_PORT")
            nct = os.environ.get("DISPATCHES_TPU_NET_CONNECT_TIMEOUT_MS")
            nrr = os.environ.get("DISPATCHES_TPU_NET_RPC_RETRIES")
            nhb = os.environ.get("DISPATCHES_TPU_NET_HEARTBEAT_MS")
            ntr = os.environ.get("DISPATCHES_TPU_NET_TRACE")
            fexp = os.environ.get("DISPATCHES_TPU_OBS_FLEET_EXPORT_DIR")
        """,
    },
    "GL008": {
        "bad": """
            import torch
            from dispatches_tpu_torch.parallel import scenario_mesh

            def stage(arr, mesh):
                devs = list(mesh.devices.flat)
                return [part.to(d) for part, d in zip(arr.chunk(len(devs)), devs)]
        """,
        "good": """
            import torch

            def stage(plan, program, per_lane, lanes, n_live):
                batched = plan.stage(plan.stack(per_lane, lanes=lanes),
                                     lanes=lanes, donate=program.donates)
                ticket = plan.submit(program, (batched,),
                                     n_live=n_live, lanes=lanes)
                # committing to the plan's own device decides nothing
                warm = per_lane[0].to(plan.device)
                return plan.collect(ticket), warm
        """,
    },
    # -- lock-discipline rules (routed through lockcheck.check_source) --
    "GL009": {
        "bad": """
            import threading
            import time

            class Window:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._tickets = []

                def retire(self, ticket):
                    with self._lock:
                        time.sleep(0.05)
                        self._tickets.remove(ticket)
        """,
        "good": """
            import threading
            import time

            class Window:
                def __init__(self):
                    self._lock = threading.Lock()
                    self._tickets = []

                def retire(self, ticket):
                    time.sleep(0.05)
                    with self._lock:
                        self._tickets.remove(ticket)
        """,
    },
    "GL010": {
        "bad": """
            import threading

            class Service:
                def __init__(self, flight):
                    self._lock = threading.Lock()
                    self._flight = flight
                    self._done = []

                def complete(self, handle):
                    with self._lock:
                        self._done.append(handle)
                        self._flight.trigger("serve.complete")
        """,
        "good": """
            import threading

            class Service:
                def __init__(self, flight):
                    self._lock = threading.Lock()
                    self._flight = flight
                    self._done = []

                def complete(self, handle):
                    with self._lock:
                        self._done.append(handle)
                    self._flight.trigger("serve.complete")
        """,
    },
    "GL011": {
        "bad": """
            import threading

            class Ledger:
                def __init__(self):
                    self._a = threading.Lock()
                    self._b = threading.Lock()
                    self.rows = []
                    self.sums = []

                def append(self, row):
                    with self._a:
                        with self._b:
                            self.rows.append(row)

                def total(self):
                    with self._b:
                        with self._a:
                            self.sums.append(len(self.rows))
        """,
        "good": """
            import threading

            class Ledger:
                def __init__(self):
                    self._a = threading.Lock()
                    self._b = threading.Lock()
                    self.rows = []
                    self.sums = []

                def append(self, row):
                    with self._a:
                        with self._b:
                            self.rows.append(row)

                def total(self):
                    with self._a:
                        with self._b:
                            self.sums.append(len(self.rows))
        """,
    },
    "GL012": {
        "bad": """
            import threading

            class Stats:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.solved = 0

                def record(self):
                    with self._lock:
                        self.solved += 1

                def reset(self):
                    self.solved = 0
        """,
        "good": """
            import threading

            class Stats:
                def __init__(self):
                    self._lock = threading.Lock()
                    self.solved = 0

                def record(self):
                    with self._lock:
                        self.solved += 1

                def reset(self):
                    with self._lock:
                        self.solved = 0
        """,
    },
}


def run_selftest() -> List[str]:
    """Lint every corpus snippet; return a list of failures (empty =
    all rules fire on their bad snippet and stay quiet on the good
    one)."""
    errors: List[str] = []
    for rule in RULES:
        snippets = CORPUS.get(rule)
        if snippets is None:
            errors.append(f"{rule}: no self-test snippet in CORPUS")
            continue
        # lock-discipline rules live in the second pass
        check = check_source if rule in LOCKCHECK_RULES else lint_source
        bad = check(dedent(snippets["bad"]), f"<{rule}-bad>")
        if not any(f.rule == rule for f in bad):
            errors.append(
                f"{rule}: did not fire on its bad snippet "
                f"(got {[f.rule for f in bad]})"
            )
        good = check(dedent(snippets["good"]), f"<{rule}-good>")
        hits = [f for f in good if f.rule == rule]
        if hits:
            errors.append(
                f"{rule}: false positive on its good snippet at "
                f"line {hits[0].line}: {hits[0].message}"
            )
    return errors
