"""The PyTorch port's ExecutionPlan held to the JAX package's on the CPU.

Mirrors the mesh-free cases of tests/test_plan.py: ``PlanOptions.from_env``
(names, errors, and the mesh and depth controller those names build),
padding by repeating the last lane, ``stage``
copying caller-owned tensors, the bounded in-flight window, FIFO against
``ready`` (bitwise, uneven widths; and the retirement order under a
controllable completion probe), a fence that does not block submitters,
an ``on_done`` that resubmits without deadlock.  From tests/test_faults.py:
a transient fault retried invisibly, a poisoned lane bisected out and
NaN-filled, and the same outcomes as the JAX plan under the same fault
scenario."""

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dispatches_tpu.faults import inject as j_faults  # noqa: E402
from dispatches_tpu.plan import ExecutionPlan as JPlan  # noqa: E402
from dispatches_tpu.plan import PlanOptions as JPlanOptions  # noqa: E402

from dispatches_tpu_torch.faults import inject as t_faults  # noqa: E402
from dispatches_tpu_torch.obs import registry as t_reg  # noqa: E402
from dispatches_tpu_torch.plan import ExecutionPlan, PlanError, PlanOptions  # noqa: E402
from test_torch_stacked import one_torch_thread  # noqa: E402,F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def _disarmed():
    for f in (j_faults, t_faults):
        f.reset()
    yield
    for f in (j_faults, t_faults):
        f.reset()


def _plan(**opts):
    opts.setdefault("device", CPU)
    opts.setdefault("donate", False)
    return ExecutionPlan(PlanOptions(**opts))


def test_plan_options_from_env_names_and_errors(monkeypatch):
    monkeypatch.setenv("DISPATCHES_TPU_PLAN_INFLIGHT", "5")
    monkeypatch.setenv("DISPATCHES_TPU_PLAN_DEVICES", "4")
    monkeypatch.setenv("DISPATCHES_TPU_PLAN_SCHEDULE", "Ready")
    monkeypatch.setenv("DISPATCHES_TPU_PLAN_FENCE_TIMEOUT_MS", "250")
    opts = PlanOptions.from_env()
    assert (opts.inflight, opts.devices, opts.schedule, opts.fence_timeout_ms) == \
        (5, 4, "ready", 250.0)
    assert PlanOptions.from_env(inflight=1).inflight == 1  # explicit wins
    # PLAN_DEVICES > 1 builds a scenario mesh of that many entries on the
    # plan's device, as the JAX plan builds parallel.scenario_mesh(4)
    meshed = ExecutionPlan(PlanOptions.from_env(device=CPU))
    assert meshed.mesh.shape == {"scenario": 4} and meshed.device.type == "cpu"
    assert meshed.sharding_for(8) is not None and meshed.sharding_for(6) is None
    for var in ("PLAN_INFLIGHT", "PLAN_DEVICES", "PLAN_SCHEDULE", "PLAN_FENCE_TIMEOUT_MS"):
        monkeypatch.delenv(f"DISPATCHES_TPU_{var}")
    assert PlanOptions.from_env().inflight == 2
    monkeypatch.setenv("DISPATCHES_TPU_PLAN_INFLIGHT_MAX", "6")
    assert PlanOptions.from_env().inflight_max == 6
    # PLAN_INFLIGHT_MAX arms the depth controller, starting at inflight
    adaptive = ExecutionPlan(PlanOptions.from_env(device=CPU))
    assert adaptive.controller.max_inflight == 6
    assert adaptive.inflight_limit == adaptive.controller.depth == 2
    with pytest.raises(ValueError, match="schedule"):
        PlanOptions(schedule="lifo")
    monkeypatch.setenv("DISPATCHES_TPU_PLAN_INFLIGHT", "x")
    with pytest.raises(ValueError):
        PlanOptions.from_env()


def test_plan_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert ExecutionPlan(PlanOptions()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ExecutionPlan(PlanOptions())
    assert _plan().device == torch.device("cpu")
    fixed = _plan(inflight=3)
    assert fixed.inflight_limit == 3


def test_stack_pads_by_repeating_last():
    plan = _plan()
    trees = [{"a": np.full(3, float(i)), "b": float(i)} for i in range(5)]
    stacked = plan.stack(trees, lanes=8)
    assert isinstance(stacked["a"], np.ndarray) and stacked["a"].shape == (8, 3)
    for lane in (5, 6, 7):
        np.testing.assert_array_equal(stacked["a"][lane], stacked["a"][4])
        assert stacked["b"][lane] == stacked["b"][4]
    # tensor leaves stack as tensors; the lane menu is serve's
    stacked = plan.stack([{"a": torch.full((3,), float(i))} for i in range(2)], lanes=2)
    assert isinstance(stacked["a"], torch.Tensor)
    assert plan.lanes_for(5, 8) == 8


def test_stage_donate_copies_caller_owned_tensors():
    plan = _plan()
    mine = torch.arange(8.0)
    staged = plan.stage({"x": mine}, lanes=8, donate=True)
    assert staged["x"] is not mine and torch.equal(staged["x"], mine)
    staged["x"] += 1.0  # a program may update the staged buffer in place
    assert torch.equal(mine, torch.arange(8.0))
    assert plan.stage({"x": mine}, lanes=8, donate=False)["x"] is mine
    host = np.arange(8.0)
    staged2 = plan.stage({"x": host}, lanes=8, donate=False)
    np.testing.assert_array_equal(staged2["x"].numpy(), host)
    staged2["x"] += 1.0  # host leaves are copied, never aliased
    np.testing.assert_array_equal(host, np.arange(8.0))


def test_dispatch_ahead_window_bounds_inflight():
    plan = _plan(inflight=2)
    program = plan.program(lambda t: t["a"] + 1.0, label="test.window", vmap_axes=0)
    tickets = []
    for i in range(5):
        staged = plan.stage({"a": np.full(4, float(i))}, lanes=4, donate=False)
        tickets.append(plan.submit(program, (staged,), n_live=4, lanes=4))
        assert plan.inflight <= 2  # submit fences the oldest beyond 2
    assert tickets[0].done() and tickets[1].done() and tickets[2].done()
    assert plan.drain() == 2 and plan.inflight == 0
    for i, t in enumerate(tickets):
        np.testing.assert_array_equal(plan.collect(t).numpy(), np.full(4, i + 1.0))
    # one program signature for the one width, as jit would compile once
    assert program.compiles == 1


def test_ready_vs_fifo_bitwise_parity_uneven_widths():
    def run_arm(schedule):
        plan = _plan(inflight=2, schedule=schedule)
        prog = plan.program(lambda a: a * 3.0 - 1.0, label="plan.parity", vmap_axes=0)
        rng = np.random.default_rng(21)
        tickets = []
        for width in (5, 3, 8, 1):
            staged = plan.stage(rng.uniform(-1.0, 1.0, (width, 4)), lanes=width, donate=False)
            tickets.append(plan.submit(prog, (staged,), n_live=width, lanes=width))
        return ([plan.collect(t).numpy() for t in tickets],
                [(t.done(), t.error) for t in tickets], prog.compiles)

    fifo_out, fifo_status, fifo_compiles = run_arm("fifo")
    ready_out, ready_status, ready_compiles = run_arm("ready")
    assert fifo_status == ready_status and fifo_compiles == ready_compiles == 4
    for a, b in zip(fifo_out, ready_out):
        assert a.tobytes() == b.tobytes()


class _Gate:
    """A completion probe the test controls: the duck type of a CUDA
    event (``query`` / ``synchronize``) that the plan records per batch."""

    def __init__(self):
        self.event = threading.Event()

    def query(self):
        return self.event.is_set()

    def synchronize(self):
        if not self.event.wait(timeout=30.0):
            raise TimeoutError("gated batch never released")


def _gated_plan(n, **opts):
    plan = _plan(**opts)
    gates = [_Gate() for _ in range(n)]
    it = iter(gates)
    plan._marker = lambda: next(it)
    prog = plan.program(lambda v: v, label="plan.gated")
    return plan, prog, gates


def test_ready_schedule_fences_completed_batch_first():
    plan, prog, gates = _gated_plan(3, inflight=2, schedule="ready")
    t0, t1 = (plan.submit(prog, (i,), n_live=1, lanes=1) for i in range(2))
    gates[1].event.set()  # batch 1 completes while batch 0 still runs
    t2 = plan.submit(prog, (2,), n_live=1, lanes=1)  # overflow: trim one
    assert t1.done() and not t0.done() and not t2.done()
    for g in gates:
        g.event.set()
    plan.drain()
    assert all(t.done() and t.error is None for t in (t0, t1, t2))
    assert [t.result for t in (t0, t1, t2)] == [0, 1, 2]


def test_fifo_schedule_retires_in_order_even_when_later_ready():
    plan, prog, gates = _gated_plan(3, inflight=2, schedule="fifo")
    t0, t1 = (plan.submit(prog, (i,), n_live=1, lanes=1) for i in range(2))
    gates[0].event.set()
    gates[1].event.set()
    plan.submit(prog, (2,), n_live=1, lanes=1)
    assert t0.done() and not t1.done()
    gates[2].event.set()
    plan.drain()


def test_fence_wait_does_not_block_submitters():
    plan, prog, gates = _gated_plan(2, inflight=1)
    t0 = plan.submit(prog, (0,), n_live=1, lanes=1)
    collector = threading.Thread(target=plan.collect, args=(t0,))
    collector.start()
    deadline = time.monotonic() + 10.0
    while not t0._fencing and time.monotonic() < deadline:
        time.sleep(0.001)
    assert t0._fencing  # parked in the fence
    gates[1].event.set()
    submitted = threading.Event()

    def _submit():
        plan.submit(prog, (1,), n_live=1, lanes=1)
        submitted.set()

    threading.Thread(target=_submit).start()
    assert submitted.wait(5.0), "submit blocked behind a fence in progress"
    gates[0].event.set()
    collector.join(10.0)
    assert not collector.is_alive() and t0.done() and t0.result == 0
    plan.drain()


def test_on_done_resubmit_chain_does_not_deadlock():
    plan = _plan(inflight=1)
    prog = plan.program(lambda a: a + 1.0, label="plan.chain", vmap_axes=0)
    seen = []

    def submit_chain(i):
        def on_done(ticket):
            seen.append(ticket.result.numpy())
            if i < 2:
                submit_chain(i + 1)

        staged = plan.stage(torch.full((2, 3), float(i)), lanes=2, donate=False)
        plan.submit(prog, (staged,), n_live=2, lanes=2, on_done=on_done)

    submit_chain(0)
    finished = threading.Event()

    def _drain():
        plan.drain()
        finished.set()

    threading.Thread(target=_drain, daemon=True).start()
    assert finished.wait(60.0), "on_done re-submission deadlocked the plan"
    assert len(seen) == 3
    for i, arr in enumerate(seen):
        np.testing.assert_array_equal(arr, np.full((2, 3), i + 1.0))


# ---------------------------------------------------------------------------
# the failure domain, against the JAX plan under the same scenario
# ---------------------------------------------------------------------------


def _toy_run(pkg, scenario, vals, request_ids=None, restage=True, **opts):
    """One toy batch (``a * 2``) through the JAX (``pkg="jax"``) or the
    port's plan with ``scenario`` armed: (result, guilty, attempts,
    retries delta, raised)."""
    arr = np.asarray(vals, np.float64)
    if pkg == "jax":
        faults = j_faults
        from dispatches_tpu.obs import registry as reg
        plan = JPlan(JPlanOptions(inflight=2, donate=False, **opts))

        def stage(rows):
            return plan.stage(jnp.asarray(rows), lanes=rows.shape[0], donate=False)
    else:
        faults, reg = t_faults, t_reg
        plan = _plan(inflight=2, **opts)

        def stage(rows):
            return plan.stage(rows, lanes=rows.shape[0], donate=False)
    prog = plan.program(lambda a: a * 2.0, label="faults.toy", vmap_axes=0)

    def _restage(idxs):
        rows = arr[list(idxs)]
        ids = None if request_ids is None else [request_ids[i] for i in idxs]
        return (stage(rows),), rows.shape[0], ids

    faults.arm(scenario)
    ret0 = reg.counter("plan.retries").total()
    ticket = plan.submit(prog, (stage(arr),), n_live=arr.shape[0], lanes=arr.shape[0],
                         request_ids=request_ids, restage=_restage if restage else None)
    try:
        res = np.asarray(plan.collect(ticket))
        raised = None
    except Exception as exc:  # noqa: BLE001 — compared below
        res, raised = None, (type(exc).__name__, exc.guilty, exc.attempts)
    faults.reset()
    err = ticket.error
    return (None if res is None else res.tobytes(), None if err is None else err.guilty,
            None if err is None else err.attempts,
            reg.counter("plan.retries").total() - ret0, raised)


@pytest.mark.parametrize("scenario,ids,restage", [
    ("plan.fence,times=1", None, True),            # transient: one retry
    ("plan.submit,times=2", None, True),           # two failed tries
    ("plan.fence,poison_ids=13", [11, 12, 13, 14], True),  # bisection
    ("solver,poison_mod=2", [11, 12, 13, 14], True),       # two guilty lanes
    ("plan.fence,poison_mod=1", [1, 2, 3, 4], True),       # all guilty: raises
    ("plan.fence,times=1", None, False),           # no restage: raises
])
def test_fault_outcomes_equal_jax(scenario, ids, restage, monkeypatch):
    from dispatches_tpu.plan import execution as j_exec
    from dispatches_tpu_torch.plan import execution as t_exec

    for mod in (j_exec, t_exec):
        monkeypatch.setattr(mod.time, "sleep", lambda s: None)
    vals = [1.0, 2.0, 3.0, 4.0]
    want = _toy_run("jax", scenario, vals, ids, restage)
    got = _toy_run("torch", scenario, vals, ids, restage)
    assert got == want
    if scenario == "plan.fence,poison_ids=13":
        res = np.frombuffer(got[0])
        assert got[1] == (2,) and np.isnan(res[2])
        np.testing.assert_array_equal(res[[0, 1, 3]], [2.0, 4.0, 8.0])
        assert got[3] > 1  # full retries + bisection redispatches


def test_plan_retry_backoff_is_exponential_and_capped(monkeypatch):
    from dispatches_tpu_torch.plan import execution as t_exec

    sleeps = []
    monkeypatch.setattr(t_exec.time, "sleep", sleeps.append)
    plan = _plan(max_retries=5, retry_backoff_ms=100.0)
    prog = plan.program(lambda a: a * 2.0, label="faults.toy", vmap_axes=0)
    arr = np.asarray([1.0, 2.0])
    t_faults.arm("plan.fence,times=4")
    ticket = plan.submit(prog, (plan.stage(arr, lanes=2),), n_live=2, lanes=2,
                         restage=lambda idxs: ((plan.stage(arr[list(idxs)], lanes=2),), 2, None))
    np.testing.assert_allclose(plan.collect(ticket).numpy(), [2.0, 4.0])
    assert ticket.error.attempts == 4
    assert sleeps == [0.1, 0.2, 0.25, 0.25]


def test_all_guilty_collect_raises_plan_error():
    plan = _plan()
    prog = plan.program(lambda a: a * 2.0, label="faults.toy", vmap_axes=0)
    arr = np.asarray([1.0, 2.0])
    t_faults.arm("plan.fence,poison_mod=1")
    ticket = plan.submit(prog, (plan.stage(arr, lanes=2),), n_live=2, lanes=2,
                         request_ids=[1, 2],
                         restage=lambda idxs: ((plan.stage(arr[list(idxs)], lanes=2),),
                                               len(idxs), [i + 1 for i in idxs]))
    with pytest.raises(PlanError) as ei:
        plan.collect(ticket)
    assert ei.value.guilty == (0, 1) and ticket.result is None


def test_fence_watchdog_escapes_injected_hang():
    class Clock:
        t = 0.0

        def __call__(self):
            return self.t

        def advance(self, s):
            self.t += s

    plan = ExecutionPlan(PlanOptions(device=CPU, donate=False, fence_timeout_ms=200.0),
                         clock=Clock())
    prog = plan.program(lambda a: a * 2.0, label="faults.toy", vmap_axes=0)
    arr = np.asarray([1.0, 2.0])
    t_faults.arm("plan.fence,hang_s=30,times=1")
    ticket = plan.submit(prog, (plan.stage(arr, lanes=2),), n_live=2, lanes=2,
                         restage=lambda idxs: ((plan.stage(arr[list(idxs)], lanes=2),), 2, None))
    np.testing.assert_allclose(plan.collect(ticket).numpy(), [2.0, 4.0])
    assert ticket.error.kind == "hang" and ticket.error.attempts == 1
