"""The port's lock-discipline pass (``dispatches_tpu_torch.analysis.
lockcheck``, GL009-GL012) held to the JAX package's on the CPU.

* Both passes give equal ``(path, line, col, rule, message,
  fingerprint)`` lists over ``dispatches_tpu/`` and over
  ``dispatches_tpu_torch/``, on JAX's GL009-GL012 corpus (the port's is
  the same text) and on every mechanics case of tests/test_lockcheck.py
  (module locks, zero-arg ``result()``, one-level summaries, trace
  emission, nested functions, the pragma and its scope, self-deadlock,
  the cross-file order graph, guarded writes).
* The one blocking name the port adds, ``synchronize``, fires GL009
  under a lock; the JAX tree calls nothing of that name.
* The port as committed is lockcheck-clean (its two intentional holds
  carry pragmas); armed, the serve and plan guards are sanitized and a
  submit-drain cycle observes no inversion.
* Both CLIs' ``--json`` documents have equal keys, and equal findings on
  a seeded file with all four lock rules.
"""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu.analysis import CORPUS as J_CORPUS  # noqa: E402
from dispatches_tpu.analysis import lockcheck as jlock  # noqa: E402

from dispatches_tpu_torch.analysis import (  # noqa: E402
    CORPUS,
    LOCKCHECK_RULES,
    RULES,
    SanitizedLock,
    lock_order_report,
    reset_lock_order,
)
from dispatches_tpu_torch.analysis import lockcheck as tlock  # noqa: E402
from dispatches_tpu_torch.analysis.graftlint import package_root  # noqa: E402

from test_torch_stacked import one_torch_thread  # noqa: E402,F401

REPO = Path(__file__).resolve().parent.parent


def _key(findings):
    return [(f.path, f.line, f.col, f.rule, f.message, f.fingerprint) for f in findings]


def _both(src, relpath="pkg/mod.py"):
    """The port's findings, after checking that JAX's are the same."""
    src = textwrap.dedent(src)
    got = tlock.check_source(src, relpath)
    assert _key(got) == _key(jlock.check_source(src, relpath))
    return [f.rule for f in got]


@pytest.mark.parametrize("tree", ["dispatches_tpu", "dispatches_tpu_torch"])
def test_both_passes_agree_over_each_tree(tree):
    want = _key(jlock.check_paths([REPO / tree]))
    assert _key(tlock.check_paths([REPO / tree])) == want


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", LOCKCHECK_RULES)
def test_corpus_is_jax_text_with_jax_findings(rule, kind):
    assert CORPUS[rule][kind] == J_CORPUS[rule][kind]
    rules = _both(J_CORPUS[rule][kind], f"<{rule}-{kind}>")
    assert (rule in rules) == (kind == "bad")


def test_port_tree_is_lockcheck_clean():
    assert tlock.check_paths([package_root()]) == []


def test_lockcheck_rules_are_registered():
    for rule in LOCKCHECK_RULES:
        assert rule in RULES
    f = tlock.check_source(textwrap.dedent("""
        import threading
        import time

        class W:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:
                    time.sleep(1)
    """), "pkg/mod.py")[0]
    assert "blocking-under-lock" in f.render() and f.line == 11


MECHANICS = {
    "module_level_lock": ("""
        import threading
        import time

        _lock = threading.Lock()

        def tick():
            with _lock:
                time.sleep(0.1)
    """, ["GL009"]),
    "zero_arg_result_blocks": ("""
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self, fut):
                with self._lock:
                    return fut.result()
    """, ["GL009"]),
    "result_with_args_does_not": ("""
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self, builder):
                with self._lock:
                    return builder.result("label", 3)
    """, []),
    "one_level_call_summary": ("""
        import threading
        import jax

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._batch = None

            def _flush(self):
                return jax.block_until_ready(self._batch)

            def f(self):
                with self._lock:
                    self._flush()
    """, ["GL009"]),
    "trace_emission": ("""
        import threading
        from dispatches_tpu_torch.obs import trace as obs_trace

        class W:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self, t0, dur):
                with self._lock:
                    obs_trace.complete("span", t0, dur)
    """, ["GL010"]),
    "nested_function_not_under_lock": ("""
        import threading
        import time

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self._cb = None

            def f(self):
                with self._lock:
                    def later():
                        time.sleep(1)
                    self._cb = later
    """, []),
    "pragma_suppresses": ("""
        import threading
        import time

        class W:
            def __init__(self):
                self._lock = threading.Lock()

            def f(self):
                with self._lock:  # lockcheck: intentional
                    time.sleep(1)

        class V:
            def __init__(self):
                self._lock = threading.Lock()

            def g(self):
                with self._lock:
                    time.sleep(1)
    """, ["GL009"]),
    "pragma_rule_scoped": ("""
        import threading
        import time

        class W:
            def __init__(self, flight):
                self._lock = threading.Lock()
                self._flight = flight

            def f(self):
                with self._lock:  # lockcheck: intentional(GL009)
                    time.sleep(1)
                    self._flight.trigger("x")
    """, ["GL010"]),
    "self_deadlock_plain_lock": ("""
        import threading

        class W:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def f(self):
                with self._lock:
                    with self._lock:
                        self.n += 1
    """, ["GL011"]),
    "rlock_reentry_is_fine": ("""
        import threading

        class W:
            def __init__(self):
                self._lock = threading.RLock()
                self.n = 0

            def f(self):
                with self._lock:
                    with self._lock:
                        self.n += 1
    """, []),
    "sanitized_factory_plain": ("""
        from dispatches_tpu_torch.analysis import sanitized_lock

        class W:
            def __init__(self):
                self._lock = sanitized_lock("w", reentrant=False)
                self.n = 0

            def f(self):
                with self._lock:
                    with self._lock:
                        self.n += 1
    """, ["GL011"]),
    "gl012_init_writes_exempt": ("""
        import threading

        class Stats:
            def __init__(self):
                self._lock = threading.Lock()
                self.solved = 0

            def record(self):
                with self._lock:
                    self.solved += 1
    """, []),
    "gl012_per_bare_write_site": ("""
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

            def force(self, n):
                self.solved = n
    """, ["GL012", "GL012"]),
}


@pytest.mark.parametrize("case", sorted(MECHANICS))
def test_mechanics_equal_jax(case):
    src, want = MECHANICS[case]
    assert sorted(_both(src)) == want


def test_synchronize_blocks_under_a_lock():
    """The port's one added blocking name (torch's device wait), direct
    and through a one-level summary; the JAX pass does not know it."""
    src = textwrap.dedent("""
        import threading
        import torch

        class W:
            def __init__(self):
                self._lock = threading.Lock()

            def _wait(self, ev):
                ev.synchronize()

            def f(self, ev):
                with self._lock:
                    torch.cuda.synchronize()
                    self._wait(ev)
    """)
    got = tlock.check_source(src, "pkg/mod.py")
    assert [(f.rule, f.line) for f in got] == [("GL009", 14), ("GL009", 15)]
    assert jlock.check_source(src, "pkg/mod.py") == []
    assert "synchronize" in got[0].message


def test_cross_file_graph(tmp_path):
    a = tmp_path / "a.py"
    b = tmp_path / "b.py"
    a.write_text(textwrap.dedent("""
        import threading

        red = threading.Lock()
        blue = threading.Lock()

        def forward():
            with red:
                with blue:
                    pass
    """))
    b.write_text(textwrap.dedent("""
        from a import red, blue

        def backward():
            with blue:
                with red:
                    pass
    """))
    got = tlock.check_paths([tmp_path])
    assert "GL011" in [f.rule for f in got]
    assert _key(got) == _key(jlock.check_paths([tmp_path]))
    assert "GL011" not in [f.rule for f in tlock.check_source(a.read_text(), "a.py")]


@pytest.fixture
def armed(monkeypatch):
    monkeypatch.setenv("DISPATCHES_TPU_SANITIZE", "1")
    reset_lock_order()
    yield
    reset_lock_order()


def test_armed_service_and_plan_locks_are_sanitized(armed):
    from dispatches_tpu_torch.obs.soak import StubNLP, make_stub_solver
    from dispatches_tpu_torch.plan import ExecutionPlan, PlanOptions
    from dispatches_tpu_torch.serve import RequestStatus, ServeOptions, SolveService

    plan = ExecutionPlan(PlanOptions(inflight=2, device="cpu"))
    svc = SolveService(ServeOptions(max_batch=4, max_wait_ms=5.0, warm_start=False,
                                    plan=plan), device="cpu")
    assert isinstance(svc._lock, SanitizedLock)
    assert isinstance(plan._lock, SanitizedLock)
    assert isinstance(plan._fence_lock, SanitizedLock)
    nlp = StubNLP()
    h = svc.submit(nlp, nlp.default_params(), solver="pdlp", base_solver=make_stub_solver())
    svc.drain()
    assert h.result().status == RequestStatus.DONE
    assert lock_order_report()["inversions"] == []


SEEDED = """
    import threading
    import time

    class W:
        def __init__(self, flight):
            self._lock = threading.Lock()
            self._a = threading.Lock()
            self._b = threading.Lock()
            self._flight = flight
            self.n = 0

        def gl009(self):
            with self._lock:
                time.sleep(1)

        def gl010(self):
            with self._lock:
                self._flight.trigger("x")

        def gl011_fwd(self):
            with self._a:
                with self._b:
                    pass

        def gl011_bwd(self):
            with self._b:
                with self._a:
                    pass

        def gl012_guarded(self):
            with self._lock:
                self.n += 1

        def gl012_bare(self):
            self.n = 0
"""


def _cli(module, *args):
    return subprocess.run([sys.executable, "-m", module, *args],
                          capture_output=True, text=True, cwd=REPO)


def test_cli_json_equals_jax_on_seeded_violations(tmp_path):
    bad = tmp_path / "seeded.py"
    bad.write_text(textwrap.dedent(SEEDED))
    docs = {}
    for module in ("dispatches_tpu.analysis", "dispatches_tpu_torch.analysis"):
        proc = _cli(module, "--check", "--json", str(bad))
        assert proc.returncode == 1, proc.stdout + proc.stderr
        docs[module] = json.loads(proc.stdout)
    want, got = docs["dispatches_tpu.analysis"], docs["dispatches_tpu_torch.analysis"]
    assert got == want
    assert {f["rule"] for f in got["findings"]} == {"GL009", "GL010", "GL011", "GL012"}
    assert got["counts"]["new"] == len(got["findings"])


def test_cli_json_clean_tree_keys_equal_jax():
    docs = {}
    for module in ("dispatches_tpu.analysis", "dispatches_tpu_torch.analysis"):
        proc = _cli(module, "--check", "--json")
        assert proc.returncode == 0, proc.stdout + proc.stderr
        docs[module] = json.loads(proc.stdout)
    want, got = docs["dispatches_tpu.analysis"], docs["dispatches_tpu_torch.analysis"]
    assert set(got) == set(want) and set(got["counts"]) == set(want["counts"])
    assert got["schema"] == want["schema"] == 1
    assert {tuple(sorted(f)) for f in got["findings"]} == {
        tuple(sorted(f)) for f in want["findings"]}
    assert got["counts"]["new"] == 0 and all(f["baselined"] for f in got["findings"])
    assert got["counts"]["total"] == len(got["findings"])
