"""The module-state fixture of the port's test files that compare the two
packages' tracing, flight, export, distributed or fault state (imported by
name into each file, so that pytest applies it there).

The tier-1 run hands many files to one worker process in turn, and an
earlier file can leave either package's process-wide state behind: a
JAX serve recovery sets the exporter's restart generation, a JAX test
turns the tracer on and fills its ring.  A comparison of the two packages
then sees that state on one side only.  This fixture puts both packages
into the same clean state before each test and after it, and puts the
restart generations back as it found them."""

import pytest

from dispatches_tpu.faults import inject as jfaults
from dispatches_tpu.obs import distributed as jdist
from dispatches_tpu.obs import export as jexp
from dispatches_tpu.obs import flight as jflight
from dispatches_tpu.obs import trace as jtrace

from dispatches_tpu_torch.faults import inject as tfaults
from dispatches_tpu_torch.obs import distributed as tdist
from dispatches_tpu_torch.obs import export as texp
from dispatches_tpu_torch.obs import flight as tflight
from dispatches_tpu_torch.obs import trace as ttrace


def _clean() -> None:
    for trace in (jtrace, ttrace):
        trace.reset()
        trace.enable(False)
    for flight in (jflight, tflight):
        flight.reset()
    for dist in (jdist, tdist):
        dist.enable(False)
        dist.set_generation(1)
    for faults in (jfaults, tfaults):
        faults.reset()


@pytest.fixture(autouse=True)
def isolated_obs_state():
    """Both packages' trace ring (off and empty), flight recorder,
    distributed-tracing switch and fault injector reset, and their
    exporters' restart generations set to 0, for the test's duration."""
    _clean()
    prev = (jexp.set_restart_generation(0), texp.set_restart_generation(0))
    try:
        yield
    finally:
        _clean()
        jexp.set_restart_generation(prev[0])
        texp.set_restart_generation(prev[1])
