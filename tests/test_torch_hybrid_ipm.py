"""The slow halves of the first-15-iterations comparison of the full
hybrid's interior point (wind + battery + PEM + tank + turbine) between
the PyTorch port and the JAX package, on the CPU in float64.  The tier-1
cases (T = 4 against JAX's recorded trace, and the T = 8 first step of
both KKT paths) live in tests/test_torch_re_hybrid.py, beside the NLP
they solve, so that the parallel tier-1 run hands them out early.

- T = 8, the bordered block-tridiagonal KKT solve with the turbine's
  nonzero Hessian blocks, against JAX's structured path live (~3 minutes,
  most of it JAX's compile);
- JAX's T = 4 dense trace rebuilt and held bitwise to its record
  (``tests/torch_records.py``, ``hybrid_ipm_jax_t4_dense``).
"""

import pytest

torch = pytest.importorskip("torch")

from dispatches_tpu_torch.solvers import structured as t_st  # noqa: E402

import torch_records  # noqa: E402
from test_torch_re_hybrid import (  # noqa: E402
    HYBRID_RECORD,
    _assert_traces_match,
    _traces,
    jax_record,
)


@pytest.mark.slow
def test_hybrid_structured_ipm_first_iterations_match_jax():
    """T = 8: the bordered block-tridiagonal KKT solve with the turbine's
    nonzero Hessian blocks, against JAX's structured path."""
    jres, jtr, tres, ttr, tn = _traces(8, "structured")
    assert t_st.detect_time_structure(tn, device="cpu") is not None
    _assert_traces_match(jres, jtr, tres, ttr, "T=8 structured")


@pytest.mark.slow
def test_hybrid_ipm_jax_record_is_current():
    """JAX's T = 4 dense trace, rebuilt, equals the record bitwise."""
    assert torch_records.matches(HYBRID_RECORD, jax_record())
