"""Golden-vector regression vs the reference binary.

The cases and their runner live in tests/golden_cases.py (shared with
chip_smoke.py, which runs the same cases on the GPU).  Each test fails if
the rank, the pivot order (swap arrays), or any output bit ever diverges
from the reference binary — closing the "silent pivot-order divergence"
gap.
"""

import pytest

from golden_cases import case_id, check_case, load_cases

_PLE = load_cases("ple")
_PLUQ = load_cases("pluq")
_RREF = load_cases("rref")
_MUL = load_cases("mul")


@pytest.mark.parametrize("rec", _PLE, ids=[case_id(r) for r in _PLE])
def test_golden_ple(rec):
    check_case(rec)


@pytest.mark.parametrize("rec", _PLUQ, ids=[case_id(r) for r in _PLUQ])
def test_golden_pluq(rec):
    check_case(rec)


@pytest.mark.parametrize("rec", _RREF, ids=[case_id(r) for r in _RREF])
def test_golden_rref(rec):
    check_case(rec)


@pytest.mark.parametrize("rec", _MUL, ids=[case_id(r) for r in _MUL])
def test_golden_mul(rec):
    check_case(rec)
