"""Echelonization tests (reference: tests/test_elimination.c — several
independent elimination paths must agree; RREF is unique over GF(2), so the
device engine must match the numpy Gauss oracle bit-for-bit)."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.models.echelon import echelonize, rank, top_echelonize

import oracle
from conftest import random_dense

SIZES = [(4, 4), (32, 32), (37, 29), (64, 128), (128, 64), (128, 128),
         (200, 200), (256, 177)]


@pytest.mark.parametrize("m,n", SIZES)
def test_rref_bit_exact(rng, m, n):
    a = random_dense(rng, m, n)
    R, r = echelonize(m4.from_numpy(a), full=True)
    np.testing.assert_array_equal(m4.to_numpy(R), oracle.rref(a))
    assert int(r) == oracle.rank(a)


@pytest.mark.parametrize("m,n", [(64, 64), (128, 96), (100, 150)])
def test_rref_low_rank(rng, m, n):
    k = min(m, n) // 3
    a = oracle.mul(random_dense(rng, m, k), random_dense(rng, k, n)).astype(
        np.uint8)
    R, r = echelonize(m4.from_numpy(a), full=True)
    np.testing.assert_array_equal(m4.to_numpy(R), oracle.rref(a))
    assert int(r) == oracle.rank(a)
    assert int(r) <= k


@pytest.mark.parametrize("m,n", [(64, 64), (96, 128), (130, 70)])
def test_ref_non_reduced(rng, m, n):
    """full=False: result is in echelon form and row-equivalent to A."""
    a = random_dense(rng, m, n)
    R, r = echelonize(m4.from_numpy(a), full=False)
    r = int(r)
    Rd = m4.to_numpy(R)
    # rows >= r are zero
    assert not Rd[r:].any()
    # pivot structure: leading-1 columns strictly increase
    lead = [np.argmax(Rd[i]) for i in range(r)]
    assert all(Rd[i, lead[i]] == 1 for i in range(r))
    assert all(lead[i] < lead[i + 1] for i in range(r - 1))
    # row-equivalent: same RREF
    np.testing.assert_array_equal(oracle.rref(Rd), oracle.rref(a))


@pytest.mark.parametrize("m,n", [(64, 64), (100, 150), (128, 90)])
def test_elimination_paths_agree(rng, m, n):
    """Independent engines must produce identical results (reference:
    test_elimination.c elim_test_equality compares 7 paths)."""
    from m4ri_jax.models.echelon import echelonize_pluq, top_echelonize
    a = random_dense(rng, m, n)
    A = m4.from_numpy(a)
    expect = oracle.rref(a)
    for path in [
        echelonize(A, full=True),
        echelonize(A, full=True, strategy="heuristic"),
        echelonize_pluq(A, full=True),
        top_echelonize(A),              # random matrices: window suffices
        top_echelonize(A, k=4),
    ]:
        R, r = path
        np.testing.assert_array_equal(m4.to_numpy(R), expect)
        assert int(r) == oracle.rank(a)
    # non-reduced paths agree with each other
    R1, r1 = echelonize(A, full=False)
    R2, r2 = echelonize_pluq(A, full=False)
    assert int(r1) == int(r2)
    np.testing.assert_array_equal(m4.to_numpy(R1), m4.to_numpy(R2))


def test_rank_only(rng):
    a = random_dense(rng, 150, 90)
    assert int(rank(m4.from_numpy(a))) == oracle.rank(a)
    assert int(rank(m4.from_numpy(np.zeros((10, 10), np.uint8)))) == 0
    assert int(rank(m4.identity(65))) == 65


# --- top_echelonize window semantics vs a reference-faithful model ------
# (VERDICT r2 #8: structured inputs stressing the 6k search window,
# checked against tests/ref_top_model.py, a bit-faithful Python port of
# _mzd_top_echelonize_m4ri, brilliantrussian.c:846-969.)

def _echelon_form(a):
    R, _ = echelonize(m4.from_numpy(a), full=False)
    return m4.to_numpy(R)


def test_top_echelonize_matches_reference_model_on_contract_inputs(rng):
    """The reference contract (brilliantrussian.h:229-232) is inputs in
    upper-triangular (echelon) form; there the restricted pivot search
    provably finds each pivot at row r.  Ours must match the faithful
    model bit-for-bit AND the unique RREF."""
    from ref_top_model import top_echelonize_model

    cases = []
    # random REF forms at several shapes/densities
    for (m_, n, d) in ((40, 60, 0.5), (70, 50, 0.2), (64, 64, 0.05)):
        cases.append(_echelon_form((rng.random((m_, n)) < d).astype(np.uint8)))
    # adversarial: huge pivot-column gaps (>> 6k) exercise the
    # kbar == 0 -> c++ skip path round after round
    g = np.zeros((8, 120), np.uint8)
    for i, c in enumerate([0, 29, 30, 61, 93, 94, 95, 119]):
        g[i, c] = 1
        g[i, c + 1:] = (rng.random(119 - c) < 0.5)
    cases.append(g)
    # rank-deficient with zero rows at the bottom
    rd = _echelon_form((rng.random((50, 40)) < 0.3).astype(np.uint8))
    cases.append(rd)

    for a in cases:
        for k in (1, 2, 4):
            got, rg = top_echelonize(m4.from_numpy(a), k=k)
            want, rw = top_echelonize_model(a, k)
            np.testing.assert_array_equal(m4.to_numpy(got), want)
            assert int(rg) == rw
            np.testing.assert_array_equal(want, oracle.rref(a))


def test_top_echelonize_out_of_contract_divergence_documented(rng):
    """On NON-echelon inputs whose pivots sit beyond the 6k window the
    reference's output is incidental (lazy partial updates, below-window
    rows never eliminated).  We deliberately do NOT replicate that: our
    canonical factorization keeps eliminating below the window, so our
    rank is >= the model's.  This test pins the divergence so it stays
    documented rather than silent."""
    from ref_top_model import top_echelonize_model

    a = (rng.random((48, 48)) < 0.15).astype(np.uint8)
    a[:20, :10] = 0  # push the early pivots >= 20 rows down (window 6)
    got, rg = top_echelonize(m4.from_numpy(a), k=1)
    want, rw = top_echelonize_model(a, 1)
    assert int(rg) >= rw
    # both sides remain self-consistent: on the CONTRACT form of the
    # same matrix they agree bit-for-bit again
    e = _echelon_form(a)
    got2, rg2 = top_echelonize(m4.from_numpy(e), k=1)
    want2, rw2 = top_echelonize_model(e, 1)
    np.testing.assert_array_equal(m4.to_numpy(got2), want2)
    assert int(rg2) == rw2
