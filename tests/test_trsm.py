"""TRSM/TRTRI tests (reference: tests/test_trsm.c — all four variants,
verified by multiplying back)."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.models.triangular import (trsm_lower_left, trsm_lower_right,
                                        trsm_upper_left, trsm_upper_right,
                                        trtri_lower, trtri_upper)

import oracle
from conftest import random_dense


def unit_upper(rng, n):
    u = np.triu(random_dense(rng, n, n), 1)
    np.fill_diagonal(u, 1)
    return u.astype(np.uint8)


def unit_lower(rng, n):
    return unit_upper(rng, n).T.copy()


SIZES = [(17, 7), (57, 10), (64, 64), (100, 129), (129, 100), (600, 64)]


@pytest.mark.parametrize("n,cols", SIZES)
def test_trsm_upper_left(rng, n, cols):
    u = unit_upper(rng, n)
    b = random_dense(rng, n, cols)
    x = trsm_upper_left(m4.from_numpy(u), m4.from_numpy(b))
    np.testing.assert_array_equal(oracle.mul(u, m4.to_numpy(x)), b)


@pytest.mark.parametrize("n,cols", SIZES)
def test_trsm_lower_left(rng, n, cols):
    l = unit_lower(rng, n)
    b = random_dense(rng, n, cols)
    x = trsm_lower_left(m4.from_numpy(l), m4.from_numpy(b))
    np.testing.assert_array_equal(oracle.mul(l, m4.to_numpy(x)), b)


@pytest.mark.parametrize("n,rows", SIZES)
def test_trsm_upper_right(rng, n, rows):
    u = unit_upper(rng, n)
    b = random_dense(rng, rows, n)
    x = trsm_upper_right(m4.from_numpy(u), m4.from_numpy(b))
    np.testing.assert_array_equal(oracle.mul(m4.to_numpy(x), u), b)


@pytest.mark.parametrize("n,rows", SIZES)
def test_trsm_lower_right(rng, n, rows):
    l = unit_lower(rng, n)
    b = random_dense(rng, rows, n)
    x = trsm_lower_right(m4.from_numpy(l), m4.from_numpy(b))
    np.testing.assert_array_equal(oracle.mul(m4.to_numpy(x), l), b)


@pytest.mark.parametrize("n", [5, 33, 64, 200, 513, 700])
def test_trtri(rng, n):
    u = unit_upper(rng, n)
    ui = trtri_upper(m4.from_numpy(u))
    np.testing.assert_array_equal(oracle.mul(u, m4.to_numpy(ui)),
                                  np.eye(n, dtype=np.uint8))
    l = unit_lower(rng, n)
    li = trtri_lower(m4.from_numpy(l))
    np.testing.assert_array_equal(oracle.mul(l, m4.to_numpy(li)),
                                  np.eye(n, dtype=np.uint8))


@pytest.mark.parametrize("n", [64, 129, 600])
def test_trsm_ignores_opposite_triangle(rng, n):
    """The reference only reads the relevant triangle (e.g. mzd_pluq_solve_
    left passes the combined in-place L\\U matrix to TRSM), so junk in the
    opposite triangle must not change any result."""
    u = unit_upper(rng, n)
    junk = u | np.tril(random_dense(rng, n, n), -1)
    b = random_dense(rng, n, 32)
    for fn, mat, dirty in [
        (trsm_upper_left, u, junk),
        (trsm_lower_left, u.T.copy(), junk.T.copy()),
        (trsm_upper_right, u, junk),
        (trsm_lower_right, u.T.copy(), junk.T.copy()),
    ]:
        bb = b if "left" in fn.__name__ else b.T.copy()
        clean = m4.to_numpy(fn(m4.from_numpy(mat), m4.from_numpy(bb)))
        noisy = m4.to_numpy(fn(m4.from_numpy(dirty), m4.from_numpy(bb)))
        np.testing.assert_array_equal(clean, noisy, err_msg=fn.__name__)
    np.testing.assert_array_equal(
        m4.to_numpy(trtri_upper(m4.from_numpy(u))),
        m4.to_numpy(trtri_upper(m4.from_numpy(junk))))
    np.testing.assert_array_equal(
        m4.to_numpy(trtri_lower(m4.from_numpy(u.T.copy()))),
        m4.to_numpy(trtri_lower(m4.from_numpy(junk.T.copy()))))
