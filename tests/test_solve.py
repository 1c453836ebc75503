"""Solve and kernel tests (reference: tests/test_solve.c — A X == B when
consistent; tests/test_kernel.c — A X == 0; tests/test_invert.c —
A A^{-1} == I)."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.models.echelon import invert
from m4ri_jax.models.solve import kernel_left, solve_left

import oracle
from conftest import random_dense


@pytest.mark.parametrize("m,n,cols", [
    (32, 32, 8), (64, 64, 64), (100, 100, 17), (96, 64, 10), (64, 96, 12),
    (129, 129, 32),
])
def test_solve_consistent(rng, m, n, cols):
    a = random_dense(rng, m, n)
    x0 = random_dense(rng, n, cols)
    b = oracle.mul(a, x0).astype(np.uint8)
    X, ok = solve_left(m4.from_numpy(a), m4.from_numpy(b))
    assert bool(ok)
    np.testing.assert_array_equal(oracle.mul(a, m4.to_numpy(X)), b)


def test_solve_low_rank_consistent(rng):
    m, n, k = 80, 100, 20
    a = oracle.mul(random_dense(rng, m, k), random_dense(rng, k, n)).astype(
        np.uint8)
    b = oracle.mul(a, random_dense(rng, n, 5)).astype(np.uint8)
    X, ok = solve_left(m4.from_numpy(a), m4.from_numpy(b))
    assert bool(ok)
    np.testing.assert_array_equal(oracle.mul(a, m4.to_numpy(X)), b)


def test_solve_inconsistent(rng):
    # rank-deficient A with a RHS outside the column space
    m, n = 60, 40
    k = 10
    a = oracle.mul(random_dense(rng, m, k), random_dense(rng, k, n)).astype(
        np.uint8)
    rng2 = np.random.default_rng(3)
    while True:
        b = (rng2.random((m, 1)) < 0.5).astype(np.uint8)
        # ensure b not in colspace
        if oracle.rank(np.concatenate([a, b], axis=1)) > oracle.rank(a):
            break
    X, ok = solve_left(m4.from_numpy(a), m4.from_numpy(b))
    assert not bool(ok)


@pytest.mark.parametrize("m,n,k", [(40, 60, 10), (64, 64, 32), (100, 70, 20)])
def test_kernel(rng, m, n, k):
    a = oracle.mul(random_dense(rng, m, k), random_dense(rng, k, n)).astype(
        np.uint8)
    r = oracle.rank(a)
    X, count = kernel_left(m4.from_numpy(a))
    assert int(count) == n - r
    prod = oracle.mul(a, m4.to_numpy(X))
    assert not prod.any()
    assert oracle.rank(m4.to_numpy(X)) == n - r


def test_kernel_full_rank(rng):
    a = np.eye(30, dtype=np.uint8)
    X, count = kernel_left(m4.from_numpy(a))
    assert int(count) == 0
    assert not m4.to_numpy(X).any()


@pytest.mark.parametrize("n", [16, 64, 100, 129])
def test_invert(rng, n):
    # random invertible: unit_lower @ unit_upper with a row permutation
    l = np.tril(random_dense(rng, n, n), -1) ^ np.eye(n, dtype=np.uint8)
    u = np.triu(random_dense(rng, n, n), 1) ^ np.eye(n, dtype=np.uint8)
    a = oracle.mul(l, u).astype(np.uint8)
    perm = np.random.default_rng(5).permutation(n)
    a = a[perm]
    inv, r = invert(m4.from_numpy(a))
    assert int(r) == n
    np.testing.assert_array_equal(oracle.mul(a, m4.to_numpy(inv)),
                                  np.eye(n, dtype=np.uint8))


def test_invert_singular(rng):
    a = np.zeros((8, 8), np.uint8)
    a[0, 0] = 1
    inv, r = invert(m4.from_numpy(a))
    assert int(r) == 1
