"""M4RM Gray-table engine tests (reference: test_multiplication.c compares
M4RM against naive and Strassen) and Gray-code table tests."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.ops.m4rm import addmul_m4rm, mul_m4rm
from m4ri_jax.utils.graycode import codebook, gray_code, opt_k

import oracle
from conftest import random_dense


@pytest.mark.parametrize("m,k,n", [(7, 9, 11), (64, 64, 64), (65, 97, 129),
                                   (128, 200, 77), (256, 256, 256)])
def test_mul_m4rm(rng, m, k, n):
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    C = mul_m4rm(m4.from_numpy(a), m4.from_numpy(b))
    np.testing.assert_array_equal(m4.to_numpy(C), oracle.mul(a, b))


@pytest.mark.parametrize("kparam", [1, 4, 8, 11])
def test_mul_m4rm_k_values(rng, kparam):
    a = random_dense(rng, 100, 130)
    b = random_dense(rng, 130, 64)
    C = mul_m4rm(m4.from_numpy(a), m4.from_numpy(b), k=kparam)
    np.testing.assert_array_equal(m4.to_numpy(C), oracle.mul(a, b))


def test_addmul_m4rm(rng):
    a = random_dense(rng, 50, 70)
    b = random_dense(rng, 70, 90)
    c = random_dense(rng, 50, 90)
    D = addmul_m4rm(m4.from_numpy(c), m4.from_numpy(a), m4.from_numpy(b))
    np.testing.assert_array_equal(m4.to_numpy(D), c ^ oracle.mul(a, b))


def test_m4rm_agrees_with_mxu(rng):
    a = random_dense(rng, 129, 257)
    b = random_dense(rng, 257, 100)
    A, B = m4.from_numpy(a), m4.from_numpy(b)
    assert bool(m4.equal(mul_m4rm(A, B), m4.mul(A, B)))


def test_gray_code_properties():
    # successive Gray codes differ in exactly one bit
    for k in [1, 3, 8]:
        codes = [gray_code(i, k) for i in range(1 << k)]
        assert sorted(codes) == list(range(1 << k))
        for i in range(1, len(codes)):
            assert bin(codes[i] ^ codes[i - 1]).count("1") == 1


def test_codebook_inc():
    """inc[i] must be the index of the bit that changes from ord[i] to
    ord[i+1] (this is what the reference's incremental table build relies
    on, mzd_make_table brilliantrussian.c:163-211)."""
    for k in [2, 4, 6]:
        ord_, inc = codebook(k)
        for i in range((1 << k) - 1):
            assert ord_[i] ^ ord_[i + 1] == 1 << inc[i]


def test_opt_k():
    assert 1 <= opt_k(64, 64) <= 16
    assert opt_k(65536, 65536) >= 8
