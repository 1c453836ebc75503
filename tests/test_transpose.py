"""Transpose tests (reference: tests/test_transpose.c — T(T(A))==A over many
sizes straddling word and tile boundaries)."""

import numpy as np
import pytest

import m4ri_jax as m4

from conftest import random_dense

SIZES = [1, 2, 7, 17, 31, 32, 33, 63, 64, 65, 97, 128, 129, 255, 256, 257]


@pytest.mark.parametrize("m", [1, 5, 32, 33, 64, 100, 129])
@pytest.mark.parametrize("n", [1, 7, 32, 65, 128, 200])
def test_transpose_rect(rng, m, n):
    a = random_dense(rng, m, n)
    T = m4.transpose(m4.from_numpy(a))
    np.testing.assert_array_equal(m4.to_numpy(T), a.T)


@pytest.mark.parametrize("n", SIZES)
def test_double_transpose(rng, n):
    a = random_dense(rng, n, n)
    A = m4.from_numpy(a)
    TT = m4.transpose(m4.transpose(A))
    assert bool(m4.equal(TT, A))
