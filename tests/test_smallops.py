"""Container + row/col op tests (reference: tests/test_smallops.c,
test_colswap.c, test_misc.c semantics — including the padding-discipline
checks that mirror the reference's pattern fixture, tests/testing.c:3-37)."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.core import bitmatrix as bm

from conftest import random_dense

SIZES = [(1, 1), (1, 31), (3, 32), (7, 33), (17, 64), (64, 64), (65, 97),
         (128, 130), (200, 67), (63, 257)]


@pytest.mark.parametrize("m,n", SIZES)
def test_pack_roundtrip(rng, m, n):
    a = random_dense(rng, m, n)
    A = m4.from_numpy(a)
    assert A.data.dtype == np.uint32
    np.testing.assert_array_equal(m4.to_numpy(A), a)
    # padding discipline: bits >= ncols must be zero
    mask = bm.padding_mask(n)
    assert np.all((np.asarray(A.data) & ~mask[None, :]) == 0)


@pytest.mark.parametrize("m,n", SIZES)
def test_add_equal(rng, m, n):
    a, b = random_dense(rng, m, n), random_dense(rng, m, n)
    C = m4.add(m4.from_numpy(a), m4.from_numpy(b))
    np.testing.assert_array_equal(m4.to_numpy(C), a ^ b)
    assert bool(m4.equal(m4.from_numpy(a), m4.from_numpy(a)))
    if (a != b).any():
        assert not bool(m4.equal(m4.from_numpy(a), m4.from_numpy(b)))
    assert bool(m4.is_zero(m4.add(m4.from_numpy(a), m4.from_numpy(a))))


def test_identity():
    I = m4.identity(67)
    np.testing.assert_array_equal(m4.to_numpy(I), np.eye(67, dtype=np.uint8))


@pytest.mark.parametrize("r0,c0,r1,c1", [
    (0, 0, 5, 5), (2, 3, 17, 40), (0, 32, 10, 64), (1, 33, 20, 97),
    (5, 1, 6, 130), (0, 63, 64, 65),
])
def test_submatrix(rng, r0, c0, r1, c1):
    a = random_dense(rng, 64, 130)
    S = m4.submatrix(m4.from_numpy(a), r0, c0, r1, c1)
    np.testing.assert_array_equal(m4.to_numpy(S), a[r0:r1, c0:c1])


@pytest.mark.parametrize("m,n1,n2", [(4, 5, 7), (8, 32, 32), (10, 33, 31),
                                     (16, 65, 97), (3, 1, 128)])
def test_stack_concat(rng, m, n1, n2):
    a, b = random_dense(rng, m, n1), random_dense(rng, m, n2)
    C = m4.concat(m4.from_numpy(a), m4.from_numpy(b))
    np.testing.assert_array_equal(m4.to_numpy(C), np.concatenate([a, b], 1))
    c, d = random_dense(rng, m, n1), random_dense(rng, 2 * m, n1)
    S = m4.stack(m4.from_numpy(c), m4.from_numpy(d))
    np.testing.assert_array_equal(m4.to_numpy(S), np.concatenate([c, d], 0))


@pytest.mark.parametrize("n", [5, 32, 33, 64, 100])
def test_colswap(rng, n):
    a = random_dense(rng, 20, n)
    for (i, j) in [(0, n - 1), (1, 1), (n // 2, n // 3)]:
        B = m4.col_swap(m4.from_numpy(a), i, j)
        expect = a.copy()
        expect[:, [i, j]] = expect[:, [j, i]]
        np.testing.assert_array_equal(m4.to_numpy(B), expect)


def test_rowswap_readwrite(rng):
    a = random_dense(rng, 10, 70)
    B = m4.row_swap(m4.from_numpy(a), 2, 7)
    expect = a.copy()
    expect[[2, 7]] = expect[[7, 2]]
    np.testing.assert_array_equal(m4.to_numpy(B), expect)
    assert int(m4.read_bit(m4.from_numpy(a), 3, 69)) == a[3, 69]
    C = m4.write_bit(m4.from_numpy(a), 3, 69, 1 - a[3, 69])
    assert int(m4.read_bit(C, 3, 69)) == 1 - a[3, 69]


def test_density(rng):
    a = random_dense(rng, 100, 200, density=0.3)
    d = float(m4.density(m4.from_numpy(a)))
    assert abs(d - a.mean()) < 1e-5
