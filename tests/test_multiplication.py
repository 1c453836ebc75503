"""Multiplication tests (reference: tests/test_multiplication.c — equality of
independent algorithms over many sizes incl. non-square/odd).  Here the
independent algorithms are: numpy integer matmul mod 2 (oracle.py), the
popcount-parity naive engine, the matrix-unit unpack/int8 engine, and the
Strassen-Winograd recursion forced on top."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.ops.strassen import strassen_mul_data
from m4ri_jax.core.bitmatrix import BitMatrix, width_for

import oracle
from conftest import random_dense

CASES = [
    (1, 1, 1), (1, 32, 1), (7, 9, 11), (31, 32, 33), (64, 64, 64),
    (65, 97, 129), (128, 64, 200), (200, 129, 64), (256, 256, 256),
    (100, 200, 50), (512, 511, 513),
]


@pytest.mark.parametrize("m,k,n", CASES)
def test_mul_cross_validation(rng, m, k, n):
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    expect = oracle.mul(a, b)
    A, B = m4.from_numpy(a), m4.from_numpy(b)
    C_dev = m4.mul(A, B)
    C_naive = m4.mul_naive(A, B)
    np.testing.assert_array_equal(m4.to_numpy(C_dev), expect)
    np.testing.assert_array_equal(m4.to_numpy(C_naive), expect)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (129, 65, 200),
                                   (256, 192, 320), (300, 511, 257)])
def test_strassen_forced(rng, m, k, n):
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    A, B = m4.from_numpy(a), m4.from_numpy(b)
    out = strassen_mul_data(A.data, B.data, m, k, n, cutoff=32)
    C = BitMatrix(out, n)
    np.testing.assert_array_equal(m4.to_numpy(C), oracle.mul(a, b))
    assert out.shape == (m, width_for(n))


@pytest.mark.parametrize("m,k,n", [(33, 65, 97), (128, 128, 128)])
def test_addmul(rng, m, k, n):
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    c = random_dense(rng, m, n)
    D = m4.addmul(m4.from_numpy(c), m4.from_numpy(a), m4.from_numpy(b))
    np.testing.assert_array_equal(m4.to_numpy(D), c ^ oracle.mul(a, b))


def test_sqr(rng):
    a = random_dense(rng, 130, 130)
    A = m4.from_numpy(a)
    C = m4.mul(A, A)
    np.testing.assert_array_equal(m4.to_numpy(C), oracle.mul(a, a))


def test_mul_blocked_path(rng):
    """Exercise the depth/row-blocked big-operand path with tiny blocks."""
    from m4ri_jax.utils.config import Config
    from m4ri_jax.ops.mul import mul_packed_data
    a = random_dense(rng, 100, 200)
    b = random_dense(rng, 200, 90)
    cfg = Config(mul_block_threshold=64, mul_block_m=64, mul_block_k=64)
    A, B = m4.from_numpy(a), m4.from_numpy(b)
    out = mul_packed_data(A.data, B.data, cfg=cfg)
    np.testing.assert_array_equal(
        m4.to_numpy(m4.BitMatrix(out, 90)), oracle.mul(a, b))


@pytest.mark.parametrize("m,k,n,levels", [
    (150, 200, 170, 1), (256, 256, 256, 2), (130, 140, 120, 2),
    (260, 300, 280, 3)])
def test_strassen_addmul_schedule(rng, m, k, n, levels):
    """The fused-accumulate Winograd schedule (strassen.c:443-491) must
    equal C + A*B for ragged shapes across recursion depths."""
    from m4ri_jax.ops.strassen import strassen_addmul_data
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    c = random_dense(rng, m, n)
    A, B, C = m4.from_numpy(a), m4.from_numpy(b), m4.from_numpy(c)
    out = strassen_addmul_data(C.data, A.data, B.data, m, k, n,
                               cutoff=16, max_levels=levels)
    got = m4.to_numpy(m4.BitMatrix(out, n))
    np.testing.assert_array_equal(got, (c ^ oracle.mul(a, b)))


@pytest.mark.parametrize("n,levels", [(100, 1), (256, 2), (129, 2), (64, 3)])
def test_strassen_sqr_schedule(rng, n, levels):
    """Bodrato's squaring sequence (4 squarings + 3 products,
    strassen.c:210-343) must equal A*A bit for bit."""
    from m4ri_jax.ops.strassen import strassen_sqr_data
    a = random_dense(rng, n, n)
    A = m4.from_numpy(a)
    out = strassen_sqr_data(A.data, n, cutoff=8, max_levels=levels)
    got = m4.to_numpy(m4.BitMatrix(out, n))
    np.testing.assert_array_equal(got, oracle.mul(a, a))


@pytest.mark.parametrize("n,levels", [(100, 1), (256, 2), (129, 2)])
def test_strassen_addsqr_schedule(rng, n, levels):
    """C + A*A via the accumulate-squaring schedule (strassen.c:528-665)."""
    from m4ri_jax.ops.strassen import strassen_addsqr_data
    a = random_dense(rng, n, n)
    c = random_dense(rng, n, n)
    A, C = m4.from_numpy(a), m4.from_numpy(c)
    out = strassen_addsqr_data(C.data, A.data, n, cutoff=8, max_levels=levels)
    got = m4.to_numpy(m4.BitMatrix(out, n))
    np.testing.assert_array_equal(got, (c ^ oracle.mul(a, a)))


def test_mul_sqr_dispatch(rng):
    """mul(A, A) must route through the squaring specialization above the
    Strassen cutoff and still agree with the generic product."""
    from m4ri_jax.ops.strassen import strassen_mul_data, strassen_sqr_data
    a = random_dense(rng, 200, 200)
    A = m4.from_numpy(a)
    got = strassen_sqr_data(A.data, 200, cutoff=16, max_levels=2)
    want = strassen_mul_data(A.data, A.data, 200, 200, 200,
                             cutoff=16, max_levels=2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_strassen_auto_depth3_threshold():
    """The dispatch engages a third Strassen level only at min-dim >=
    strassen_depth3_min (round-5 measurement: 970 vs 886 Tbit-op/s at
    65536 with a donated carry; depth 2 still wins at 32768)."""
    from m4ri_jax.ops.strassen import _levels_for
    from m4ri_jax.utils.config import get_config
    cfg = get_config()
    big = cfg.strassen_depth3_min
    assert _levels_for(big, big, big, None) == 3
    assert _levels_for(big // 2, big // 2, big // 2, None) == 2
    assert _levels_for(big, big // 2, big, None) == 2
