"""Native C++ oracle tests: the gf2core library must agree with both the
numpy oracle and the JAX engine (three-way cross-validation, the reference
test suite's core strategy), and its glibc RNG must match the Python one."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.native import build as native
from m4ri_jax.utils.rng import GlibcRandom, reference_random_data

import oracle
from conftest import random_dense

pytestmark = pytest.mark.skipif(native.load() is None,
                                reason="no C++ toolchain available")


def test_native_mul(rng):
    m, k, n = 100, 130, 70
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    A, B = m4.from_numpy(a), m4.from_numpy(b)
    c = native.native_mul(np.asarray(A.data), np.asarray(B.data), k, n)
    C = m4.from_packed(c, n)
    np.testing.assert_array_equal(m4.to_numpy(C), oracle.mul(a, b))
    # three-way: native == jax engine
    assert bool(m4.equal(C, m4.mul(A, B)))


def test_native_echelonize(rng):
    a = random_dense(rng, 60, 90)
    A = m4.from_numpy(a)
    out, r = native.native_echelonize(np.asarray(A.data), 90, full=True)
    assert r == oracle.rank(a)
    np.testing.assert_array_equal(m4.to_numpy(m4.from_packed(out, 90)),
                                  oracle.rref(a))


def test_native_rng_matches_python():
    lib = native.load()
    lib.gf2_srandom(17)
    g = GlibcRandom(17)
    for _ in range(100):
        assert lib.gf2_random_word() == g.random_word()


def test_native_randomize_matches_python():
    data = native.native_randomize(7, 100, seed=17)
    expect = reference_random_data(7, 100, seed=17)
    np.testing.assert_array_equal(data, expect)
