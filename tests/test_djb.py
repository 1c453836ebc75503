"""DJB linear-map tests (reference: tests/test_djb.c — compiled map applied
to V must equal the M4RM product A*V)."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.models.djb import djb_apply, djb_compile

import oracle
from conftest import random_dense


@pytest.mark.parametrize("m,n", [(8, 8), (32, 17), (64, 64), (100, 130)])
def test_djb_matches_mul(rng, m, n):
    a = random_dense(rng, m, n)
    v = random_dense(rng, n, 40)
    prog = djb_compile(m4.from_numpy(a))
    W = djb_apply(prog, m4.from_numpy(v))
    np.testing.assert_array_equal(m4.to_numpy(W), oracle.mul(a, v))


def test_djb_op_count(rng):
    """The whole point: fewer XORs than the dense m*n bound."""
    m = n = 128
    a = random_dense(rng, m, n)
    prog = djb_compile(m4.from_numpy(a))
    dense_ops = int(a.sum())
    assert prog.length < dense_ops
    # heuristic bound with slack: (m n)/(log m - loglog m) ~ 3277 for 128^2
    assert prog.length < dense_ops * 0.75


def test_djb_zero_and_identity():
    z = m4.from_numpy(np.zeros((5, 5), np.uint8))
    prog = djb_compile(z)
    W = djb_apply(prog, m4.from_numpy(np.eye(5, dtype=np.uint8)))
    assert not m4.to_numpy(W).any()
    e = m4.from_numpy(np.eye(6, dtype=np.uint8))
    v = np.random.default_rng(0).integers(0, 2, (6, 9)).astype(np.uint8)
    W = djb_apply(djb_compile(e), m4.from_numpy(v))
    np.testing.assert_array_equal(m4.to_numpy(W), v)
