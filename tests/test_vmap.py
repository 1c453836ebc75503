"""Batched (vmapped) operation coverage.

The functional BitMatrix design composes with jax transforms — a
capability the reference (in-place C buffers) structurally cannot offer.
Typical use: cryptanalytic sweeps over many small GF(2) systems at once.
These tests pin that the packed engines stay exact under jax.vmap (the
GPU kernels are excluded from batched traces via allow_kernels /
engine="xla"; XLA's batched dot is the right lowering there).
"""

import numpy as np

import jax
import jax.numpy as jnp

import m4ri_jax as m4
from m4ri_jax.core.bitmatrix import BitMatrix
from m4ri_jax.models.ple import block_factor
from m4ri_jax.ops.mul import mul_packed_data

import oracle
from conftest import random_dense


def _batch(rng, b, m, n):
    mats = np.stack([random_dense(rng, m, n) for _ in range(b)])
    packed = jnp.stack([m4.from_numpy(x).data for x in mats])
    return mats, packed


def test_vmap_mul(rng):
    b, m, k, n = 5, 96, 130, 64
    amats, apk = _batch(rng, b, m, k)
    bmats, bpk = _batch(rng, b, k, n)
    f = jax.vmap(lambda a, c: mul_packed_data(a, c, allow_kernels=False))
    out = np.asarray(f(apk, bpk))
    for i in range(b):
        got = m4.to_numpy(BitMatrix(jnp.asarray(out[i]), n))
        np.testing.assert_array_equal(got, oracle.mul(amats[i], bmats[i]),
                                      err_msg=f"batch element {i}")


def test_vmap_rank(rng):
    b, m, n = 4, 120, 90
    mats, packed = _batch(rng, b, m, n)
    mats[1][:] = 0  # a zero matrix in the batch
    packed = packed.at[1].set(0)

    def rank_of(data):
        _, _, _, r = block_factor(BitMatrix(data, n), preserve_l=False,
                                  engine="xla")
        return r

    ranks = np.asarray(jax.vmap(rank_of)(packed))
    for i in range(b):
        want = oracle.rank(mats[i])
        assert ranks[i] == want, (i, ranks[i], want)
