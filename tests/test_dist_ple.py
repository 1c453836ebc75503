"""Distributed canonical PLE / TRSM / solve on the 8-device virtual mesh.

Unlike dist_echelon (lazy pivoting, reference-different P/Q), the dist_ple
family must be *bit-identical* to the single-chip engines — same canonical
pivot order, same P/Q swap arrays, same in-place layout — which these
tests pin directly against models/ple, models/triangular, models/solve."""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

import m4ri_jax as m4
from m4ri_jax.models.ple import block_factor, ple
from m4ri_jax.models.solve import solve_left
from m4ri_jax.models.triangular import (trsm_lower_left, trsm_lower_right,
                                        trsm_upper_left, trsm_upper_right)
from m4ri_jax.parallel.dist_ple import dist_block_factor, dist_ple
from m4ri_jax.parallel.dist_solve import (dist_solve_left,
                                          dist_trsm_lower_left,
                                          dist_trsm_lower_right,
                                          dist_trsm_upper_left,
                                          dist_trsm_upper_right)

import oracle
from conftest import random_dense

N_DEV = min(8, len(jax.devices()))


def mesh1d():
    return Mesh(np.array(jax.devices()[:N_DEV]).reshape(N_DEV, 1),
                ("x", "y"))


def mesh2d():
    import math
    rx = int(math.sqrt(N_DEV))
    while N_DEV % rx:
        rx -= 1
    return Mesh(np.array(jax.devices()[:N_DEV]).reshape(rx, N_DEV // rx),
                ("x", "y"))


def _cases(rng):
    yield "random", random_dense(rng, 180, 96)
    z = random_dense(rng, 200, 64)
    z[:100] = 0  # pivots beyond any small window -> slow branch
    yield "zero-top", z
    k = 20
    yield "low-rank", oracle.mul(random_dense(rng, 150, k),
                                 random_dense(rng, k, 96)).astype(np.uint8)
    yield "wide", random_dense(rng, 70, 200)


@pytest.mark.parametrize("preserve_l", [False, True])
def test_dist_block_factor_bit_identical(rng, preserve_l):
    mesh = mesh1d()
    for name, a_np in _cases(rng):
        A = m4.from_numpy(a_np)
        want = block_factor(A, preserve_l=preserve_l, nb=32, window=32,
                            engine="xla")
        got = dist_block_factor(A, mesh, preserve_l=preserve_l, nb=32,
                                window=32, engine="xla")
        for g, w, what in zip(got, want, ["data", "P", "Q", "rank"]):
            np.testing.assert_array_equal(
                np.asarray(g), np.asarray(w), err_msg=f"{name}: {what}")


@pytest.mark.parametrize("preserve_l", [False, True])
def test_dist_block_factor_gpu_kernels_interpret(rng, monkeypatch,
                                                 preserve_l):
    """The GPU path inside shard_map: the pivot-loop kernel replicated on
    every device and the product kernel for each shard's Schur update
    (both interpreted here) stay bit-identical to the local XLA engine."""
    from m4ri_jax.ops import gpu_mul
    from m4ri_jax.ops import mul as mulmod
    real = gpu_mul.gf2_mul_triton
    calls = []

    def interp(a, b, *args, **kw):
        calls.append(a.shape)
        return real(a, b, *args, **dict(kw, interpret=True))

    monkeypatch.setattr(gpu_mul, "gf2_mul_triton", interp)
    # the shard update takes mul_packed_data's shape gate: open it
    monkeypatch.setattr(mulmod, "use_product_kernel", lambda *_: True)
    mesh = mesh1d()
    a_np = random_dense(rng, 150, 96)
    a_np[10:60] = 0
    A = m4.from_numpy(a_np)
    want = block_factor(A, preserve_l=preserve_l, nb=32, window=64,
                        engine="xla")
    got = dist_block_factor(A, mesh, preserve_l=preserve_l, nb=32,
                            window=64, engine="triton_interpret")
    for g, w, what in zip(got, want, ["data", "P", "Q", "rank"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=what)
    assert calls, "the shard Schur update did not reach the kernel"


def test_dist_ple_matches_local(rng):
    mesh = mesh1d()
    a_np = random_dense(rng, 150, 100)
    A = m4.from_numpy(a_np)
    Mw, Pw, Qw, rw = ple(A, nb=32)
    Mg, Pg, Qg, rg = dist_ple(A, mesh, nb=32, window=64)
    assert int(rg) == int(rw)
    np.testing.assert_array_equal(m4.to_numpy(Mg), m4.to_numpy(Mw))
    np.testing.assert_array_equal(np.asarray(Pg), np.asarray(Pw))
    np.testing.assert_array_equal(np.asarray(Qg), np.asarray(Qw))


def test_dist_trsm_all_variants(rng):
    mesh = mesh2d()
    n, cols = 160, 96
    u = np.triu(random_dense(rng, n, n), 1)
    np.fill_diagonal(u, 1)
    l = u.T.copy()
    b = random_dense(rng, n, cols)
    bt = b.T.copy()
    for dist_fn, loc_fn, t, bb in [
        (dist_trsm_upper_left, trsm_upper_left, u, b),
        (dist_trsm_lower_left, trsm_lower_left, l, b),
        (dist_trsm_upper_right, trsm_upper_right, u, bt),
        (dist_trsm_lower_right, trsm_lower_right, l, bt),
    ]:
        got = dist_fn(m4.from_numpy(t), m4.from_numpy(bb), mesh)
        want = loc_fn(m4.from_numpy(t), m4.from_numpy(bb))
        np.testing.assert_array_equal(m4.to_numpy(got), m4.to_numpy(want),
                                      err_msg=dist_fn.__name__)


@pytest.mark.parametrize("m,n,cols", [(140, 140, 40), (160, 96, 32),
                                      (96, 160, 32)])
def test_dist_solve_left(rng, m, n, cols):
    mesh = mesh1d()
    # consistent system: B = A X0
    a_np = random_dense(rng, m, n)
    x0 = random_dense(rng, n, cols)
    b_np = oracle.mul(a_np, x0).astype(np.uint8)
    A, B = m4.from_numpy(a_np), m4.from_numpy(b_np)
    xg, okg = dist_solve_left(A, B, mesh, nb=32, window=64)
    xw, okw = solve_left(A, B, nb=32)
    assert bool(okg) and bool(okw)
    np.testing.assert_array_equal(m4.to_numpy(xg), m4.to_numpy(xw))
    # the solution actually solves the system
    np.testing.assert_array_equal(
        oracle.mul(a_np, m4.to_numpy(xg)).astype(np.uint8), b_np)


def test_dist_solve_inconsistent(rng):
    mesh = mesh1d()
    a_np = random_dense(rng, 96, 48)
    b_np = random_dense(rng, 96, 8)  # random RHS on a tall system
    if oracle.rank(np.concatenate([a_np, b_np], axis=1)) == \
            oracle.rank(a_np):
        b_np[0] ^= 1  # force inconsistency
    _, ok = dist_solve_left(m4.from_numpy(a_np), m4.from_numpy(b_np),
                            mesh, nb=32)
    _, ok_loc = solve_left(m4.from_numpy(a_np), m4.from_numpy(b_np), nb=32)
    assert bool(ok) == bool(ok_loc) == False  # noqa: E712


def test_dist_invert(rng):
    from m4ri_jax.parallel.dist_solve import dist_invert
    from m4ri_jax.models.echelon import invert
    mesh = mesh2d()
    # invertible: unit-lower times unit-upper
    n = 96
    l = np.tril(random_dense(rng, n, n), -1); np.fill_diagonal(l, 1)
    u = np.triu(random_dense(rng, n, n), 1); np.fill_diagonal(u, 1)
    a_np = oracle.mul(l, u).astype(np.uint8)
    A = m4.from_numpy(a_np)
    xd, rd = dist_invert(A, mesh, nb=32, window=64)
    xl, rl = invert(A, nb=32)
    assert int(rd) == int(rl) == n
    np.testing.assert_array_equal(m4.to_numpy(xd), m4.to_numpy(xl))
    np.testing.assert_array_equal(
        oracle.mul(a_np, m4.to_numpy(xd)), np.eye(n, dtype=np.uint8))
    # singular input reports rank < n
    s_np = oracle.mul(random_dense(rng, n, 10),
                      random_dense(rng, 10, n)).astype(np.uint8)
    _, rs = dist_invert(m4.from_numpy(s_np), mesh, nb=32, window=64)
    assert int(rs) < n


def test_dist_kernel_left(rng):
    from m4ri_jax.parallel.dist_solve import dist_kernel_left
    from m4ri_jax.models.solve import kernel_left
    mesh = mesh1d()
    a_np = oracle.mul(random_dense(rng, 120, 40),
                      random_dense(rng, 40, 150)).astype(np.uint8)
    A = m4.from_numpy(a_np)
    xd, cd = dist_kernel_left(A, mesh, nb=32, window=64)
    xl, cl = kernel_left(A, nb=32)
    assert int(cd) == int(cl)
    np.testing.assert_array_equal(m4.to_numpy(xd), m4.to_numpy(xl))
    assert not oracle.mul(a_np, m4.to_numpy(xd)).any()
