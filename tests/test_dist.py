"""Distributed (multi-device mesh) tests — run on the 8-device virtual CPU
mesh (conftest).  Reference analogue: tests of mzd_mul_mp vs serial paths in
test_multiplication.c; here the OpenMP 2x2 split became a 2-D SPMD mesh."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.parallel.dist_mul import mul_dist, mul_dist_ksplit
from m4ri_jax.parallel.mesh import make_mesh

import oracle
from conftest import random_dense


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(8)


@pytest.mark.parametrize("m,k,n", [(64, 64, 64), (128, 256, 192),
                                   (100, 130, 70), (257, 129, 65)])
def test_mul_dist_summa(rng, mesh, m, k, n):
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    C = mul_dist(m4.from_numpy(a), m4.from_numpy(b), mesh)
    np.testing.assert_array_equal(m4.to_numpy(C), oracle.mul(a, b))


@pytest.mark.parametrize("m,k,n", [(64, 256, 64), (96, 512, 160)])
def test_mul_dist_ksplit(rng, mesh, m, k, n):
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    C = mul_dist_ksplit(m4.from_numpy(a), m4.from_numpy(b), mesh)
    np.testing.assert_array_equal(m4.to_numpy(C), oracle.mul(a, b))


def test_mesh_shape(mesh):
    assert mesh.devices.size == 8


def test_dryrun_entry():
    import sys, os
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import __graft_entry__ as g
    fn, args = g.entry()
    import jax
    out = jax.jit(fn)(*args)
    assert out.shape == (2048, 64)
    g.dryrun_multichip(8)


def test_multihost_mesh_layout(rng, monkeypatch):
    """Simulated 2-host topology over the 8 virtual devices: the host
    axis must be the outer mesh rows — host-major layout — and the
    distributed engines must run unchanged over that mesh (their panel
    all-gathers then ride the inner, intra-host axis, SURVEY §5 'distributed
    backend')."""
    import jax
    from m4ri_jax.parallel.mesh import make_multihost_mesh
    monkeypatch.setattr(jax, "process_count", lambda: 2, raising=False)
    mesh = make_multihost_mesh()
    assert dict(mesh.shape) == {"x": 2, "y": 4}
    # rows = hosts: device ids 0..3 on host row 0, 4..7 on row 1
    ids = np.array([[d.id for d in row] for row in mesh.devices])
    np.testing.assert_array_equal(ids, np.arange(8).reshape(2, 4))
    a = random_dense(rng, 96, 128)
    b = random_dense(rng, 128, 64)
    C = mul_dist(m4.from_numpy(a), m4.from_numpy(b), mesh)
    np.testing.assert_array_equal(m4.to_numpy(C), oracle.mul(a, b))
    # factorization family over the host-major mesh (1-D row sharding
    # spanning both hosts)
    from jax.sharding import Mesh
    from m4ri_jax.parallel.dist_ple import dist_ple
    from m4ri_jax.models.ple import ple
    mesh1d = Mesh(mesh.devices.reshape(8, 1), ("x", "y"))
    sq = random_dense(rng, 96, 64)
    SQ = m4.from_numpy(sq)
    Mg, Pg, Qg, rg = dist_ple(SQ, mesh1d, nb=32, window=64)
    Mw, Pw, Qw, rw = ple(SQ, nb=32)
    assert int(rg) == int(rw)
    np.testing.assert_array_equal(m4.to_numpy(Mg), m4.to_numpy(Mw))
    np.testing.assert_array_equal(np.asarray(Pg), np.asarray(Pw))


def test_stretch_mul_262144_lowers(mesh):
    """The multi-host stretch config (BASELINE.json: mul n=262144) lowers
    end-to-end over the mesh: abstract AOT trace, no buffers allocated.
    Validates that the SUMMA sharding rules and all-gather collectives
    compose at the stretch size (3 operands = 25.8 GB packed), where each
    device holds only its blocks."""
    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, width_for
    n = 262144
    w = width_for(n)

    def f(ad, bd):
        return mul_dist(BitMatrix(ad, n), BitMatrix(bd, n), mesh).data

    spec = jax.ShapeDtypeStruct((n, w), jnp.uint32)
    lowered = jax.jit(f).lower(spec, spec)
    txt = lowered.as_text()
    assert "all-gather" in txt or "all_gather" in txt
