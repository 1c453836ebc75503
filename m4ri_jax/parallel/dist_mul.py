"""Distributed GF(2) multiplication over a device mesh.

Reference analogue: mzd_mul_mp (mp.c:39-160) — a 2x2 OpenMP block split, the
reference's entire multi-processor story.  Here the same block decomposition
runs SPMD over an arbitrary (R x C) jax.sharding.Mesh:

- ``mul_dist``   : one-shot SUMMA — A row-panels all-gathered along the "y"
  axis, B column-panels all-gathered along "x", one local multiply per
  device; C comes out block-sharded (x, y).
- ``mul_dist_ksplit``: depth-sharded variant — each device multiplies a k-slab
  and the packed partial parities are XOR-reduced along "x"
  (parity(a+b) = parity(a)^parity(b), so depth partials combine by XOR).

Both keep every word-aligned block padded to the mesh shape; padding is zero
and therefore exact over GF(2).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..core.bitmatrix import BitMatrix, width_for
from ..ops.mul import mul_packed_data
from ..utils.config import WORD_BITS
from .mesh import xor_allgather_reduce

__all__ = ["mul_dist", "mul_dist_ksplit"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pad2(data, rows, cols):
    return jnp.pad(data, ((0, rows - data.shape[0]), (0, cols - data.shape[1])))


# Jitted with the mesh static: called eagerly, a shard_map of a fresh
# closure is traced and compiled again on every call.
@functools.partial(jax.jit, static_argnames=("mesh",))
def mul_dist(a: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    """C = A*B with A,B,C block-sharded over a 2-D mesh (SUMMA all-gather)."""
    assert a.ncols == b.nrows
    rx = mesh.shape["x"]
    ry = mesh.shape["y"]
    m = _round_up(a.nrows, rx)
    kw = _round_up(a.width, ry)
    k = _round_up(b.nrows, rx * WORD_BITS)
    kw = max(kw, width_for(k))
    kw = _round_up(kw, ry)
    nw = _round_up(b.width, ry)

    ad = _pad2(a.data, m, kw)
    bd = _pad2(b.data, k, nw)

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P("x", "y"), P("x", "y")), out_specs=P("x", "y"))
    def summa(a_blk, b_blk):
        a_row = jax.lax.all_gather(a_blk, "y", axis=1, tiled=True)
        b_col = jax.lax.all_gather(b_blk, "x", axis=0, tiled=True)
        return mul_packed_data(a_row, b_col)

    out = summa(ad, bd)
    return BitMatrix(out[: a.nrows, : b.width], b.ncols)


@functools.partial(jax.jit, static_argnames=("mesh",))
def mul_dist_ksplit(a: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    """C = A*B with the contraction dimension sharded along "x" and packed
    partial parities XOR-reduced (depth-parallel variant)."""
    assert a.ncols == b.nrows
    rx = mesh.shape["x"]
    ry = mesh.shape["y"]
    k = _round_up(b.nrows, rx * WORD_BITS)
    kw = width_for(k)
    kw = _round_up(kw, rx)
    k = kw * WORD_BITS
    m = a.nrows
    nw = _round_up(b.width, ry)

    ad = _pad2(a.data, m, kw)
    bd = _pad2(b.data, k, nw)

    @functools.partial(
        jax.shard_map, mesh=mesh, check_vma=False,
        in_specs=(P(None, "x"), P("x", "y")), out_specs=P(None, "y"))
    def ksplit(a_blk, b_blk):
        partial = mul_packed_data(a_blk, b_blk)
        return xor_allgather_reduce(partial, "x")

    out = ksplit(ad, bd)
    return BitMatrix(out[:m, : b.width], b.ncols)
