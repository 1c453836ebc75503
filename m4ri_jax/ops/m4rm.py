"""M4RM (Method of the Four Russians) multiplication — the Gray-table
engine, recast for matrix units.

Reference analogue: _mzd_mul_m4rm (brilliantrussian.c:1032-1190): for each
k-bit column slice of A, build a 2^k-row table of XOR combinations of k rows
of B by walking the Gray code, then process each row of A with 8 table
lookups + an 8-way XOR (xor_template.h).

Recast (the "embedding-lookup" framing):
- table build: the 2^k x n table is ``S @ B_slice`` where S is the constant
  2^k x k selector matrix whose row x is the bit pattern of x — i.e. ONE
  GF(2) matrix product per slice instead of a sequential Gray walk (the packed
  selector is literally ``arange(2^k)`` since bit j of word 0 is bit j of x);
- row processing: an index gather ``T[s, read_bits(A, :, s*k, k), :]``
  vectorized over all rows, XOR-accumulated over slices.

On dense operands the matrix-unit engine (ops/mul.py) is faster — the
gathers are memory-bandwidth-bound — but this engine does O(n^3/k) word
work instead of O(n^3) lane work, matches the reference algorithm exactly,
and wins when the matrix units are the scarce resource.  It is also the cross-validation sibling the
reference test suite expects (test_multiplication.c compares M4RM vs naive
vs Strassen).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bitmatrix import BitMatrix, width_for
from ..utils.config import WORD_BITS
from ..utils.graycode import opt_k
from .mul import mul_packed_data, unpack_bits

__all__ = ["mul_m4rm", "addmul_m4rm"]


def mul_m4rm(a: BitMatrix, b: BitMatrix, k: int = 0) -> BitMatrix:
    """C = A*B via Gray-code tables (reference API: mzd_mul_m4rm,
    brilliantrussian.c:999)."""
    return addmul_m4rm(None, a, b, k)


def addmul_m4rm(c: BitMatrix | None, a: BitMatrix, b: BitMatrix,
                k: int = 0) -> BitMatrix:
    assert a.ncols == b.nrows
    if k <= 0:
        k = min(opt_k(a.nrows, a.ncols, b.ncols), 12)
    cdata = c.data if c is not None \
        else jnp.zeros((a.nrows, b.width), jnp.uint32)
    out = _addmul_m4rm_impl(cdata, a.data, b.data, a.ncols, k)
    return BitMatrix(out, b.ncols)


@functools.partial(jax.jit, static_argnames=("kk", "k"))
def _addmul_m4rm_impl(cdata, adata, bdata, kk: int, k: int):
    """One jitted program per shape (eagerly, every op would dispatch
    on its own).

    Giant-step blocking (reference: __M4RI_MUL_BLOCKSIZE, mzd.h:59;
    brilliantrussian.c:1106-1111): tables for at most a ~256 MB block of
    slices are live at once — the reference blocks to keep tables
    L2-resident, here the same trick bounds device memory (an unblocked
    build is ~6 GB of tables at n=16384).  Within a block all slices gather from
    ONE flattened (cs*2^k, nw) table — a single embedding-style row
    lookup, the form XLA lowers to DMA gathers — then XOR-reduce over
    the slice axis."""
    m = adata.shape[0]
    nw = bdata.shape[1]
    nslices = (kk + k - 1) // k
    kk_pad = nslices * k

    # k-bit indices of every (row, slice): LSB-first within the slice.
    abits = unpack_bits(adata, jnp.uint8)
    if abits.shape[1] < kk_pad:
        abits = jnp.pad(abits, ((0, 0), (0, kk_pad - abits.shape[1])))
    abits = abits[:, :kk_pad].reshape(m, nslices, k).astype(jnp.int32)
    shifts = jnp.arange(k, dtype=jnp.int32)
    idx = jnp.sum(abits << shifts[None, None, :], axis=-1)  # (m, nslices)

    # Table build: T[s] = S @ B[s*k:(s+1)*k] — one GF(2) product per
    # slice; packed selector is literally arange(2^k) when k <= 32.
    sel = jnp.arange(1 << k, dtype=jnp.uint32)[:, None]
    bd = bdata
    if bd.shape[0] < kk_pad:
        bd = jnp.pad(bd, ((0, kk_pad - bd.shape[0]), (0, 0)))
    b3 = bd.reshape(nslices, k, nw)

    # block size: tables AND the gathered temp both bounded to ~256 MB
    budget = 1 << 28
    cs = max(1, min(budget // max(1, (1 << k) * nw * 4),
                    budget // max(1, m * nw * 4)))
    acc = cdata
    for s0 in range(0, nslices, cs):
        s1 = min(s0 + cs, nslices)
        # allow_kernels=False: a Pallas kernel's explicit tile indexing
        # is not batch-lowered; XLA's batched dot is the right tool for
        # these small selector products
        tb = jax.vmap(lambda bs: mul_packed_data(
            sel, bs, allow_kernels=False))(b3[s0:s1])   # (cs, 2^k, nw)
        tflat = tb.reshape(-1, nw)
        fidx = (idx[:, s0:s1]
                + (jnp.arange(s1 - s0, dtype=jnp.int32) << k)[None, :])
        g = jnp.take(tflat, fidx.reshape(-1), axis=0)  # (m*cs, nw)
        acc = acc ^ jnp.bitwise_xor.reduce(
            g.reshape(m, s1 - s0, nw), axis=1)
    return acc
