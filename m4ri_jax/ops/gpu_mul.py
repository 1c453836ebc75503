"""Packed GF(2) product kernel for the GPU (Pallas through Triton).

``C (^)= A @ B`` over GF(2) with packed uint32 operands in and out.  One
program owns a (bm rows) x (bnw output words) tile of C and walks the
contraction in bkw-word steps: each step unpacks its A and B tiles to 0/1
int8 on chip (shift + mask + reshape), multiplies them on the tensor
cores with exact int32 accumulation, and the epilogue takes the parity
and packs 32 result bits per word (shift + sum of disjoint bits).  The
plain XLA route (ops/mul.py) instead writes the whole int32 product to
device memory — 32 bytes of intermediate per packed output byte — and
reads it back to pack.

Runtime bounds (r0, c0w) serve the panel factorization's Schur update
C ^= Lp @ Up, whose multiplier rows above the current rank and whose
update columns left of the trailing edge are zero: tiles entirely above
row r0 or left of word c0w return at once, and C is aliased to the
output so they cost nothing.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..utils.config import WORD_BITS

__all__ = ["gf2_mul_triton", "TILE"]

# (bm rows, bnw output words, bkw contraction words, num_warps): a
# 128 x 256-bit output tile, 128-bit contraction steps, 8 warps
TILE = (128, 8, 4, 8)


def _unpack_cols(words, rows: int, nw: int):
    """uint32 (rows, nw) -> int8 (rows, nw*32) of 0/1, bit b of word w at
    column 32*w + b."""
    sh = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    bits = (words[:, :, None] >> sh[None, None, :]) & jnp.uint32(1)
    return bits.reshape(rows, nw * WORD_BITS).astype(jnp.int8)


def _kernel(bounds_ref, a_ref, b_ref, *rest, n_k, bm, bnw, bkw):
    o_ref = rest[-1]
    i, j = pl.program_id(0), pl.program_id(1)
    row0, word0 = i * bm, j * bnw
    bk = bkw * WORD_BITS

    @pl.when((row0 + bm > bounds_ref[0]) & (word0 + bnw > bounds_ref[1]))
    def _():
        def step(t, acc):
            a = a_ref[pl.ds(row0, bm), pl.ds(t * bkw, bkw)]
            b = b_ref[pl.ds(t * bk, bk), pl.ds(word0, bnw)]
            return acc + jax.lax.dot(_unpack_cols(a, bm, bkw),
                                     _unpack_cols(b, bk, bnw),
                                     preferred_element_type=jnp.int32)

        acc = jax.lax.fori_loop(
            0, n_k, step, jnp.zeros((bm, bnw * WORD_BITS), jnp.int32))
        sh = jnp.arange(WORD_BITS, dtype=jnp.uint32)
        bits = (acc & 1).astype(jnp.uint32).reshape(bm, bnw, WORD_BITS)
        packed = jnp.sum(bits << sh[None, None, :], axis=2,
                         dtype=jnp.uint32)
        if len(rest) == 2:  # accumulate into C
            packed = packed ^ rest[0][pl.ds(row0, bm), pl.ds(word0, bnw)]
        o_ref[pl.ds(row0, bm), pl.ds(word0, bnw)] = packed


def _pad_to(x, rows: int, cols: int):
    pr, pc = rows - x.shape[0], cols - x.shape[1]
    return jnp.pad(x, ((0, pr), (0, pc))) if pr or pc else x


@functools.partial(jax.jit, static_argnames=("tile", "interpret"))
def gf2_mul_triton(a, b, c=None, r0=0, c0w=0, *, tile=TILE,
                   interpret: bool = False):
    """Packed uint32[m, kw] x uint32[k, nw] -> uint32[m, nw] over GF(2),
    XORed into ``c`` when given.

    Requires B's padding bits to be zero (BitMatrix invariant); A's
    padding lanes meet B rows >= k, which are zero-padded here.  With
    ``c``, rows < r0 of ``a`` and word columns < c0w of ``b`` must be
    zero (the Schur-update contract): those output tiles keep ``c``.
    Ragged shapes are zero-padded to whole tiles; the panel
    factorization's shapes are tile multiples and pass through as is."""
    m, kw = a.shape
    _, nw = b.shape
    bm, bnw, bkw, warps = tile
    mp, kwp, nwp = pl.cdiv(m, bm) * bm, pl.cdiv(kw, bkw) * bkw, \
        pl.cdiv(nw, bnw) * bnw
    if c is None:
        r0 = c0w = 0  # no C to keep: every tile is computed
    args = [jnp.stack([jnp.asarray(r0, jnp.int32),
                       jnp.asarray(c0w, jnp.int32)]),
            _pad_to(a, mp, kwp), _pad_to(b, kwp * WORD_BITS, nwp)]
    if c is not None:
        args.append(_pad_to(c, mp, nwp))
    out = pl.pallas_call(
        functools.partial(_kernel, n_k=kwp // bkw, bm=bm, bnw=bnw, bkw=bkw),
        out_shape=jax.ShapeDtypeStruct((mp, nwp), jnp.uint32),
        grid=(mp // bm, nwp // bnw),
        input_output_aliases={3: 0} if c is not None else {},
        compiler_params=pltriton.CompilerParams(num_warps=warps,
                                                num_stages=2),
        interpret=interpret,
        name="gf2_mul",
    )(*args)
    return out[:m, :nw] if (mp, nwp) != (m, nw) else out
