"""GF(2) matrix multiplication.

Two engines:

1. ``mul_naive`` — popcount/parity oracle (reference: mzd_mul_naive,
   mzd.c:1141-1254, built on m4ri_parity64, parity.h:80-125).  Used as the
   independent cross-validation algorithm in tests, exactly as the reference
   test suite cross-checks naive vs M4RM vs Strassen.

2. ``mul`` — the production engine.  Where the reference's workhorse is the
   M4RM Gray-code table algorithm (brilliantrussian.c:1032-1190, an
   O(n^3/log n) *bandwidth* algorithm designed for CPUs without matrix
   units), an accelerator's matrix units multiply small integers at a far
   higher rate: we unpack bit-words to int8 lanes, multiply with exact
   int32 accumulation, and take the parity of the accumulator —
   AND=multiply and XOR=add mod 2, so ``C = (A_int8 @ B_int8) & 1`` is the
   exact GF(2) product.  On the GPU, shapes where it pays run through a
   packed product kernel (ops/gpu_mul.py) that unpacks, multiplies and
   packs on chip; everywhere else the plain XLA route below unpacks in
   device memory.  Large operands are processed in row/depth blocks so
   unpacked operands and the int32 product stay bounded (reference
   analogue: __M4RI_MUL_BLOCKSIZE babystep/giantstep blocking, mzd.h:59);
   depth-block partial products combine by XOR since
   parity(a+b) = parity(a) ^ parity(b).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..core.transpose import transpose
from ..utils.config import WORD_BITS, get_config

__all__ = ["unpack_bits", "pack_bits", "mul_naive", "mul", "addmul",
           "mul_packed_data"]

_SHIFTS = np.arange(WORD_BITS, dtype=np.uint32)


def unpack_bits(data: jnp.ndarray, dtype=jnp.int8) -> jnp.ndarray:
    """uint32[m, w] -> dtype[m, w*32] of 0/1 lanes (column c at lane c)."""
    m, w = data.shape
    bits = (data[:, :, None] >> _SHIFTS[None, None, :]) & jnp.uint32(1)
    return bits.reshape(m, w * WORD_BITS).astype(dtype)


def pack_bits(bits: jnp.ndarray) -> jnp.ndarray:
    """0/1 integer [m, n] -> packed uint32[m, ceil(n/32)]."""
    m, n = bits.shape
    w = width_for(n)
    pad = w * WORD_BITS - n
    if pad:
        bits = jnp.pad(bits, ((0, 0), (0, pad)))
    u = bits.reshape(m, w, WORD_BITS).astype(jnp.uint32)
    return jnp.sum(u << _SHIFTS[None, None, :], axis=-1, dtype=jnp.uint32)


# Operand dtype of the plain route's unpacked dot: int8 accumulates
# exactly in int32.  bf16 and fp8-e4m3 also hold 0/1 exactly, but the
# public mul 16384 measured fastest with int8 on the H100 (PERF.md).
_DOT_DTYPE = jnp.int8


def _dot_parity(a_u: jnp.ndarray, b_u: jnp.ndarray) -> jnp.ndarray:
    """(unpacked A) @ (unpacked B) mod 2, packed; exact (int8 operands,
    int32 accumulation)."""
    p = jax.lax.dot_general(a_u, b_u, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    return pack_bits(p & 1)


# Deepest contraction (in words) the product kernel takes.  With every
# tile computed at m = n = 32768 on the H100 it beats the plain route 3x
# at k = 128, 2.2x at 256 (the GPU panel, i.e. the Schur update), 1.5x at
# 512, ties at 1024 and loses at 2048; at k = 256 it ties at m = n = 1024
# and wins 1.8x at 4096 (PERF.md).  Deeper products keep the plain route.
KERNEL_MAX_KW = 16


def use_product_kernel(m: int, kw: int, nw: int) -> bool:
    """Whether a packed product of this shape runs through the GPU kernel
    (ops/gpu_mul.py): chosen from the backend and the shape only."""
    return (jax.default_backend() == "gpu" and m >= 1024 and nw >= 32
            and kw <= KERNEL_MAX_KW)


def mul_packed_data(a_data: jnp.ndarray, b_data: jnp.ndarray,
                    cfg=None, allow_kernels: bool = True, c=None,
                    r0=0, c0w=0, interpret: bool = False) -> jnp.ndarray:
    """Packed uint32[m, kw] x uint32[k, nw] -> packed uint32[m, nw], XORed
    into ``c`` when it is given.

    Requires b_data padding bits to be zero (BitMatrix invariant).  The
    contraction runs over a_data's padded width; A's padding lanes are zero
    so the padded rows of B (all-zero) contribute nothing.

    With ``c``, rows < r0 of a_data and word columns < c0w of b_data must
    be zero (the panel factorization's Schur update): the product kernel
    then leaves those tiles of ``c`` untouched.

    ``allow_kernels=False`` pins the plain XLA route; callers that trace
    this under jax.vmap must pass it (a Pallas kernel's explicit tile
    indexing is not batch-lowered, and XLA's batched dot is the right
    tool there anyway).  ``interpret=True`` runs the kernel under the
    Pallas interpreter at any shape (tests ask for it explicitly).
    """
    if cfg is None:
        cfg = get_config()
    dt = _DOT_DTYPE
    m, kw = a_data.shape
    k, nw = b_data.shape
    kp = kw * WORD_BITS

    if allow_kernels and (interpret or use_product_kernel(m, kw, nw)):
        from .gpu_mul import gf2_mul_triton
        return gf2_mul_triton(a_data, b_data, c, r0, c0w,
                              interpret=interpret)
    if c is not None:
        return c ^ mul_packed_data(a_data, b_data, cfg, allow_kernels=False)

    def block_mul(a_blk, b_blk):
        a_u = unpack_bits(a_blk, dt)
        b_u = unpack_bits(b_blk, dt)
        if b_blk.shape[0] < a_blk.shape[1] * WORD_BITS:
            b_u = jnp.pad(
                b_u, ((0, a_blk.shape[1] * WORD_BITS - b_blk.shape[0]), (0, 0)))
        return _dot_parity(a_u, b_u)

    if max(m, kp, nw * WORD_BITS) <= cfg.mul_block_threshold:
        return block_mul(a_data, b_data)

    # Blocked path: XOR partial parities over depth blocks, tile rows.
    bm, bk = cfg.mul_block_m, cfg.mul_block_k
    bkw = bk // WORD_BITS
    out_rows = []
    for r0 in range(0, m, bm):
        r1 = min(r0 + bm, m)
        acc = jnp.zeros((r1 - r0, nw), jnp.uint32)
        for c0 in range(0, kw, bkw):
            c1 = min(c0 + bkw, kw)
            a_blk = a_data[r0:r1, c0:c1]
            b_blk = b_data[c0 * WORD_BITS : min(c1 * WORD_BITS, k), :]
            acc = acc ^ block_mul(a_blk, b_blk)
        out_rows.append(acc)
    return jnp.concatenate(out_rows, axis=0)


# Top-level jit wrappers for the public mul/addmul dispatch: one program
# per call instead of a stream of eager ops.  mul_packed_data itself stays
# un-jitted so in-jit callers (the PLE scan, TRSM recursions) keep XLA's
# cross-op fusion.
@jax.jit
def _mul_small_jit(a_data, b_data):
    return mul_packed_data(a_data, b_data)


@jax.jit
def _addmul_small_jit(c_data, a_data, b_data):
    return c_data ^ mul_packed_data(a_data, b_data)


def _is_sqr(a: BitMatrix, b: BitMatrix) -> bool:
    """Same-operand detection (reference: mzd_mul dispatches A == B to the
    squaring specialization, strassen.c:358-364).  In the functional world
    'the same matrix' means the same underlying buffer."""
    return a.data is b.data or a is b


def mul(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """C = A*B over GF(2) (reference API: mzd_mul, strassen.c:345)."""
    assert a.ncols == b.nrows, (a.shape, b.shape)
    from .strassen import strassen_mul_data, strassen_sqr_data
    cfg = get_config()
    if min(a.nrows, a.ncols, b.ncols) >= cfg.strassen_cutoff * 2:
        if _is_sqr(a, b):
            out = strassen_sqr_data(a.data, a.ncols)
        else:
            out = strassen_mul_data(a.data, b.data, a.nrows, a.ncols, b.ncols)
    else:
        out = _mul_small_jit(a.data, b.data)
    return BitMatrix(out, b.ncols)


def addmul(c: BitMatrix, a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """C += A*B (reference API: mzd_addmul, strassen.c:675): the Strassen
    range uses the fused-accumulate schedule (no full-product temporary);
    below it the XOR fuses into the product's epilogue under jit."""
    from .strassen import strassen_addmul_data, strassen_addsqr_data
    cfg = get_config()
    if min(a.nrows, a.ncols, b.ncols) >= cfg.strassen_cutoff * 2:
        if _is_sqr(a, b):
            out = strassen_addsqr_data(c.data, a.data, a.ncols)
        else:
            out = strassen_addmul_data(c.data, a.data, b.data,
                                       a.nrows, a.ncols, b.ncols)
        return BitMatrix(out, c.ncols)
    return BitMatrix(_addmul_small_jit(c.data, a.data, b.data), c.ncols)


def mul_naive(a: BitMatrix, b: BitMatrix, chunk: int = 1024) -> BitMatrix:
    """Cubic popcount-parity oracle (reference: mzd_mul_naive, mzd.c:1141).

    C[i, j] = parity(popcount_w(A[i, w] & B^T[j, w])).  Independent of the
    matrix-unit path — used for cross-validation.
    """
    assert a.ncols == b.nrows
    bt = transpose(b)  # (n, kw)
    m = a.nrows
    outs = []
    for r0 in range(0, m, chunk):
        blk = a.data[r0 : r0 + chunk]  # (mb, kw)
        cnt = jnp.sum(
            jax.lax.population_count(blk[:, None, :] & bt.data[None, :, :]),
            axis=-1, dtype=jnp.int32)
        outs.append(pack_bits(cnt & 1))
    return BitMatrix(jnp.concatenate(outs, axis=0), b.ncols)
