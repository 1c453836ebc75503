"""Triangular solve (TRSM, 4 variants) and triangular inverse (TRTRI).

Reference analogue: triangular.c (recursive 2x2 TRSM in all four
upper/lower x left/right variants, base cases via parity dot products or
Gray-code tables, triangular_russian.c) and mzd_trtri_upper
(triangular.c:518-546).

Design: over GF(2) an invertible triangular matrix is unit
triangular, i.e. T = I + N with N strictly triangular and nilpotent, so

    T^{-1} = I + N + N^2 + ... = prod_k (I + N^(2^k))

which we evaluate with log2(n) GF(2) matmuls — the *entire* sequential
substitution of the reference's base cases collapses into a handful of
matrix products.  TRTRI recurses 2x2 on word-aligned halves ([A B; 0 D]^{-1} =
[Ai, Ai B Di; 0, Di]); TRSM variants are then single multiplications by the
inverse, keeping all O(n^3) work on the matrix units.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..ops.mul import mul, mul_packed_data
from ..utils.config import WORD_BITS

__all__ = ["trtri_upper", "trtri_lower", "trsm_upper_left",
           "trsm_lower_left", "trsm_upper_right", "trsm_lower_right"]

_BASE = 512
# Wide-B TRSM substitutes down to this size before switching to
# TRTRI+mul: the substitution recursion does ~n^3+2n^3/2^d bit-ops vs
# ~2.67 n^3 for the full inverse.
_WIDE_BASE = 4096


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _clean_tri(t: BitMatrix, upper: bool) -> BitMatrix:
    """Mask the input to the relevant (inclusive) triangle.  The reference
    TRSM/TRTRI routines only ever *read* that triangle (e.g.
    _mzd_trsm_upper_right_trtri first takes mzd_extract_u, and
    mzd_pluq_solve_left hands the combined L\\U in-place matrix straight to
    TRSM), so junk in the opposite triangle must not leak into the
    nilpotent-series inverse."""
    from ..core.bitops import _triangle_mask
    return BitMatrix(t.data & _triangle_mask(t.ncols, upper), t.ncols)


def _identity_data(n: int) -> jnp.ndarray:
    from ..core.bitmatrix import identity
    return identity(n).data


def _tri_inv_base(tdata: jnp.ndarray, n: int) -> jnp.ndarray:
    """Invert unit-triangular packed n x n via the nilpotent series."""
    eye = _identity_data(n)
    nil = tdata ^ eye
    s = tdata  # I + N: covers N^0, N^1
    p = nil
    steps = max(0, (n - 1).bit_length() - 1)
    for _ in range(steps):
        p = mul_packed_data(p, p)  # N^(2^k) squared
        s = s ^ mul_packed_data(p, s)
    return s


def _split(n: int) -> int:
    return _round_up(n // 2, WORD_BITS)


def _trtri(t: BitMatrix, upper: bool, mul_fn=None) -> BitMatrix:
    """2x2 word-aligned recursion; ``mul_fn`` lets the distributed layer
    reuse the same structure with SUMMA mesh products
    (parallel/dist_solve.py)."""
    if mul_fn is None:
        mul_fn = mul
    n = t.ncols
    assert t.nrows == n
    if n <= _BASE:
        return mask_padding(BitMatrix(_tri_inv_base(t.data, n), n))
    n1 = _split(n)
    w1 = n1 // WORD_BITS
    from ..core.bitmatrix import submatrix
    a = submatrix(t, 0, 0, n1, n1)
    d = submatrix(t, n1, n1, n, n)
    ai = _trtri(a, upper, mul_fn)
    di = _trtri(d, upper, mul_fn)
    if upper:
        b = submatrix(t, 0, n1, n1, n)
        tr = mul_fn(mul_fn(ai, b), di)  # Ai B Di (n1 x n2)
        top = jnp.concatenate([ai.data, tr.data], axis=1)
        bot = jnp.concatenate(
            [jnp.zeros((n - n1, w1), jnp.uint32), di.data], axis=1)
    else:
        c = submatrix(t, n1, 0, n, n1)
        bl = mul_fn(mul_fn(di, c), ai)  # Di C Ai (n2 x n1)
        top = jnp.concatenate(
            [ai.data, jnp.zeros((n1, width_for(n - n1)), jnp.uint32)], axis=1)
        bot = jnp.concatenate([bl.data, di.data], axis=1)
    return mask_padding(BitMatrix(jnp.concatenate([top, bot], axis=0), n))


def _trsm_left_rec(t: BitMatrix, b: BitMatrix, upper: bool,
                   mul_fn=None) -> BitMatrix:
    """Solve T X = B by 2x2 block substitution WITHOUT forming T^{-1}
    (the reference's actual TRSM recursion, triangular.c:396-516).  For a
    narrow B this costs O(n^2 ncols(B)) work instead of the O(n^3)
    full inverse — the dominant win for mzd_solve_left's 2 triangular
    solves.  Wide B substitutes down to _WIDE_BASE before inverting:
    the full-size TRTRI+mul costs ~2.67 n^3 bit-ops vs ~1.1 n^3 for
    the substitution."""
    if mul_fn is None:
        mul_fn = mul
    n = t.ncols
    wide = b.ncols * 4 >= n
    if n <= _BASE or (wide and n <= _WIDE_BASE):
        return mul_fn(_trtri(t, upper, mul_fn), b)
    n1 = _split(n)
    from ..core.bitmatrix import submatrix
    a = submatrix(t, 0, 0, n1, n1)
    d = submatrix(t, n1, n1, n, n)
    b_top = submatrix(b, 0, 0, n1, b.ncols)
    b_bot = submatrix(b, n1, 0, b.nrows, b.ncols)
    if upper:
        # [A B; 0 D] [X1; X2] = [R1; R2]
        x2 = _trsm_left_rec(d, b_bot, upper, mul_fn)
        off = submatrix(t, 0, n1, n1, n)
        r1 = BitMatrix(b_top.data ^ mul_fn(off, x2).data, b.ncols)
        x1 = _trsm_left_rec(a, r1, upper, mul_fn)
    else:
        # [A 0; C D] [X1; X2] = [R1; R2]
        x1 = _trsm_left_rec(a, b_top, upper, mul_fn)
        off = submatrix(t, n1, 0, n, n1)
        r2 = BitMatrix(b_bot.data ^ mul_fn(off, x1).data, b.ncols)
        x2 = _trsm_left_rec(d, r2, upper, mul_fn)
    return mask_padding(BitMatrix(
        jnp.concatenate([x1.data, x2.data], axis=0), b.ncols))


def _trsm_right_rec(t: BitMatrix, b: BitMatrix, upper: bool,
                    mul_fn=None) -> BitMatrix:
    """Solve X T = B by 2x2 block substitution (narrow-row B variant of
    the above; reference: triangular.c:41-111, 301-390).  Same wide-B
    substitution-to-_WIDE_BASE strategy as _trsm_left_rec."""
    if mul_fn is None:
        mul_fn = mul
    n = t.ncols
    wide = b.nrows * 4 >= n
    if n <= _BASE or (wide and n <= _WIDE_BASE):
        return mul_fn(b, _trtri(t, upper, mul_fn))
    n1 = _split(n)
    from ..core.bitmatrix import submatrix
    a = submatrix(t, 0, 0, n1, n1)
    d = submatrix(t, n1, n1, n, n)
    b_l = submatrix(b, 0, 0, b.nrows, n1)
    b_r = submatrix(b, 0, n1, b.nrows, n)
    if upper:
        # [X1 X2] [A B; 0 D] = [R1 R2]: X1 A = R1; X2 D = R2 + X1 B
        x1 = _trsm_right_rec(a, b_l, upper, mul_fn)
        off = submatrix(t, 0, n1, n1, n)
        r2 = BitMatrix(b_r.data ^ mul_fn(x1, off).data, n - n1)
        x2 = _trsm_right_rec(d, r2, upper, mul_fn)
    else:
        # [X1 X2] [A 0; C D] = [R1 R2]: X2 D = R2; X1 A = R1 + X2 C
        x2 = _trsm_right_rec(d, b_r, upper, mul_fn)
        off = submatrix(t, n1, 0, n, n1)
        r1 = BitMatrix(b_l.data ^ mul_fn(x2, off).data, n1)
        x1 = _trsm_right_rec(a, r1, upper, mul_fn)
    return mask_padding(BitMatrix(
        jnp.concatenate([x1.data, x2.data], axis=1), n))


# Public entry points are jitted: the recursion is O(log n) levels of
# multiplies, and un-jitted each would dispatch separately.


@jax.jit
def trtri_upper(t: BitMatrix) -> BitMatrix:
    """U^{-1} for unit upper triangular U (reference: mzd_trtri_upper)."""
    return _trtri(_clean_tri(t, True), True)


@jax.jit
def trtri_lower(t: BitMatrix) -> BitMatrix:
    """L^{-1} for unit lower triangular L."""
    return _trtri(_clean_tri(t, False), False)


@jax.jit
def trsm_upper_left(u: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Solve U X = B, i.e. X = U^{-1} B (reference: mzd_trsm_upper_left,
    triangular.c:457-516)."""
    assert u.nrows == u.ncols == b.nrows
    return _trsm_left_rec(_clean_tri(u, True), b, True)


@jax.jit
def trsm_lower_left(l: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Solve L X = B (reference: mzd_trsm_lower_left, triangular.c:396-451)."""
    assert l.nrows == l.ncols == b.nrows
    return _trsm_left_rec(_clean_tri(l, False), b, False)


@jax.jit
def trsm_upper_right(u: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Solve X U = B, i.e. X = B U^{-1} (reference: mzd_trsm_upper_right,
    triangular.c:41-111)."""
    assert u.nrows == u.ncols == b.ncols
    return _trsm_right_rec(_clean_tri(u, True), b, True)


@jax.jit
def trsm_lower_right(l: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Solve X L = B (reference: mzd_trsm_lower_right, triangular.c:301-390)."""
    assert l.nrows == l.ncols == b.ncols
    return _trsm_right_rec(_clean_tri(l, False), b, False)
