"""Strassen-Winograd multiplication over GF(2).

Reference analogue: strassen.c:41-208 (_mzd_mul_even, Bodrato/Winograd
schedule with 7 recursive products), plus the fused-accumulate schedule
(_mzd_addmul_even, strassen.c:367-526 — 21 steps, C quadrants updated in
place, never a full-size product temporary) and the squaring
specializations (_mzd_sqr_even / _mzd_addsqr_even, strassen.c:210-343,
528-665 — Bodrato's squaring-suited sequence: 4 recursive squarings + 3
multiplications).  Over GF(2), + and - coincide (XOR), so the operand sums
cost one fused elementwise pass each.  Where the reference peels odd sizes
with three M4RM cleanup products (strassen.c:170-204), we pad dimensions up
to the recursion alignment instead — zero padding is exact over GF(2) and
keeps every block aligned to the matrix units' tiles, which is better than
ragged peeling.

The base case is the matrix-unit multiply (ops/mul.py), so Strassen here is
a *FLOP reducer on top of the matrix units*: each level trades 1/8 of the
product work for
O(n^2) XOR traffic, profitable only for large n (cutoff in utils/config.py,
reference analogue __M4RI_STRASSEN_MUL_CUTOFF strassen.h:133-135).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.config import WORD_BITS, get_config
from .mul import mul_packed_data

__all__ = ["strassen_mul_data", "strassen_sqr_data", "strassen_addmul_data",
           "strassen_addsqr_data"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _split4(x: jnp.ndarray):
    r2, c2 = x.shape[0] // 2, x.shape[1] // 2
    return x[:r2, :c2], x[:r2, c2:], x[r2:, :c2], x[r2:, c2:]


def _join4(c11, c12, c21, c22):
    return jnp.concatenate(
        [jnp.concatenate([c11, c12], axis=1),
         jnp.concatenate([c21, c22], axis=1)], axis=0)


def _mul_rec(a: jnp.ndarray, b: jnp.ndarray, depth: int) -> jnp.ndarray:
    """a: uint32[M, K/32], b: uint32[K, N/32]; all dims split evenly on word
    boundaries for ``depth`` levels."""
    if depth == 0:
        return mul_packed_data(a, b)
    a11, a12, a21, a22 = _split4(a)
    b11, b12, b21, b22 = _split4(b)

    s1 = a21 ^ a22
    s2 = s1 ^ a11
    s3 = a11 ^ a21
    s4 = a12 ^ s2
    t1 = b12 ^ b11
    t2 = b22 ^ t1
    t3 = b22 ^ b12
    t4 = t2 ^ b21

    p1 = _mul_rec(a11, b11, depth - 1)
    p2 = _mul_rec(a12, b21, depth - 1)
    p3 = _mul_rec(s4, b22, depth - 1)
    p4 = _mul_rec(a22, t4, depth - 1)
    p5 = _mul_rec(s1, t1, depth - 1)
    p6 = _mul_rec(s2, t2, depth - 1)
    p7 = _mul_rec(s3, t3, depth - 1)

    u2 = p1 ^ p6
    u3 = u2 ^ p7
    u4 = u2 ^ p5
    c11 = p1 ^ p2
    c12 = u4 ^ p3
    c21 = u3 ^ p4
    c22 = u3 ^ p5
    return _join4(c11, c12, c21, c22)


def _addmul_rec(c: jnp.ndarray, a: jnp.ndarray, b: jnp.ndarray,
                depth: int) -> jnp.ndarray:
    """C + A*B with Bodrato's fused-accumulate schedule (reference:
    _mzd_addmul_even, strassen.c:443-491 steps 1-21): the 7 recursive
    products flow straight into the C quadrants and the single temporary U,
    so no level ever materializes a full-size product before accumulating
    (over GF(2), + and - are both XOR)."""
    if depth == 0:
        return c ^ mul_packed_data(a, b)
    a11, a12, a21, a22 = _split4(a)
    b11, b12, b21, b22 = _split4(b)
    c11, c12, c21, c22 = _split4(c)

    s = a22 ^ a21                                    # 1
    t = b22 ^ b21                                    # 2
    u = _mul_rec(s, t, depth - 1)                    # 3
    c22 = u ^ c22                                    # 4
    c12 = u ^ c12                                    # 5
    u = _mul_rec(a12, b21, depth - 1)                # 8   (U overwritten)
    c11 = c11 ^ u                                    # 9
    c11 = _addmul_rec(c11, a11, b11, depth - 1)      # 11
    s = s ^ a12                                      # 6
    t = t ^ b12                                      # 7
    u = _addmul_rec(u, s, t, depth - 1)              # 10  U = A12*B21 + S*T
    c12 = c12 ^ u                                    # 15
    s = a11 ^ s                                      # 12
    c12 = _addmul_rec(c12, s, b12, depth - 1)        # 14
    t = b11 ^ t                                      # 13
    c21 = _addmul_rec(c21, a21, t, depth - 1)        # 16
    s = a22 ^ a12                                    # 17
    t = b22 ^ b12                                    # 18
    u = _addmul_rec(u, s, t, depth - 1)              # 19
    c21 = c21 ^ u                                    # 20
    c22 = c22 ^ u                                    # 21
    return _join4(c11, c12, c21, c22)


def _sqr_rec(a: jnp.ndarray, depth: int) -> jnp.ndarray:
    """A*A with Bodrato's squaring-suited sequence (reference:
    _mzd_sqr_even, strassen.c:210-343): 4 recursive *squarings* + 3
    multiplications instead of 7 generic products — squarings reuse one
    operand, halving the operand-sum traffic."""
    if depth == 0:
        return mul_packed_data(a, a)
    a11, a12, a21, a22 = _split4(a)

    w = a22 ^ a12
    c21 = _sqr_rec(w, depth - 1)                     # (A22+A12)^2
    w = a22 ^ a21
    c22 = _sqr_rec(w, depth - 1)                     # (A22+A21)^2
    w = w ^ a12
    c11 = _sqr_rec(w, depth - 1)                     # (A22+A21+A12)^2
    w = w ^ a11                                      # full alternating sum
    c12 = _mul_rec(w, a12, depth - 1) ^ c22
    wmk = _mul_rec(a12, a21, depth - 1)
    c11 = c11 ^ wmk
    c12 = c11 ^ c12
    c11 = c21 ^ c11
    c21 = c11 ^ _mul_rec(a21, w, depth - 1)
    c22 = c22 ^ c11
    c11 = _sqr_rec(a11, depth - 1) ^ wmk             # A11^2 + A12*A21
    return _join4(c11, c12, c21, c22)


def _addsqr_rec(c: jnp.ndarray, a: jnp.ndarray, depth: int) -> jnp.ndarray:
    """C + A*A (reference: _mzd_addsqr_even, strassen.c:528-665): the
    squaring schedule with the quadrant results XORed into C as they
    form — no full-size square is materialized first."""
    if depth == 0:
        return c ^ mul_packed_data(a, a)
    a11, a12, a21, a22 = _split4(a)
    c11, c12, c21, c22 = _split4(c)

    # With P1 = (A22+A12)^2, P2 = (A22+A21)^2, P3 = (A22+A21+A12)^2,
    # S = A11+A12+A21+A22, M2 = A12*A21, the square's quadrants are
    #   Q11 = A11^2 + M2            Q12 = P2 + P3 + M2 + S*A12
    #   Q21 = P1 + P3 + M2 + A21*S  Q22 = P1 + P2 + P3 + M2
    w = a22 ^ a21
    u = _sqr_rec(w, depth - 1)                       # P2
    c22 = c22 ^ u
    c12 = c12 ^ u
    wmk = _mul_rec(a12, a21, depth - 1)              # M2
    c11 = _addsqr_rec(c11 ^ wmk, a11, depth - 1)     # Q11 done
    w = w ^ a12
    v = _sqr_rec(w, depth - 1) ^ wmk                 # P3 + M2
    c12 = c12 ^ v
    w = a11 ^ w                                      # S
    c12 = _addmul_rec(c12, w, a12, depth - 1)        # Q12 done
    v = v ^ _sqr_rec(a22 ^ a12, depth - 1)           # P1 + P3 + M2
    c21 = _addmul_rec(c21, a21, w, depth - 1) ^ v    # Q21 done
    c22 = c22 ^ v                                    # Q22 done
    return _join4(c11, c12, c21, c22)


def _levels_for(m: int, k: int, n: int, cutoff: int | None,
                max_levels: int | None = None) -> int:
    cfg = get_config()
    if cutoff is None:
        cutoff = cfg.strassen_cutoff
    if max_levels is None:
        max_levels = cfg.strassen_max_levels
        if min(m, k, n) >= cfg.strassen_depth3_min:
            max_levels = max(max_levels, 3)
    levels = 0
    while (min(m, k, n) >> (levels + 1) >= cutoff and levels < max_levels):
        levels += 1
    return levels


def _pad_ops(a_data, b_data, m, k, n, levels):
    align = WORD_BITS << levels
    mp = _round_up(m, 1 << levels)
    kp = _round_up(k, align)
    np_ = _round_up(n, align)
    a = jnp.pad(a_data, ((0, mp - m), (0, kp // WORD_BITS - a_data.shape[1])))
    b = jnp.pad(b_data, ((0, kp - k), (0, np_ // WORD_BITS - b_data.shape[1])))
    return a, b


@functools.partial(jax.jit, static_argnames=("m", "k", "n", "cutoff",
                                             "max_levels"))
def strassen_mul_data(a_data: jnp.ndarray, b_data: jnp.ndarray,
                      m: int, k: int, n: int,
                      cutoff: int | None = None,
                      max_levels: int | None = None) -> jnp.ndarray:
    """Packed GF(2) product with Strassen-Winograd recursion on top of the
    matrix-unit base multiply.  Returns uint32[m, ceil(n/32)]."""
    levels = _levels_for(m, k, n, cutoff, max_levels)
    if levels == 0:
        return mul_packed_data(a_data, b_data)
    a, b = _pad_ops(a_data, b_data, m, k, n, levels)
    c = _mul_rec(a, b, levels)
    return c[:m, : (n + WORD_BITS - 1) // WORD_BITS]


@functools.partial(jax.jit, static_argnames=("n", "cutoff", "max_levels"))
def strassen_sqr_data(a_data: jnp.ndarray, n: int,
                      cutoff: int | None = None,
                      max_levels: int | None = None) -> jnp.ndarray:
    """Packed GF(2) square A*A via the squaring-specialized recursion
    (reference API: mzd_mul with A == B dispatches to _mzd_sqr_even,
    strassen.c:361)."""
    levels = _levels_for(n, n, n, cutoff, max_levels)
    if levels == 0:
        return mul_packed_data(a_data, a_data)
    a, _ = _pad_ops(a_data, a_data, n, n, n, levels)
    # the row and column pads must agree for the square recursion
    np_ = _round_up(n, WORD_BITS << levels)
    a = jnp.pad(a, ((0, np_ - a.shape[0]), (0, 0)))
    c = _sqr_rec(a, levels)
    return c[:n, : (n + WORD_BITS - 1) // WORD_BITS]


@functools.partial(jax.jit, static_argnames=("m", "k", "n", "cutoff",
                                             "max_levels"))
def strassen_addmul_data(c_data: jnp.ndarray, a_data: jnp.ndarray,
                         b_data: jnp.ndarray, m: int, k: int, n: int,
                         cutoff: int | None = None,
                         max_levels: int | None = None) -> jnp.ndarray:
    """Packed C + A*B via the fused-accumulate schedule (reference API:
    mzd_addmul -> _mzd_addmul_even, strassen.c:675-705)."""
    levels = _levels_for(m, k, n, cutoff, max_levels)
    if levels == 0:
        return c_data ^ mul_packed_data(a_data, b_data)
    a, b = _pad_ops(a_data, b_data, m, k, n, levels)
    mp = a.shape[0]
    nw_p = b.shape[1]
    c = jnp.pad(c_data, ((0, mp - c_data.shape[0]),
                         (0, nw_p - c_data.shape[1])))
    out = _addmul_rec(c, a, b, levels)
    return out[:m, : (n + WORD_BITS - 1) // WORD_BITS]


@functools.partial(jax.jit, static_argnames=("n", "cutoff", "max_levels"))
def strassen_addsqr_data(c_data: jnp.ndarray, a_data: jnp.ndarray, n: int,
                         cutoff: int | None = None,
                         max_levels: int | None = None) -> jnp.ndarray:
    """Packed C + A*A (reference API: mzd_addmul with A == B dispatches to
    _mzd_addsqr_even, strassen.c:683)."""
    levels = _levels_for(n, n, n, cutoff, max_levels)
    if levels == 0:
        return c_data ^ mul_packed_data(a_data, a_data)
    a, _ = _pad_ops(a_data, a_data, n, n, n, levels)
    np_ = _round_up(n, WORD_BITS << levels)
    a = jnp.pad(a, ((0, np_ - a.shape[0]), (0, 0)))
    c = jnp.pad(c_data, ((0, np_ - c_data.shape[0]),
                         (0, np_ // WORD_BITS - c_data.shape[1])))
    out = _addsqr_rec(c, a, levels)
    return out[:n, : (n + WORD_BITS - 1) // WORD_BITS]
