"""Linear system solving and kernel (nullspace) computation.

Reference analogue: solve.c — mzd_solve_left (PLUQ, then P-apply, TRSM
lower, consistency check, TRSM upper, Q^T-apply; solve.c:30-152) and
mzd_kernel_left_pluq (solve.c:154-191).

Shape discipline: the rank r is a traced scalar, so the
factor shapes stay static and masking recovers the rank-dependent
semantics (free variables are set to zero, and rows >= r of the forward
solve form the consistency residual).

Everything stays *packed*: L columns are pulled out of the in-place
factorization with one selection product (data @ S, the trick of
echelon._pivot_selection) and masked with word-level triangle masks; the
U back-solve collapses to an rmax x rmax system in pivot-slot space
(U_piv = REF @ S), whose solution rows scatter to the pivot columns.
No m x m or n x n unpacked intermediate is ever materialized (the
reference solve.c:55-120 likewise works entirely in place).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.bitmatrix import BitMatrix, identity, mask_padding, width_for
from ..core.permutation import apply_p_left
from ..ops.mul import mul_packed_data, pack_bits
from ..utils.config import WORD_BITS
from .echelon import echelonize_with_pivots, select_pivot_cols
from .ple import block_factor
from .triangular import trsm_lower_left, trsm_upper_left

__all__ = ["solve_left", "kernel_left", "pluq_solve_left"]


def _keep_below(bounds: jnp.ndarray, nwords: int) -> jnp.ndarray:
    """Packed row masks keeping bit positions k < bounds[i]."""
    w = jnp.arange(nwords, dtype=jnp.int32)
    rem = jnp.clip(bounds[:, None] - w[None, :] * WORD_BITS, 0, WORD_BITS)
    return jnp.where(rem >= WORD_BITS, jnp.uint32(0xFFFFFFFF),
                     (jnp.uint32(1) << rem.astype(jnp.uint32))
                     - jnp.uint32(1))


def _pad_words(data: jnp.ndarray, nwords: int) -> jnp.ndarray:
    if data.shape[1] < nwords:
        return jnp.pad(data, ((0, 0), (0, nwords - data.shape[1])))
    return data[:, :nwords]


def _packed_l(data, q, r, m: int, rmax: int, n: int,
              from_pivot_cols: bool, lcols=None) -> BitMatrix:
    """Unit lower-triangular m x m L, packed, from the in-place factor.

    from_pivot_cols: gather L[:, k] from column Q[k] via the packed
    transpose-gather (PLE layout); else L already sits in columns 0..rmax
    (PLUQ).  ``lcols`` lets the caller pass a precomputed selection."""
    if from_pivot_cols:
        if lcols is None:
            lcols = select_pivot_cols(data, q, r, m, n, rmax)  # (m, w_rmax)
    else:
        lcols = _pad_words(data, width_for(rmax))
    iidx = jnp.arange(m, dtype=jnp.int32)
    lcols = lcols & _keep_below(jnp.minimum(iidx, r), lcols.shape[1])
    lw = width_for(m)
    return BitMatrix(_pad_words(lcols, lw) | identity(m).data, m)


def _packed_upiv(top, q, r, rmax: int, n: int,
                 from_pivot_cols: bool, upiv=None) -> BitMatrix:
    """U restricted to its pivot columns, in slot space: rmax x rmax unit
    upper triangular (identity beyond the rank), packed.  Junk below the
    diagonal (the in-place L multipliers) is masked by the TRSM entry
    point itself (triangular._clean_tri).  ``upiv`` lets the caller pass
    a precomputed selection."""
    if from_pivot_cols:
        if upiv is None:
            upiv = select_pivot_cols(top, q, r, rmax, n, rmax)  # (rmax, w_rmax)
    else:
        upiv = _pad_words(top, width_for(rmax))
    k = jnp.arange(rmax, dtype=jnp.int32)
    return BitMatrix(
        upiv | identity(rmax).data
        * (k >= r)[:, None].astype(jnp.uint32), rmax)


@functools.partial(jax.jit, static_argnames=("m", "n",
                                             "from_pivot_cols"))
def _solve_from_factors(data, p, q, r, b: BitMatrix, m: int, n: int,
                        from_pivot_cols: bool):
    rmax = min(m, n)
    kidx = jnp.arange(rmax, dtype=jnp.int32)
    iidx = jnp.arange(m, dtype=jnp.int32)

    if from_pivot_cols:
        # ONE pivot-column selection feeds both L (rows masked strictly
        # below the slot diagonal) and U_piv (its top rmax rows): XLA
        # does not CSE two selects through the data[:rmax] slice.
        sel = select_pivot_cols(data, q, r, m, n, rmax)
        lsrc, usrc = sel, sel[:rmax]
    else:
        lsrc = usrc = None

    lfull = _packed_l(data, q, r, m, rmax, n, from_pivot_cols, lcols=lsrc)
    bp = apply_p_left(b, p)
    y = trsm_lower_left(lfull, bp)
    residual = y.data * (iidx >= r)[:, None].astype(jnp.uint32)
    consistent = jnp.all(residual == 0)

    upiv = _packed_upiv(data[:rmax], q, r, rmax, n, from_pivot_cols,
                        upiv=usrc)
    ydata = y.data[:rmax] * (kidx < r)[:, None].astype(jnp.uint32)
    z = trsm_upper_left(upiv, BitMatrix(ydata, b.ncols))
    zmask = z.data * (kidx < r)[:, None].astype(jnp.uint32)

    # x[Q[k]] = z[k] for k < r, all other entries zero (free vars = 0).
    # Q[k] stores the actual pivot column of slot k; since pivot columns
    # are strictly increasing, the scatter equals the reference's
    # mzd_apply_p_right_trans replay of the swap array (solve.c:117).
    idx = jnp.where(kidx < r, q[:rmax], jnp.int32(n))
    x = jnp.zeros((n, width_for(b.ncols)), jnp.uint32)
    x = x.at[idx].set(zmask, mode="drop")
    return mask_padding(BitMatrix(x, b.ncols)), consistent


def solve_left(a: BitMatrix, b: BitMatrix, nb: int | None = None):
    """Solve A X = B (reference API: mzd_solve_left, solve.c:30).

    Returns (X, consistent): X is ncols(A) x ncols(B) with free variables
    zero; ``consistent`` is a traced bool — when False the system has no
    solution and X is meaningless (the reference returns -1)."""
    m, n = a.nrows, a.ncols
    assert b.nrows == m
    data, p, q, r = block_factor(a, preserve_l=True, nb=nb)
    return _solve_from_factors(data, p, q, r, b, m, n, from_pivot_cols=True)


def pluq_solve_left(m: BitMatrix, p, q, r, b: BitMatrix):
    """Solve A X = B given an existing PLUQ factorization of A (reference
    API: mzd_pluq_solve_left, solve.c:55-120): M holds L strictly below the
    diagonal and U on/above it, with P/Q the swap arrays and r the rank."""
    mm, n = m.nrows, m.ncols
    return _solve_from_factors(m.data, p, q, r, b, mm, n,
                               from_pivot_cols=False)


def kernel_left(a: BitMatrix, nb: int | None = None):
    """Basis X of the right kernel {x : A x = 0} (reference API:
    mzd_kernel_left_pluq, solve.c:154).

    Returns (X, count): X is n x n whose first columns in *column index
    order* are nonzero exactly at the n-r free columns (pivot columns of X
    are zero); count = n - r.  A X == 0 always holds."""
    n = a.ncols
    rref, q, r = echelonize_with_pivots(a, nb=nb)
    return _kernel_post(rref.data, q, r, a.nrows, n)


@functools.partial(jax.jit, static_argnames=("m", "n"))
def _kernel_post(refdata, q, r, m: int, n: int):
    rmax = min(m, n)
    kidx = jnp.arange(rmax, dtype=jnp.int32)

    # valid pivot rows scatter to row Q[k]; invalid ones are dropped
    idx = jnp.where(kidx < r, q[:rmax], jnp.int32(n))
    ispivot = jnp.zeros((n,), jnp.bool_).at[idx].set(True, mode="drop")

    w = width_for(n)
    rows = refdata[:rmax, :w] * (kidx < r)[:, None].astype(jnp.uint32)
    xpack = jnp.zeros((n, w), jnp.uint32).at[idx, :].set(rows, mode="drop")
    # diagonal 1 on free columns
    xpack = xpack | (identity(n).data
                     * (~ispivot).astype(jnp.uint32)[:, None])
    # zero out pivot columns entirely (packed column mask)
    pivword = pack_bits(ispivot[None, :].astype(jnp.uint8))[0]
    xpack = xpack & ~_pad_words(pivword[None, :], w)
    count = n - r
    return mask_padding(BitMatrix(xpack, n)), count
