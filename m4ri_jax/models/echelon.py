"""(Reduced) row echelon form, rank, inversion.

Reference analogue: brilliantrussian.c `_mzd_echelonize_m4ri` (Gray-code
M4RI elimination, O(n^3/log n)) and echelonform.c dispatch.  This
engine reuses the panel factorization of models/ple.py (same canonical pivot
order, so the echelon form matches the reference bit-for-bit — RREF is
unique over GF(2) anyway) and computes:

- REF directly from the factorization (rows 0..r-1 are the echelon rows);
- RREF as ``(U restricted to pivot columns)^{-1} @ U`` — one triangular
  inversion (log-depth matrix products) plus one big multiply, instead of
  the reference's sequential table-driven upward elimination;
- inversion as the right half of RREF([A | I]) (reference: mzd_inv_m4ri =
  RREF of [A|I], brilliantrussian.c:971-997).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.bitmatrix import (BitMatrix, concat, identity, mask_padding,
                              submatrix, width_for)
from ..ops.mul import pack_bits, unpack_bits
from .ple import block_factor
from .triangular import trsm_upper_left

# The public entry points run as TWO jitted programs: the panel
# factorization (its own jit inside block_factor — scan + cond + the
# pivot-loop kernel) and the straight-line RREF post-pass below, so the
# loop program and the post-pass compile and cache separately.
__all__ = ["echelonize", "echelonize_pluq", "top_echelonize", "rank",
           "invert", "invert_naive"]


def _pivot_selection(q, r, n: int, rmax: int):
    """Packed selection matrix S (n x rmax) with S[Q[k], k] = 1 for k < r
    and S[k, k] = 1 for k >= r.  Column extraction by pivot index then
    becomes a GF(2) product (REF @ S) — the right form for the *mesh*
    engines, where the product distributes via SUMMA (parallel/dist_solve)."""
    k = jnp.arange(rmax, dtype=jnp.int32)
    rows = jnp.where(k < r, q[:rmax], k)
    w = width_for(rmax)
    s = jnp.zeros((n, w), jnp.uint32)
    s = s.at[rows, k // 32].add(jnp.uint32(1) << (k % 32).astype(jnp.uint32),
                                mode="drop")
    return s


def select_pivot_cols(data, q, r, m: int, n: int, rmax: int):
    """out[:, k] = data[:, Q[k]] for k < r, data[:, k] for k >= r — the
    same contraction as ``data @ _pivot_selection(...)`` but computed as
    transpose -> packed-row gather -> transpose: O(m n / 32) word ops
    instead of an O(m n rmax) matrix product."""
    from ..core.transpose import transpose
    k = jnp.arange(rmax, dtype=jnp.int32)
    rows = jnp.where(k < r, q[:rmax], k)
    dt = transpose(BitMatrix(data[:, :width_for(n)], n))   # (n, w(m))
    g = jnp.take(dt.data, rows, axis=0, mode="clip")       # (rmax, w(m))
    return transpose(BitMatrix(g, m)).data                 # (m, w(rmax))


@functools.partial(jax.jit, static_argnames=("m", "n"))
def _rref_from_ref(data, q, r, m: int, n: int):
    """Top rows of REF -> RREF rows via U_rr^{-1} @ U.

    U_rr = REF[:, pivot columns] via the packed transpose-gather
    (select_pivot_cols) — O(n^2) bandwidth instead of a full product."""
    rmax = min(m, n)
    top = data[:rmax]
    urr = select_pivot_cols(top, q, r, rmax, n, rmax)  # (rmax, rmax) upper tri
    # unit diagonal beyond the rank (rows >= r of top are zero)
    eye = identity(rmax).data
    k = jnp.arange(rmax, dtype=jnp.int32)
    urr = urr | (eye * (k >= r)[:, None].astype(jnp.uint32))
    u_mat = BitMatrix(urr, rmax)
    x = trsm_upper_left(u_mat, BitMatrix(top, n))
    out = x.data
    if m > rmax:
        out = jnp.concatenate(
            [out, jnp.zeros((m - rmax, width_for(n)), jnp.uint32)], axis=0)
    return out


def echelonize(a: BitMatrix, full: bool = True, nb: int | None = None,
               strategy: str = "m4ri"):
    """Row echelon form (reference API: mzd_echelonize, echelonform.c:30;
    full=True gives the reduced form).  Returns (matrix, rank).

    ``strategy``: "m4ri" (direct factorization), "pluq" (reconstruct from the
    PLE factors, echelonform.c:38-137), or "heuristic" — sample the density
    and switch to the pluq path above the reference's 0.15 crossover
    (echelonform.h:37).  All paths produce identical results (RREF is unique
    and both use the canonical pivot order); keeping them separate mirrors
    the reference dispatch and gives tests independent engines to compare.
    """
    if strategy == "heuristic":
        from ..core.bitmatrix import density
        from ..utils.config import get_config
        d = float(density(a))
        strategy = "pluq" if d >= get_config().echelon_density_crossover \
            else "m4ri"
    if strategy == "pluq":
        return echelonize_pluq(a, full=full, nb=nb)
    return _echelonize_m4ri(a, full, nb)


def _echelonize_m4ri(a: BitMatrix, full: bool = True, nb: int | None = None):
    data, _, q, r = block_factor(a, preserve_l=False, nb=nb)
    if not full:
        return mask_padding(BitMatrix(data, a.ncols)), r
    out = _rref_from_ref(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(out, a.ncols)), r


def echelonize_pluq(a: BitMatrix, full: bool = True, nb: int | None = None):
    """(R)REF reconstructed from the PLE factorization (reference API:
    mzd_echelonize_pluq, echelonform.c:38-137): factor with L preserved in
    the pivot columns, then clear the L bits from the echelon rows."""
    m, n = a.nrows, a.ncols
    data, _, q, r = block_factor(a, preserve_l=True, nb=nb)
    return _pluq_echelon_post(data, q, r, m, n, full)


@functools.partial(jax.jit, static_argnames=("m", "n", "full"))
def _pluq_echelon_post(data, q, r, m: int, n: int, full: bool):
    rmax = min(m, n)
    bits = unpack_bits(data[:rmax], jnp.uint8)[:, :n]
    # pivrank[c] = k if column c is the k-th pivot column else a big value
    k = jnp.arange(rmax, dtype=jnp.int32)
    idx = jnp.where(k < r, q[:rmax], jnp.int32(n))
    pivrank = jnp.full((n,), rmax + 1, jnp.int32).at[idx].set(k, mode="drop")
    # clear L bits: entry (i, c) with pivrank[c] < i is an L multiplier
    keep = (pivrank[None, :] >= k[:, None]).astype(jnp.uint8)
    bits = bits * keep
    top = pack_bits(bits)
    if m > rmax:
        top = jnp.concatenate(
            [top, jnp.zeros((m - rmax, top.shape[1]), jnp.uint32)], axis=0)
    # rows >= r must be zero (they hold only L bits, all cleared above)
    if not full:
        return mask_padding(BitMatrix(top, n)), r
    out = _rref_from_ref(top, q, r, m, n)
    return mask_padding(BitMatrix(out, n)), r


def top_echelonize(a: BitMatrix, k: int = 0, nb: int | None = None):
    """RREF variant whose pivot search is restricted to the next 6k rows
    below the current rank (reference API: mzd_top_echelonize_m4ri,
    brilliantrussian.c:846-969 — no deep row swaps).  Returns (matrix, rank).

    Contract (brilliantrussian.h:229-232): the input is already in
    upper-triangular (echelon) form, in which case the window always
    suffices and the result is bit-identical to the reference (pinned
    against tests/ref_top_model.py).  On non-echelon inputs whose pivots
    sit beyond the window, the reference's output is incidental (lazy
    partial updates, below-window rows never eliminated); this recast
    keeps eliminating below the window instead, so it finds at least as
    many pivots (divergence pinned by
    test_top_echelonize_out_of_contract_divergence_documented)."""
    from ..utils.graycode import opt_k
    if k <= 0:
        k = min(opt_k(a.nrows, a.ncols), 7)
    return _top_echelonize_impl(a, 6 * k, nb)


def _top_echelonize_impl(a: BitMatrix, window: int, nb: int | None):
    data, _, q, r = block_factor(a, preserve_l=False, nb=nb,
                                 search_window=window)
    out = _rref_from_ref(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(out, a.ncols)), r


def echelonize_with_pivots(a: BitMatrix, nb: int | None = None):
    """RREF plus pivot-column swap array (used by kernel computation)."""
    data, _, q, r = block_factor(a, preserve_l=False, nb=nb)
    out = _rref_from_ref(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(out, a.ncols)), q, r


def rank(a: BitMatrix, nb: int | None = None):
    _, _, _, r = block_factor(a, preserve_l=False, nb=nb)
    return r


def invert(a: BitMatrix, nb: int | None = None):
    """A^{-1} via RREF of [A | I] (reference: mzd_inv_m4ri).  Returns
    (inverse, rank); the inverse is valid iff rank == n."""
    n = a.ncols
    assert a.nrows == n, "inversion requires a square matrix"
    aug = _augment(a, n)
    data, _, q, r = block_factor(aug, preserve_l=False, nb=nb)
    return _invert_post(data, q, r, n)


@functools.partial(jax.jit, static_argnames=("n",))
def _augment(a: BitMatrix, n: int) -> BitMatrix:
    return concat(a, identity(n))


@functools.partial(jax.jit, static_argnames=("n",))
def _invert_post(data, q, r, n: int):
    out = _rref_from_ref(data, q, r, n, 2 * n)
    rref = mask_padding(BitMatrix(out, 2 * n))
    # rank of A itself = pivots that fall in the left block
    k = jnp.arange(n, dtype=jnp.int32)
    r_a = jnp.sum(((k < r) & (q[:n] < n)).astype(jnp.int32))
    return submatrix(rref, 0, n, n, 2 * n), r_a


@functools.partial(jax.jit, static_argnames=("full", "start_col"))
def echelonize_naive(a: BitMatrix, full: bool = True, start_col: int = 0):
    """Straightforward Gauss elimination, one pivot per fori step —
    an engine-independent cross-validation path (reference API:
    mzd_echelonize_naive, and with start_col > 0, mzd_gauss_delayed).
    Returns (matrix, rank)."""
    m, n = a.nrows, a.ncols
    ridx = jnp.arange(m, dtype=jnp.int32)

    def step(c, st):
        data, r = st
        w = jnp.int32(c) // 32
        s = (jnp.int32(c) % 32).astype(jnp.uint32)
        col = (data[:, w] >> s) & 1
        active = (col == 1) & (ridx >= r)
        found = jnp.any(active)
        piv = jnp.argmax(active).astype(jnp.int32)
        rs = jnp.minimum(r, m - 1)
        ps = jnp.where(found, piv, rs)
        rowr, rowp = data[rs], data[ps]
        data = data.at[rs].set(rowp).at[ps].set(rowr)
        col = col.at[rs].set(col[ps]).at[ps].set(col[rs])
        pivrow = data[rs]
        if full:
            elim = (col == 1) & (ridx != rs) & found
        else:
            elim = (col == 1) & (ridx > rs) & found
        data = data ^ (elim.astype(jnp.uint32)[:, None] * pivrow[None, :])
        return data, r + found.astype(jnp.int32)

    data, r = jax.lax.fori_loop(start_col, n, step, (a.data, jnp.int32(0)))
    return mask_padding(BitMatrix(data, n)), r


def gauss_delayed(a: BitMatrix, start_col: int = 0, full: bool = False):
    """Gauss elimination starting at a column (reference API:
    mzd_gauss_delayed, mzd.c)."""
    return echelonize_naive(a, full=full, start_col=start_col)


@functools.partial(jax.jit, static_argnames=())
def invert_naive(a: BitMatrix):
    """Inversion through the one-pivot-per-step naive Gauss engine — the
    independent cross-check path the reference's test_invert.c uses
    (reference API: mzd_invert_naive, mzd.c / mzd.h).  Returns
    (inverse, ok): ok is a traced bool, False iff A is singular (the
    reference returns NULL then)."""
    n = a.ncols
    assert a.nrows == n, "inversion requires a square matrix"
    aug = concat(a, identity(n))
    red, _ = echelonize_naive(aug, full=True)
    left = submatrix(red, 0, 0, n, n)
    ok = jnp.all(left.data == identity(n).data)
    return submatrix(red, 0, n, n, 2 * n), ok
