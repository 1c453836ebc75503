"""Slow reference-faithful Python model of _mzd_top_echelonize_m4ri
(brilliantrussian.c:846-969), including the lazy candidate-row updates of
_mzd_gauss_submatrix_full (brilliantrussian.c:48-79), the upward-only
table elimination (mzd_process_rows over rows [0, min(r, max_r))), and
the one-column skip when a round comes up short (r += kbar; c += kbar;
if kk != kbar: c += 1).

Used by tests/test_elimination.py to pin the search-window semantics of
m4ri_jax.top_echelonize on structured inputs.  NOTE the reference's
documented contract (brilliantrussian.h:218-227) is inputs already in
upper-triangular (echelon) form — for those the restricted search always
finds its pivot at row r and the result is the unique RREF."""

from __future__ import annotations

import numpy as np


def gauss_submatrix_full(A: np.ndarray, r: int, c: int, end_row: int,
                         k: int) -> int:
    """_mzd_gauss_submatrix_full (brilliantrussian.c:48-79), bit-faithful
    including the partial updates applied to scanned non-pivot rows."""
    start_row = r
    for j in range(c, c + k):
        found = False
        for i in range(start_row, end_row):
            if A[i, c:j + 1].any():
                for l in range(j - c):
                    if A[i, c + l]:
                        A[i, c + l:] ^= A[r + l, c + l:]
                if A[i, j]:
                    A[[i, start_row]] = A[[start_row, i]]
                    for l in range(r, start_row):
                        if A[l, j]:
                            A[l, j:] ^= A[start_row, j:]
                    start_row += 1
                    found = True
                    break
        if not found:
            break
    return start_row - r


def top_echelonize_model(a: np.ndarray, k: int, r: int = 0, c: int = 0,
                         max_r: int | None = None):
    """Returns (matrix, rank) with the reference's exact semantics for an
    explicit k (the reference's k=0 auto-choice is cache-size dependent,
    so tests pass k explicitly to both sides)."""
    A = a.astype(np.uint8).copy()
    m, n = A.shape
    if max_r is None:
        max_r = m
    kk = 6 * k
    while c < n:
        if c + kk > n:
            kk = n - c
        kbar = gauss_submatrix_full(A, r, c, min(m, r + kk), kk)
        if kbar > 0:
            # mzd_process_rows{1..6}: rows [0, min(r, max_r)) eliminate
            # their bits at columns c..c+kbar-1 using the pivot rows
            # (which gauss_submatrix_full left as an identity block)
            for i in range(min(r, max_r)):
                for l in range(kbar):
                    if A[i, c + l]:
                        A[i, c + l:] ^= A[r + l, c + l:]
        r += kbar
        c += kbar
        if kk != kbar:
            c += 1
    return A, r
