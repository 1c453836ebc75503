"""Distributed TRSM / TRTRI / solve over a device mesh.

Reference analogue: triangular.c + solve.c, which have no multi-processor
story at all — this extends SURVEY §5's distributed-backend design to the
full factorization family.  The structure mirrors the single-chip modules
exactly (so results are bit-identical):

- TRTRI keeps the 2x2 word-aligned recursion of models/triangular._trtri,
  but every block product is a SUMMA mesh multiply (dist_mul.mul_dist) —
  the recursion is O(log n) levels of collectives + local product work.
- TRSM variants are one TRTRI plus one mesh product.
- solve_left follows models/solve._solve_from_factors step for step: the
  distributed canonical PLE (dist_ple.dist_block_factor), the packed-L
  selection product and the two triangular solves as mesh products, and
  the slot-space scatter of the solution rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..core.bitmatrix import BitMatrix, identity, mask_padding, width_for
from ..core.permutation import apply_p_left
from ..models.echelon import _pivot_selection
from ..models.solve import _keep_below, _pad_words
from ..models.triangular import (_clean_tri, _trsm_left_rec,
                                 _trsm_right_rec, _trtri)
from .dist_mul import mul_dist
from .dist_ple import dist_block_factor

__all__ = ["dist_trtri_upper", "dist_trtri_lower", "dist_trsm_upper_left",
           "dist_trsm_lower_left", "dist_trsm_upper_right",
           "dist_trsm_lower_right", "dist_solve_left", "dist_invert",
           "dist_kernel_left"]


def _mesh_mul(mesh):
    return functools.partial(mul_dist, mesh=mesh)


# The entry points are jitted with the mesh static, as the single-device
# ones are (models/triangular.py): the recursion is O(log n) levels of mesh
# products and element-wise glue, and run eagerly each of those would be
# dispatched (and compiled) on its own.
_jit_mesh = functools.partial(jax.jit, static_argnames=("mesh",))
_jit_factor = functools.partial(jax.jit,
                                static_argnames=("mesh", "nb", "window"))


@_jit_mesh
def dist_trtri_upper(t: BitMatrix, mesh) -> BitMatrix:
    return _trtri(_clean_tri(t, True), True, _mesh_mul(mesh))


@_jit_mesh
def dist_trtri_lower(t: BitMatrix, mesh) -> BitMatrix:
    return _trtri(_clean_tri(t, False), False, _mesh_mul(mesh))


@_jit_mesh
def dist_trsm_upper_left(u: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    assert u.nrows == u.ncols == b.nrows
    return _trsm_left_rec(_clean_tri(u, True), b, True, _mesh_mul(mesh))


@_jit_mesh
def dist_trsm_lower_left(l: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    assert l.nrows == l.ncols == b.nrows
    return _trsm_left_rec(_clean_tri(l, False), b, False, _mesh_mul(mesh))


@_jit_mesh
def dist_trsm_upper_right(u: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    assert u.nrows == u.ncols == b.ncols
    return _trsm_right_rec(_clean_tri(u, True), b, True, _mesh_mul(mesh))


@_jit_mesh
def dist_trsm_lower_right(l: BitMatrix, b: BitMatrix, mesh) -> BitMatrix:
    assert l.nrows == l.ncols == b.ncols
    return _trsm_right_rec(_clean_tri(l, False), b, False, _mesh_mul(mesh))


@_jit_factor
def dist_solve_left(a: BitMatrix, b: BitMatrix, mesh, nb: int = 128,
                    window: int | None = None):
    """Solve A X = B over the mesh; bit-identical to models/solve.solve_left
    (same canonical factorization, same free-variable convention).
    Returns (X, consistent)."""
    m, n = a.nrows, a.ncols
    assert b.nrows == m
    rmax = min(m, n)
    data, p, q, r = dist_block_factor(a, mesh, preserve_l=True, nb=nb,
                                      window=window)
    kidx = jnp.arange(rmax, dtype=jnp.int32)
    iidx = jnp.arange(m, dtype=jnp.int32)

    # packed unit-lower L via the selection product (mesh multiply)
    s = _pivot_selection(q, r, n, rmax)
    lcols = mul_dist(BitMatrix(data, n), BitMatrix(s, rmax), mesh).data
    lcols = lcols & _keep_below(jnp.minimum(iidx, r), lcols.shape[1])
    lfull = BitMatrix(_pad_words(lcols, width_for(m)) | identity(m).data, m)

    bp = apply_p_left(b, p)
    y = dist_trsm_lower_left(lfull, bp, mesh)
    residual = y.data * (iidx >= r)[:, None].astype(jnp.uint32)
    consistent = jnp.all(residual == 0)

    # U restricted to pivot columns, slot space (rmax x rmax)
    upiv = mul_dist(BitMatrix(data[:rmax], n), BitMatrix(s, rmax), mesh).data
    upiv = upiv | identity(rmax).data \
        * (kidx >= r)[:, None].astype(jnp.uint32)
    ydata = y.data[:rmax] * (kidx < r)[:, None].astype(jnp.uint32)
    z = dist_trsm_upper_left(BitMatrix(upiv, rmax),
                             BitMatrix(ydata, b.ncols), mesh)
    zmask = z.data * (kidx < r)[:, None].astype(jnp.uint32)

    idx = jnp.where(kidx < r, q[:rmax], jnp.int32(n))
    x = jnp.zeros((n, width_for(b.ncols)), jnp.uint32)
    x = x.at[idx].set(zmask, mode="drop")
    return mask_padding(BitMatrix(x, b.ncols)), consistent


@_jit_factor
def dist_invert(a: BitMatrix, mesh, nb: int = 128, window: int | None = None):
    """A^{-1} over the mesh via RREF of [A | I] (reference: mzd_inv_m4ri).
    Returns (inverse, rank); valid iff rank == n.  Bit-identical to
    models/echelon.invert — the mesh factorization is canonical and the
    RREF post-pass is the same replicated program."""
    from ..models.echelon import _augment, _invert_post
    n = a.ncols
    assert a.nrows == n, "inversion requires a square matrix"
    aug = _augment(a, n)
    data, _, q, r = dist_block_factor(aug, mesh, preserve_l=False, nb=nb,
                                      window=window)
    return _invert_post(data, q, r, n)


@_jit_factor
def dist_kernel_left(a: BitMatrix, mesh, nb: int = 128,
                     window: int | None = None):
    """Right-kernel basis over the mesh (reference: mzd_kernel_left_pluq).
    Returns (X, count) with the same convention as models/solve.kernel_left
    (bit-identical: canonical factorization + the same post-pass)."""
    from ..models.echelon import _rref_from_ref
    from ..models.solve import _kernel_post
    data, _, q, r = dist_block_factor(a, mesh, preserve_l=False, nb=nb,
                                      window=window)
    out = _rref_from_ref(data, q, r, a.nrows, a.ncols)
    return _kernel_post(out, q, r, a.nrows, a.ncols)
