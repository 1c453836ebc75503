"""Distributed (row-sharded) echelonization over a device mesh.

The reference has no distributed factorization at all (its only parallelism
is OpenMP loop-splitting over rows, brilliantrussian.c:364-367) — this is
new, designed from the SURVEY §5 "distributed backend" notes:

- A is row-sharded along mesh axis "x"; rows never move physically —
  pivoting is *lazy* (a replicated `pivoted` mask + pivot row/col lists),
  which removes all cross-device row-swap traffic.
- Per column panel: one all-gather of the current m x NB panel (bits), a
  replicated branchless pivot hunt (every device computes the identical
  factorization of the tiny panel), one XOR-all-reduce that assembles the
  <=NB pivot rows' trailing content, and a purely local Schur update
  (matrix product) of each shard.  Total communication ~ 2*m*n/8 bytes
  across the whole factorization — asymptotically negligible against the
  O(n^3) local product work.
- Pivot choice is "first unpivoted physical row", so P/Q differ from the
  single-device engine's swap-based order, but rank and the echelon ROWS
  are identical (and RREF is unique), which is what the tests pin down.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..ops.mul import mul_packed_data, pack_bits
from ..utils.config import WORD_BITS

__all__ = ["dist_echelonize", "dist_rank"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _factor_local(a_loc, m: int, n: int, nb: int, mesh):
    """shard_map body: a_loc is this device's row block (mloc, w_pad)."""
    mloc = a_loc.shape[0]
    w_pad = a_loc.shape[1]
    nbw = nb // WORD_BITS
    n_panels = w_pad // nbw
    rx = mesh.shape["x"]
    m_tot = mloc * rx
    my = lax.axis_index("x")
    offset = my * mloc

    gidx = jnp.arange(m_tot, dtype=jnp.int32)
    jrow = jnp.arange(nb, dtype=jnp.int32)
    widx = jnp.arange(w_pad, dtype=jnp.int32)
    eye_nb = jnp.eye(nb, dtype=jnp.int8)

    def panel(carry, t):
        a_loc, pivoted, pivrows, pivcols, r = carry
        c0w = t * nbw
        pan_loc = lax.dynamic_slice(a_loc, (0, c0w), (mloc, nbw))
        pan = lax.all_gather(pan_loc, "x", axis=0, tiled=True)  # (m_tot, nbw)
        Lp = jnp.zeros((m_tot, nb), jnp.uint8)
        r_in = r

        def colstep(j, st):
            pan, Lp, pivoted, pivrows, pivcols, r = st
            wloc = j // WORD_BITS
            sh = jnp.uint32(j % WORD_BITS)
            col = (jnp.take(pan, wloc, axis=1) >> sh) & 1
            cand = (col == 1) & (~pivoted) & (gidx < m)
            found = jnp.any(cand)
            piv = jnp.argmax(cand).astype(jnp.int32)
            pivrow = pan[piv] * found.astype(jnp.uint32)
            # keep columns <= j intact on eliminated rows (L discipline not
            # needed here — full zeroing is fine for echelon): eliminate the
            # whole panel row of every other unpivoted row with the bit set.
            elim = cand & (gidx != piv)
            em = elim.astype(jnp.uint32)
            pan = pan ^ (em[:, None] * pivrow[None, :])
            slot = jnp.minimum(r - r_in, nb - 1)
            Lp = lax.dynamic_update_slice(
                Lp, elim.astype(jnp.uint8)[:, None], (0, slot))
            rs = jnp.minimum(r, m_tot - 1)
            pivrows = pivrows.at[rs].set(
                jnp.where(found, piv, pivrows[rs]))
            c_glob = t * nb + j
            pivcols = pivcols.at[rs].set(
                jnp.where(found, c_glob, pivcols[rs]))
            pivoted = pivoted | (cand & (gidx == piv) & found)
            r = r + found.astype(jnp.int32)
            return (pan, Lp, pivoted, pivrows, pivcols, r)

        pan, Lp, pivoted, pivrows, pivcols, r = lax.fori_loop(
            0, nb, colstep,
            (pan, Lp, pivoted, pivrows, pivcols, r))
        # write updated panel back to the local shard
        a_loc = lax.dynamic_update_slice(
            a_loc, lax.dynamic_slice(pan, (offset, 0), (mloc, nbw)), (0, c0w))

        rank_panel = r - r_in
        # L11 in pivot order: rows = the panel's pivot rows
        slots = jnp.clip(r_in + jrow, 0, m_tot - 1)
        block_rows = pivrows[slots]  # global indices; junk beyond rank_panel
        l11 = Lp[block_rows] * (jrow < rank_panel)[:, None].astype(jnp.uint8)
        l11 = l11.astype(jnp.int8)
        s = eye_nb ^ l11
        p = l11
        for _ in range(max(0, (nb - 1).bit_length() - 1)):
            p = (lax.dot_general(p, p, (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.int32)
                 & 1).astype(jnp.int8)
            s = s ^ (lax.dot_general(p, s, (((1,), (0,)), ((), ())),
                                     preferred_element_type=jnp.int32)
                     & 1).astype(jnp.int8)

        # assemble pivot-row trailing content: local contribution + XOR-reduce
        loc_rows = block_rows - offset
        mine = (loc_rows >= 0) & (loc_rows < mloc) & (jrow < rank_panel)
        contrib = a_loc[jnp.clip(loc_rows, 0, mloc - 1)] \
            * mine[:, None].astype(jnp.uint32)
        gathered = lax.all_gather(contrib, "x")  # (rx, nb, w_pad)
        block = lax.reduce(gathered, jnp.uint32(0), lax.bitwise_xor, (0,))

        from ..ops.mul import unpack_bits
        bu = unpack_bits(block, jnp.int8)
        u = (lax.dot_general(s, bu, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32) & 1)
        u = u * (jrow < rank_panel)[:, None]
        up = pack_bits(u)
        up = up * (widx >= (t + 1) * nbw)[None, :].astype(jnp.uint32)

        lp_loc = lax.dynamic_slice(Lp, (offset, 0), (mloc, nb))
        delta = mul_packed_data(pack_bits(lp_loc), up)
        a_loc = a_loc ^ delta
        return (a_loc, pivoted, pivrows, pivcols, r), None

    init = (a_loc,
            jnp.zeros((m_tot,), jnp.bool_),
            jnp.zeros((m_tot,), jnp.int32),
            jnp.arange(w_pad * WORD_BITS, dtype=jnp.int32)[:m_tot],
            jnp.int32(0))
    (a_loc, pivoted, pivrows, pivcols, r), _ = lax.scan(
        panel, init, jnp.arange(n_panels, dtype=jnp.int32))
    return a_loc, pivrows, pivcols, r


def _dist_factor(a: BitMatrix, mesh, nb: int = 128):
    rx = mesh.shape["x"]
    m_, n_ = a.nrows, a.ncols
    nb = max(WORD_BITS, min(nb, _round_up(n_, WORD_BITS)))
    nb = _round_up(nb, WORD_BITS)
    n_pad = _round_up(n_, nb)
    m_pad = _round_up(m_, rx)
    data = jnp.pad(a.data, ((0, m_pad - m_), (0, n_pad // WORD_BITS - a.width)))

    fn = functools.partial(_factor_local, m=m_, n=n_, nb=nb, mesh=mesh)
    sharded = jax.shard_map(
        fn, mesh=mesh, check_vma=False,
        in_specs=P("x", None),
        out_specs=(P("x", None), P(None), P(None), P()))
    a_out, pivrows, pivcols, r = sharded(data)
    return a_out, pivrows, pivcols, r, m_pad, n_pad


# Jitted with the mesh static: called eagerly, the shard_map of a fresh
# partial is traced and compiled again on every call.
@functools.partial(jax.jit, static_argnames=("mesh", "nb"))
def dist_rank(a: BitMatrix, mesh, nb: int = 128):
    """Rank of A computed with row-sharded elimination."""
    _, _, _, r, _, _ = _dist_factor(a, mesh, nb)
    return r


@functools.partial(jax.jit, static_argnames=("mesh", "nb"))
def dist_echelonize(a: BitMatrix, mesh, nb: int = 128):
    """Row echelon form via the distributed factorization.  Returns
    (REF BitMatrix [replicated on host], rank).  Pivot *columns* are
    canonical (left to right) but pivot-row choice differs from the local
    swap-based engine, so the REF is row-equivalent, not bit-identical
    (the RREF of both is identical; REF itself is not unique)."""
    a_out, pivrows, pivcols, r, m_pad, n_pad = _dist_factor(a, mesh, nb)
    # gather pivot rows in pivot order; non-pivot rows are fully zero
    m, n = a.nrows, a.ncols
    rmax = min(m, n)
    k = jnp.arange(rmax, dtype=jnp.int32)
    rows = a_out[jnp.clip(pivrows[:rmax], 0, m_pad - 1)]
    rows = rows * (k < r)[:, None].astype(jnp.uint32)
    out = jnp.zeros((m, width_for(n)), jnp.uint32)
    out = out.at[:rmax].set(rows[:, : width_for(n)])
    return mask_padding(BitMatrix(out, n)), r
