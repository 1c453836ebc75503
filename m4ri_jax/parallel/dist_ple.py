"""Distributed (row-sharded) canonical PLE factorization.

The reference has no distributed factorization (mp.c is OpenMP loop
splitting); this follows SURVEY §5's distributed-backend design, and —
unlike parallel/dist_echelon.py's lazy-pivot engine — reproduces the
single-chip factorization (models/ple.py) *bit for bit*: same canonical
pivot order, same P/Q swap arrays, same in-place L\\E layout.

Key idea: physical rows never move between devices.  A replicated
position->row permutation `perm` stands in for the reference's row swaps;
per column panel each device

1. all-gathers the m x NB packed panel (the only O(m) communication),
2. runs the SAME canonical window pivot loop as the single-chip engine
   (models/ple.run_panel_loop — replicated deterministic compute, free of
   cross-device traffic; on the GPU this is the pivot-loop kernel),
3. eliminates its OWN below-window rows with the batched multiplier solve
   (lambda = X_piv @ U_piv^{-1} — local matrix-unit work, replicated tiny
   factors),
4. XOR-reduces the <= NB pivot rows' trailing words and applies the Schur
   update to its local shard (local product).

The exact miss check (window rank-deficient but pivots exist below) is a
1-bit psum; the rare fallback reruns the panel loop on the full gathered
panel in position order — still replicated compute, no extra traffic.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import PartitionSpec as P

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..models.ple import (_dot2, _round_up, _unit_upper_inv, default_engine,
                          run_panel_loop)
from ..ops.mul import mul_packed_data, pack_bits, unpack_bits
from ..utils.config import WORD_BITS, get_config

__all__ = ["dist_ple", "dist_block_factor"]


def _ple_local(a_loc, m: int, n: int, nb: int, W: int, preserve_l: bool,
               engine: str, mesh):
    """shard_map body.  a_loc: this device's row block (mloc, w_pad).
    Everything except a_loc is replicated across devices."""
    mloc, w_pad = a_loc.shape
    nbw = nb // WORD_BITS
    n_panels = w_pad // nbw
    rx = mesh.shape["x"]
    m_pad = mloc * rx  # includes the W-row padding (rows >= m are zero)
    offset = lax.axis_index("x") * mloc

    lidx = jnp.arange(mloc, dtype=jnp.int32)
    gidx = offset + lidx
    slotv = jnp.arange(nb, dtype=jnp.int32)
    jrow = jnp.arange(nb, dtype=jnp.int32)
    widx = jnp.arange(w_pad, dtype=jnp.int32)
    eye_nb = jnp.eye(nb, dtype=jnp.int8)
    steps = max(0, (nb - 1).bit_length() - 1)

    def panel(carry, t):
        a_loc, perm, pos_of, Pv, Qv, r = carry
        r_in = r
        c0w = t * nbw
        pan_loc = lax.dynamic_slice(a_loc, (0, c0w), (mloc, nbw))
        pan_all = lax.all_gather(pan_loc, "x", axis=0, tiled=True)

        # ---- replicated canonical window loop on positions r..r+W ----
        win_rows = lax.dynamic_slice(perm, (r_in,), (W,))
        win = pan_all[win_rows]
        ALw, rpw, r_f, _, p_f, q_f = run_panel_loop(
            win, r, r_in, t, r_in, m, nb, preserve_l, 0, engine)
        k_f = r_f - r_in

        # ---- batched elimination factors (replicated, tiny) ----
        live = slotv < k_f
        cloc = jnp.where(live, q_f - t * nb, 0)
        Pw = ALw[:nb]
        Pbits = unpack_bits(Pw[:, :nbw], jnp.int8)
        urows = Pbits * live[:, None].astype(jnp.int8)
        E = ((cloc[:, None] == slotv[None, :])
             & live[:, None]).astype(jnp.int8)
        if preserve_l:
            Lbits = unpack_bits(Pw[:, nbw:], jnp.int8)
            u_clean = (urows ^ _dot2(Lbits, E)) \
                * live[:, None].astype(jnp.int8)
        else:
            u_clean = urows
        upiv = _dot2(u_clean, E.T)
        npiv = upiv * (slotv[None, :] > slotv[:, None]).astype(jnp.int8)
        T = _unit_upper_inv(npiv, eye_nb, steps)
        wmat = (u_clean ^ E) if preserve_l else u_clean

        # ---- local below-window elimination ----
        below = pos_of >= r_in + W          # (m_pad,) replicated positions
        below_loc = below[gidx]
        Xu = unpack_bits(pan_loc, jnp.int8)
        xpiv = _dot2(Xu, E.T)
        lam = _dot2(xpiv, T) \
            * (live[None, :] & below_loc[:, None]).astype(jnp.int8)
        vbits = Xu ^ _dot2(lam, wmat)
        pivcol = jnp.zeros((nb,), jnp.bool_).at[
            jnp.where(live, cloc, nb)].set(True, mode="drop")
        validcol = (t * nb + slotv) < n
        miss_loc = jnp.any((vbits != 0) & (~pivcol & validcol)[None, :]
                           & (below_loc & (gidx < m))[:, None])
        miss = lax.psum(miss_loc.astype(jnp.int32), "x") > 0

        vw = pack_bits(vbits)
        lamw = pack_bits(lam)

        # window write-back targets: window slot i now holds the row that
        # was at window slot rpw[i], i.e. original row win_rows[rpw[i]]
        new_win_rows = win_rows[rpw]
        perm_new = lax.dynamic_update_slice(perm, new_win_rows, (r_in,))
        posv = jnp.arange(m_pad, dtype=jnp.int32)
        pos_new = pos_of.at[new_win_rows].set(
            r_in + jnp.arange(W, dtype=jnp.int32), mode="drop")

        def fast_branch(_):
            # scatter my window rows' updated panel+L words into the shard
            tgt = new_win_rows - offset
            tgt = jnp.where((tgt >= 0) & (tgt < mloc), tgt, mloc)
            pan_new = jnp.where(below_loc[:, None], vw, pan_loc)
            pan_new = pan_new.at[tgt].set(ALw[:, :nbw], mode="drop")
            lp_new = jnp.where(below_loc[:, None], lamw, jnp.uint32(0))
            lp_new = lp_new.at[tgt].set(ALw[:, nbw:], mode="drop")
            return pan_new, lp_new, perm_new, pos_new, p_f, q_f, r_f

        def slow_branch(_):
            # full-height canonical loop on the position-ordered panel
            ALf, rpf, r_s, _, p_s, q_s = run_panel_loop(
                pan_all[perm], r, jnp.int32(0), t, r_in, m, nb,
                preserve_l, 0, engine)
            pm = perm[rpf]                  # position -> row after swaps
            pos_f = pos_of.at[pm].set(posv, mode="drop")
            mine_f = ALf[pos_f[gidx]]       # my rows' final panel+L words
            return (mine_f[:, :nbw], mine_f[:, nbw:], pm, pos_f,
                    p_s, q_s, r_s)

        pan_out, lp_loc, perm, pos_of, p_pan, q_pan, r = lax.cond(
            miss, slow_branch, fast_branch, None)

        live2 = slotv < (r - r_in)
        p_old = lax.dynamic_slice(Pv, (r_in,), (nb,))
        q_old = lax.dynamic_slice(Qv, (r_in,), (nb,))
        Pv = lax.dynamic_update_slice(
            Pv, jnp.where(live2, p_pan, p_old), (r_in,))
        Qv = lax.dynamic_update_slice(
            Qv, jnp.where(live2, q_pan, q_old), (r_in,))

        a_loc = lax.dynamic_update_slice(a_loc, pan_out, (0, c0w))

        # ---- U rows: trailing words of the nb pivot-position rows ----
        piv_rows = lax.dynamic_slice(perm, (r_in,), (nb,))
        l11 = unpack_bits(lp_loc, jnp.int8)
        # l11 block must be the pivot rows' multipliers, in slot order
        loc = piv_rows - offset
        mine = (loc >= 0) & (loc < mloc)
        l11_mine = l11[jnp.clip(loc, 0, mloc - 1)].astype(jnp.int32) \
            * mine[:, None].astype(jnp.int32)
        l11_blk = lax.psum(l11_mine, "x").astype(jnp.int8)
        s = _unit_upper_inv(l11_blk, eye_nb, steps)
        contrib = a_loc[jnp.clip(loc, 0, mloc - 1)] \
            * mine[:, None].astype(jnp.uint32)
        gathered = lax.all_gather(contrib, "x")
        block = lax.reduce(gathered, jnp.uint32(0), lax.bitwise_xor, (0,))
        bu = unpack_bits(block, jnp.int8)
        u = (lax.dot_general(s, bu, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32) & 1)
        u = u * (jrow < (r - r_in))[:, None]
        up = pack_bits(u)
        up = up * (widx >= (t + 1) * nbw)[None, :].astype(jnp.uint32)

        # ---- Schur update on the local shard ----
        a_loc = a_loc ^ mul_packed_data(lp_loc, up)
        return (a_loc, perm, pos_of, Pv, Qv, r), None

    # Q needs nb slack beyond n_pad for the per-panel dynamic updates
    init = (a_loc,
            jnp.arange(m_pad, dtype=jnp.int32),   # perm: position -> row
            jnp.arange(m_pad, dtype=jnp.int32),   # pos_of: row -> position
            jnp.arange(m_pad, dtype=jnp.int32),   # P (swap targets)
            jnp.arange(w_pad * WORD_BITS + nb, dtype=jnp.int32),  # Q
            jnp.int32(0))
    (a_loc, perm, pos_of, Pv, Qv, r), _ = lax.scan(
        panel, init, jnp.arange(n_panels, dtype=jnp.int32))
    return a_loc, perm, Pv, Qv, r


@functools.partial(jax.jit,
                   static_argnames=("m", "n", "nb", "W", "preserve_l",
                                    "engine", "mesh"))
def _dist_factor_impl(data, m: int, n: int, nb: int, W: int,
                      preserve_l: bool, engine: str, mesh):
    rx = mesh.shape["x"]
    n_pad = _round_up(n, nb)
    m_pad = _round_up(_round_up(m, nb) + W, rx)
    dpad = jnp.zeros((m_pad, n_pad // WORD_BITS), jnp.uint32)
    dpad = dpad.at[: data.shape[0], : data.shape[1]].set(data)
    fn = functools.partial(_ple_local, m=m, n=n, nb=nb, W=W,
                           preserve_l=preserve_l, engine=engine, mesh=mesh)
    sharded = jax.shard_map(
        fn, mesh=mesh, check_vma=False,
        in_specs=P("x", None),
        out_specs=(P("x", None), P(None), P(None), P(None), P()))
    a_out, perm, Pv, Qv, r = sharded(dpad)
    # reorder rows into position order (the reference's physical layout);
    # under jit+GSPMD this lowers to the collective row exchange
    a_pos = jnp.take(a_out, perm[:m], axis=0)
    return a_pos[:, : width_for(n)], Pv[:m], Qv[:n], r


def dist_block_factor(a: BitMatrix, mesh, preserve_l: bool,
                      nb: int = 128, window: int | None = None,
                      engine: str | None = None):
    """Distributed panel factorization; bit-identical outputs to the
    single-chip models/ple.block_factor (data in position order, P/Q in
    reference swap format, rank)."""
    cfg = get_config()
    if window is None:
        window = cfg.panel_window
    window = max(min(window, _round_up(a.nrows, nb)), nb)
    if engine is None:
        engine = default_engine()
    return _dist_factor_impl(a.data, a.nrows, a.ncols, nb, window,
                             preserve_l, engine, mesh)


def dist_ple(a: BitMatrix, mesh, nb: int = 128, window: int | None = None):
    """Distributed PLE (reference API: mzd_ple under SPMD): returns
    (M, P, Q, rank) exactly matching models/ple.ple."""
    from ..models.ple import _compress_l_impl
    data, p, q, r = dist_block_factor(a, mesh, preserve_l=True, nb=nb,
                                      window=window)
    data = _compress_l_impl(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(data, a.ncols)), p, q, r
