"""Blocked PLE / PLUQ factorization over GF(2).

Reference analogue: ple.c (block-recursive PLE), ple_russian.c (MMPF
Gray-code basecase).  The reference's design is a cache-driven recursion with
a sequential Gray-table basecase; the design here is a *panel
factorization with matrix-product Schur updates*:

- The matrix is swept in static column panels of width NB.  Within a panel,
  a fori_loop performs the canonical pivot hunt (columns left to right, first
  row >= rank with a 1 — the same pivot order as the reference
  `_mzd_ple_naive`, ple.c:223-273, so P/Q are reproduced exactly) using
  branchless masked vector ops.  The sequential loop runs only on a W-row
  *window* at positions r..r+W (reference analogue: ple_russian.c:119-188
  confines the serial Gray-code work to a bounded window for the same
  reason); rows outside the window are eliminated afterwards in one batched
  matrix-product step (multipliers lambda = X_piv @ U_piv^{-1} via the nilpotent
  series).  Exactness: every window candidate precedes every outside row in
  position order, so the window pivot *is* the canonical pivot whenever the
  window has one; the only failure mode — a column where the window has no
  candidate but an outside row does — is detected exactly from the batched
  residuals (at the first such column the fully-reduced outside bit equals
  the candidate bit) and triggers a lax.cond fallback that reruns the panel
  with a full-height window.
- The panel's unit-lower transform L11 is inverted with the nilpotent series
  (log2(NB) small matrix products) instead of sequential substitution,
  giving the panel's U rows in one multiply; the trailing Schur update is
  a single large GF(2) product (ops/mul.py, or the packed kernel of
  ops/gpu_mul.py on the GPU).  This keeps the O(n^3) work on the matrix
  units and leaves only O(n) cheap scalar steps sequential.  On the GPU
  the window's pivot loop runs as one kernel (ops/gpu_panel.py).
- Like the reference, the in-place result preserves L in the pivot columns
  (elimination touches only columns right of the pivot, cf.
  `mzd_row_add_offset(A, l, row, j+1)` in ple.c:245), then `_compress_l`
  moves L columns to the left (reference: ple.c:259-268, mzp.c:294).

Rank deficiency is handled with masks: shapes stay static, the rank is a
traced scalar, and padded rows/columns are zero so they can never pivot.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax

from ..core.bitmatrix import BitMatrix, mask_padding, width_for
from ..ops.mul import mul_packed_data, pack_bits, unpack_bits
from ..utils.config import WORD_BITS, get_config

__all__ = ["ple", "pluq", "block_factor"]


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _dot2(a, b):
    """int8 @ int8 mod 2 -> int8 (exact int32 accumulation)."""
    return (lax.dot_general(a, b, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
            & 1).astype(jnp.int8)


def _unit_upper_inv(nilp, eye, steps: int):
    """(I + N)^{-1} for nilpotent N via the product form
    prod_i (I + N^(2^i)) — log-depth small matrix products."""
    s, p = eye ^ nilp, nilp
    for _ in range(steps):
        p = _dot2(p, p)
        s = s ^ _dot2(p, s)
    return s


def _make_colstep(h: int, nb: int, base, t, r_in, m: int, preserve_l: bool,
                  search_window: int):
    """One canonical pivot step on an h-row slice AL = [panel | L]
    (packed words) whose row 0 sits at global position `base`.  Every
    op here runs n times total, so the body is trimmed to a minimum:
    a single min-reduction pivot search on an h-vector, a 2-row swap,
    and one fused outer-product XOR that updates the panel words and
    the L multiplier words together."""
    nbw = nb // WORD_BITS
    idx = jnp.arange(h, dtype=jnp.int32)
    lane = jnp.arange(2 * nbw, dtype=jnp.int32)
    panel_lane = lane < nbw

    def colstep(j, st):
        AL, rowperm, r, touched, p_pan, q_pan = st
        wloc = j // WORD_BITS
        sh = (j % WORD_BITS).astype(jnp.uint32)
        col = (jnp.take(AL, wloc, axis=1) >> sh) & 1
        pos = base + idx
        cand = (col == 1) & (pos >= r) & (pos < m)
        if search_window:
            # restricted pivot search (reference analogue:
            # _mzd_top_echelonize_m4ri searches only r..r+kk,
            # brilliantrussian.c:875)
            cand = cand & (pos < r + search_window)
        first = jnp.min(jnp.where(cand, idx, jnp.int32(h)))
        found = first < h
        rs = jnp.minimum(r - base, h - 1)
        ps = jnp.where(found, first, rs)

        al_rs, al_ps = AL[rs], AL[ps]
        AL = AL.at[rs].set(al_ps).at[ps].set(al_rs)
        rp_rs, rp_ps = rowperm[rs], rowperm[ps]
        rowperm = rowperm.at[rs].set(rp_ps).at[ps].set(rp_rs)

        touched = lax.dynamic_update_slice(
            touched, jnp.stack([rs, ps]), (2 * j,))
        slot = r - r_in
        p_pan = p_pan.at[slot].set(base + ps, mode="drop")
        q_pan = q_pan.at[slot].set(t * nb + j, mode="drop")

        pivrow = al_ps  # the row now sitting at position rs
        if preserve_l:
            # keep columns <= j intact (reference: row_add from col j+1)
            gt = ~(((jnp.uint32(1) << sh) << 1) - 1)  # bits > sh
            wmask = jnp.where(
                lane > wloc, jnp.uint32(0xFFFFFFFF),
                jnp.where(lane == wloc, gt, jnp.uint32(0)))
            wmask = jnp.where(panel_lane, wmask, jnp.uint32(0))
        else:
            wmask = jnp.where(panel_lane, jnp.uint32(0xFFFFFFFF),
                              jnp.uint32(0))
        # the eliminated rows also record their multiplier bit: one
        # extra set bit in the L half of the fused row
        lbit = jnp.where(
            lane == nbw + slot // WORD_BITS,
            jnp.uint32(1) << (slot % WORD_BITS).astype(jnp.uint32),
            jnp.uint32(0))
        elim_row = (pivrow & wmask) | lbit
        # post-swap elimination mask from the pre-swap column bits:
        # rows > r keep their bit except position ps which received
        # the old row rs (excluded anyway: col[rs] refers to the pivot
        # slot and rows > r excludes rs <= r)
        elim = col.at[ps].set(col[rs])
        elim = (elim == 1) & (pos > r) & found
        em = elim.astype(jnp.uint32)
        AL = AL ^ (em[:, None] * elim_row[None, :])
        r = r + found.astype(jnp.int32)
        return (AL, rowperm, r, touched, p_pan, q_pan)

    return colstep


def run_panel_loop(panel_words, r, base, t, r_in, m: int, nb: int,
                   preserve_l: bool, search_window: int, engine: str):
    """The canonical nb-column pivot loop on an h-row window (row 0 at
    global position `base`).  Shared by the single-chip factorization and
    the distributed PLE (which runs it replicated on every device).
    Returns (AL, rowperm, r, touched, p_pan, q_pan) with p/q global.

    engine "triton" runs the loop as one GPU kernel (ops/gpu_panel.py),
    "triton_interpret" runs that kernel under the Pallas interpreter, and
    "xla" is the fori_loop below.  The kernel carries its window in
    registers, so taller windows (the full-height miss fallback) stay on
    the XLA loop."""
    from ..ops.gpu_panel import MAX_ROWS, panel_loop
    h = panel_words.shape[0]
    nbw = nb // WORD_BITS
    AL0 = jnp.concatenate(
        [panel_words, jnp.zeros((h, nbw), jnp.uint32)], axis=1)
    if engine != "xla" and h <= MAX_ROWS:
        AL, rowperm, r2, touched, p_loc, q_loc = panel_loop(
            AL0, r, base, jnp.int32(m), nb=nb, preserve_l=preserve_l,
            search_window=search_window,
            interpret=(engine == "triton_interpret"))
        return (AL, rowperm, r2, touched, base + p_loc, t * nb + q_loc)
    st0 = (AL0, jnp.arange(h, dtype=jnp.int32), r,
           jnp.zeros((2 * nb,), jnp.int32),
           jnp.zeros((nb,), jnp.int32), jnp.zeros((nb,), jnp.int32))
    return lax.fori_loop(
        0, nb,
        _make_colstep(h, nb, base, t, r_in, m, preserve_l, search_window),
        st0)


def schur_update(A, lp, up, r0, c0w, engine: str):
    """A ^ lp @ up over GF(2) under the Schur contract (rows of lp above
    r0 and word columns of up left of c0w are zero).  The product route
    follows mul_packed_data's shape gate (the packed kernel skips the zero
    tiles and updates A in place); "xla" pins the plain route and
    "triton_interpret" the interpreted kernel."""
    return mul_packed_data(lp, up, allow_kernels=engine != "xla", c=A,
                           r0=r0, c0w=c0w,
                           interpret=engine == "triton_interpret")


def _apply_row_perm_window(A, rpw, r_in):
    """Apply a window-local row permutation: every swap endpoint of the
    fast path lies inside the W-row window at r_in, so one W-row slab
    gather replaces a full-height row scatter."""
    W = rpw.shape[0]
    slab = lax.dynamic_slice(A, (r_in, 0), (W, A.shape[1]))
    return lax.dynamic_update_slice(A, slab[rpw], (r_in, 0))


def _apply_row_perm_full(A, rp):
    """Full-height row permutation (miss fallback only)."""
    return A[rp]


def _write_panel_cols(A, panel_full, c0w):
    """Write the factored panel words back at lane offset c0w."""
    return lax.dynamic_update_slice(A, panel_full, (0, c0w))


@functools.partial(jax.jit, static_argnames=("m", "n", "nb", "preserve_l",
                                             "search_window", "window",
                                             "engine", "agg"))
def _block_factor_impl(data, m: int, n: int, nb: int, preserve_l: bool,
                       search_window: int = 0, window: int = 0,
                       engine: str = "xla", agg: int = 1):
    nbw = nb // WORD_BITS
    W = window
    assert W >= nb + search_window, (W, nb, search_window)
    # rounded to a whole number of product-kernel row tiles; the extra
    # all-zero rows can never pivot (pos < m guards) so every engine is
    # unaffected
    m_pad = _round_up(_round_up(m, nb) + W, 256)
    # block-aggregated mode pads the column count to whole blocks; the
    # all-zero pad panels cost one cheap window sweep each and rank 0
    agg_eff = max(1, min(agg, -(-n // nb)))
    n_pad = _round_up(n, agg_eff * nb)
    w_pad = n_pad // WORD_BITS
    n_panels = n_pad // nb

    A = jnp.zeros((m_pad, w_pad), jnp.uint32)
    A = A.at[: data.shape[0], : data.shape[1]].set(data)
    P = jnp.arange(m_pad, dtype=jnp.int32)
    # Q gets nb slack so the per-panel dynamic_update at offset r_in can
    # never clamp (r_in <= n_pad)
    Q = jnp.arange(n_pad + nb, dtype=jnp.int32)
    eye_nb = jnp.eye(nb, dtype=jnp.int8)
    widx = jnp.arange(w_pad, dtype=jnp.int32)
    jrow = jnp.arange(nb, dtype=jnp.int32)
    slotv = jnp.arange(nb, dtype=jnp.int32)
    pos_all = jnp.arange(m_pad, dtype=jnp.int32)
    steps = max(0, (nb - 1).bit_length() - 1)

    def run_loop(h: int, base, t, r_in, r, panel_words):
        return run_panel_loop(panel_words, r, base, t, r_in, m, nb,
                              preserve_l, search_window, engine)

    def panel_commit(A, P, Q, r, t):
        """Shared per-panel factorization through the in-place commit:
        window pivot loop, below-window elimination, miss fallback, P/Q
        records, row swaps, and the panel words written back into A.
        Returns (A, P, Q, r, Lpw, r_in, srcp, dstp) — the Schur tail
        differs between the flat and the block-aggregated sweeps."""
        r_in = r
        c0w = t * nbw
        Xw = lax.dynamic_slice(A, (0, c0w), (m_pad, nbw))  # stale panel words

        # ---- fast path: sequential loop on the W-row window only ----
        win = lax.dynamic_slice(Xw, (r_in, 0), (W, nbw))
        ALw, rpw, r_f, touched_f, p_f, q_f = run_loop(W, r_in, t, r_in, r, win)
        k_f = r_f - r_in

        # ---- batched elimination of the rows below the window ----
        live = slotv < k_f
        cloc = jnp.where(live, q_f - t * nb, 0)         # local pivot columns
        Pw = ALw[:nb]                                    # pivot-slot rows
        Pbits = unpack_bits(Pw[:, :nbw], jnp.int8)       # in-place panel rows
        urows = Pbits * live[:, None].astype(jnp.int8)
        # one-hot pivot-column rows: E[s] = e_{cloc[s]}
        E = ((cloc[:, None] == slotv[None, :]) & live[:, None]).astype(jnp.int8)
        if preserve_l:
            # the in-place pivot rows carry their own L multipliers at the
            # *earlier* pivot columns; clear them to get the clean U rows
            Lbits = unpack_bits(Pw[:, nbw:], jnp.int8)
            u_clean = (urows ^ _dot2(Lbits, E)) * live[:, None].astype(jnp.int8)
        else:
            u_clean = urows
        # U restricted to its pivot columns, in slot space: unit upper tri
        # (column selection via one-hot matrix products, not gathers)
        upiv = _dot2(u_clean, E.T)
        npiv = upiv * (slotv[None, :] > slotv[:, None]).astype(jnp.int8)
        T = _unit_upper_inv(npiv, eye_nb, steps)         # U_piv^{-1}
        # multipliers for every row below the window: lambda = X_piv @ T;
        # eliminated panel values v = X ^ lambda @ wmat (preserve_l
        # re-places lambda at the pivot columns, the reference's in-place
        # L layout).
        wmat = (u_clean ^ E) if preserve_l else u_clean
        pivcol = jnp.zeros((nb,), jnp.bool_).at[
            jnp.where(live, cloc, nb)].set(True, mode="drop")
        validcol = (t * nb + slotv) < n
        below = pos_all >= r_in + W
        Xu = unpack_bits(Xw, jnp.int8)
        xpiv = _dot2(Xu, E.T)
        lam = _dot2(xpiv, T) \
            * (live[None, :] & below[:, None]).astype(jnp.int8)
        vbits = Xu ^ _dot2(lam, wmat)
        selc = below[:, None]
        vw_full = jnp.where(selc, pack_bits(vbits), Xw)
        lamw_full = jnp.where(selc, pack_bits(lam), jnp.uint32(0))
        # ---- exact miss check: a declared-non-pivot column where some
        # below-window row still has a 1 means the canonical pivot was
        # outside the window -> rerun full-height.  A restricted search
        # (search_window) never pivots outside the window by construction
        # (r + search_window <= r_in + W), so a bare below-window 1 is
        # legitimate there and the check is off.
        colmask = pack_bits(
            (~pivcol & validcol)[None, :].astype(jnp.uint8))[0]
        rowmask = (pos_all >= r_in + W) & (pos_all < m)
        miss = jnp.any(jnp.where(
            rowmask[:, None], vw_full & colmask[None, :],
            jnp.uint32(0)) != 0)
        if search_window:
            miss = jnp.bool_(False)

        panel_fast = lax.dynamic_update_slice(vw_full, ALw[:, :nbw],
                                              (r_in, 0))
        lp_fast = lax.dynamic_update_slice(lamw_full, ALw[:, nbw:],
                                           (r_in, 0))

        def slow_branch(_):
            # exact full-height panel sweep (the round-1 engine, now on the
            # fused packed layout); runs only when the window missed
            AL, rp, r_s, touched_s, p_s, q_s = run_loop(
                m_pad, jnp.int32(0), t, r_in, r, Xw)
            return (AL[:, :nbw], AL[:, nbw:], rp[touched_s], touched_s,
                    p_s, q_s, r_s, _apply_row_perm_full(A, rp))

        def fast_branch(_):
            return (panel_fast, lp_fast, r_in + rpw[touched_f],
                    r_in + touched_f, p_f, q_f, r_f,
                    _apply_row_perm_window(A, rpw, r_in))

        panel_full, Lpw, srcp, dstp, p_pan, q_pan, r, A = lax.cond(
            miss, slow_branch, fast_branch, None)

        # commit the panel's pivot records into the global swap arrays
        rank_panel = r - r_in
        live2 = slotv < rank_panel
        p_old = lax.dynamic_slice(P, (r_in,), (nb,))
        q_old = lax.dynamic_slice(Q, (r_in,), (nb,))
        P = lax.dynamic_update_slice(P, jnp.where(live2, p_pan, p_old),
                                     (r_in,))
        Q = lax.dynamic_update_slice(Q, jnp.where(live2, q_pan, q_old),
                                     (r_in,))

        # the row permutation was applied inside the taken branch (window
        # slab gather on the fast path, full gather on the miss fallback)
        A = _write_panel_cols(A, panel_full, c0w)
        return A, P, Q, r, Lpw, r_in, srcp, dstp

    def panel(carry, t):
        A, P, Q, r = carry
        A, P, Q, r, Lpw, r_in, _, _ = panel_commit(A, P, Q, r, t)
        rank_panel = r - r_in

        # --- U rows of this panel via nilpotent inversion of L11 ---
        l11 = unpack_bits(
            lax.dynamic_slice(Lpw, (r_in, 0), (nb, nbw)), jnp.int8)
        s = _unit_upper_inv(l11, eye_nb, steps)
        a_block = lax.dynamic_slice(A, (r_in, 0), (nb, w_pad))
        au = unpack_bits(a_block, jnp.int8)
        u = (lax.dot_general(s, au, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32) & 1)
        u = u * (jrow < rank_panel)[:, None]
        # only trailing columns take the Schur update
        up = pack_bits(u) * (widx >= (t + 1) * nbw)[None, :].astype(
            jnp.uint32)

        # --- Schur update: A ^= Lp @ U ---
        A = schur_update(A, Lpw, up, r_in, (t + 1) * nbw, engine)
        return (A, P, Q, r), None

    if agg_eff <= 1:
        (A, P, Q, r), _ = lax.scan(
            panel, (A, P, Q, jnp.int32(0)),
            jnp.arange(n_panels, dtype=jnp.int32))
        return A[:m, : data.shape[1]], P[:m], Q[:n], r

    # ---- two-level block-aggregated sweep (reference analogue: the
    # PLE recursion updating only the trailing quadrant, ple.c:122-127).
    # Per-panel Schur updates touch only the current agg_eff-panel column
    # slab; each block then applies ONE deep aggregated update
    # A ^= L_blk @ U_blk to the trailing columns, which runs at the deep-
    # contraction kernel rate instead of the shallow per-panel rate, and
    # simultaneously converts the block's factored rows to U in place
    # (X ^ N@U = U for the strictly-lower multiplier matrix N). ----
    knbw = agg_eff * nbw
    knb = agg_eff * nb
    n_blocks = n_panels // agg_eff
    loc_widx = jnp.arange(knbw, dtype=jnp.int32)

    def block(carry, blk):
        A, P, Q, r = carry
        r0_blk = r
        blk_c0w = blk * knbw

        def panel_inner(icarry, sl):
            A, P, Q, r, Lblk, Ublk = icarry
            t = blk * agg_eff + sl
            A, P, Q, r, Lpw, r_in, srcp, dstp = panel_commit(A, P, Q, r, t)
            rank_panel = r - r_in
            # the block L store sees the same row swaps as A
            Lblk = Lblk.at[dstp].set(Lblk[srcp], mode="drop")
            Lblk = lax.dynamic_update_slice(Lblk, Lpw, (0, sl * nbw))

            # --- full-width U rows: the panel rows' block columns are
            # current (previous in-block Schur updates reached them) but
            # their trailing columns are stale — correct with the block's
            # accumulated U (Ublk is stored trailing-masked), then solve
            # the panel's unit-lower L11 via the nilpotent series ---
            rows_full = lax.dynamic_slice(A, (r_in, 0), (nb, w_pad))
            lam_rows = lax.dynamic_slice(Lblk, (r_in, 0), (nb, knbw))
            l11 = unpack_bits(
                lax.dynamic_slice(Lpw, (r_in, 0), (nb, nbw)), jnp.int8)
            sinv = _unit_upper_inv(l11, eye_nb, steps)
            corr = mul_packed_data(lam_rows, Ublk, allow_kernels=False)
            xu = unpack_bits(rows_full ^ corr, jnp.int8)
            u = (lax.dot_general(sinv, xu, (((1,), (0,)), ((), ())),
                                 preferred_element_type=jnp.int32) & 1)
            up_full = pack_bits(u)
            up_full = up_full * (jrow < rank_panel)[:, None].astype(
                jnp.uint32)

            # in-block part feeds this panel's slab Schur update
            up_local = lax.dynamic_slice(up_full, (0, blk_c0w), (nb, knbw))
            up_local = up_local * (loc_widx >= (sl + 1) * nbw)[
                None, :].astype(jnp.uint32)
            # block-trailing part accumulates into the aggregated U
            Ublk = lax.dynamic_update_slice(
                Ublk,
                up_full * (widx >= (blk + 1) * knbw)[None, :].astype(
                    jnp.uint32),
                (sl * nb, 0))

            # --- Schur update restricted to the block slab ---
            A_blk = lax.dynamic_slice(A, (0, blk_c0w), (m_pad, knbw))
            A_blk = schur_update(A_blk, Lpw, up_local, r_in,
                                 (sl + 1) * nbw, engine)
            A = lax.dynamic_update_slice(A, A_blk, (0, blk_c0w))
            return (A, P, Q, r, Lblk, Ublk), None

        Lblk0 = jnp.zeros((m_pad, knbw), jnp.uint32)
        Ublk0 = jnp.zeros((knb, w_pad), jnp.uint32)
        (A, P, Q, r, Lblk, Ublk), _ = lax.scan(
            panel_inner, (A, P, Q, r, Lblk0, Ublk0),
            jnp.arange(agg_eff, dtype=jnp.int32))

        # --- aggregated trailing update at the deep-contraction rate ---
        A = schur_update(A, Lblk, Ublk, r0_blk, (blk + 1) * knbw, engine)
        return (A, P, Q, r), None

    (A, P, Q, r), _ = lax.scan(
        block, (A, P, Q, jnp.int32(0)),
        jnp.arange(n_blocks, dtype=jnp.int32))
    return A[:m, : data.shape[1]], P[:m], Q[:n], r


def default_engine() -> str:
    """The factorization kernels run on the GPU; elsewhere plain XLA."""
    return "triton" if jax.default_backend() == "gpu" else "xla"


def block_factor(a: BitMatrix, preserve_l: bool, nb: int | None = None,
                 search_window: int = 0, window: int | None = None,
                 engine: str | None = None):
    """Shared panel factorization.  Returns (data, P, Q, rank) where data is
    the in-place pre-compress layout: rows 0..r-1 are the echelon rows E
    (pivot i at column Q[i]); if preserve_l, the L multipliers are preserved
    in the pivot columns below each pivot (reference pre-compress layout).

    ``engine``: "triton" (the GPU pivot-loop kernel, and the product
    kernel where mul_packed_data's shape gate picks it; the GPU default),
    "xla" (plain XLA; the default elsewhere), or "triton_interpret" (both
    kernels under the Pallas interpreter at every shape — used by the CPU
    test suite to keep the GPU path covered)."""
    cfg = get_config()
    nb_default = nb is None
    if nb_default:
        nb = cfg.panel_width
    nb = max(WORD_BITS, _round_up(min(nb, max(WORD_BITS, a.ncols)), WORD_BITS))
    if window is None:
        # the default window, or the default search margin over a caller nb
        window = cfg.panel_window if nb_default else \
            nb + (cfg.panel_window - cfg.panel_width)
    # no point in a window taller than the padded matrix; never shorter
    # than the panel (all pivot slots) plus any restricted-search depth
    window = max(min(window, _round_up(a.nrows, nb)), nb + search_window)
    if engine is None:
        engine = default_engine()
    data, p, q, r = _block_factor_impl(
        a.data, a.nrows, a.ncols, nb, preserve_l, search_window, window,
        engine, cfg.ple_block_panels)
    return data, p, q, r


@functools.partial(jax.jit, static_argnames=("m", "n"))
def _compress_l_seq(data, q, r, m: int, n: int):
    """Sequential reference semantics of the L compression (one masked
    column swap per pivot) — kept as the cross-validation sibling of the
    vectorized version below."""
    ridx = jnp.arange(m, dtype=jnp.int32)

    def body(j, data):
        a = q[j]
        b = jnp.int32(j)
        wa, sa = a // WORD_BITS, (a % WORD_BITS).astype(jnp.uint32)
        wb, sb = b // WORD_BITS, (b % WORD_BITS).astype(jnp.uint32)
        bits_a = (data[:, wa] >> sa) & 1
        bits_b = (data[:, wb] >> sb) & 1
        act = ((ridx >= b) & (j < r)).astype(jnp.uint32)
        diff = (bits_a ^ bits_b) * act
        data = data.at[:, wa].set(data[:, wa] ^ (diff << sa))
        data = data.at[:, wb].set(data[:, wb] ^ (diff << sb))
        return data

    return lax.fori_loop(0, min(m, n), body, data)


@functools.partial(jax.jit, static_argnames=("m", "n"))
def _compress_l_impl(data, q, r, m: int, n: int):
    """Move L columns into 0..r-1 (reference: _mzd_ple_naive compression,
    ple.c:259-268 — for j < r ascending: col_swap_in_rows(A, Q[j], j,
    rows j..m)).

    Vectorized: because Q is injective and Q[j] >= j, each column's content
    changes at most twice across the whole ascending swap sequence —
    once in its *source* role (some j with Q[j] = c pulls the then-current
    column j into c, whose origin is resolved by chasing the j <- Q[j'] = j
    chain with pointer doubling) and once in its *target* role (column
    c < r receives the original column Q[c]; Q[c]'s content is provably
    untouched before step c).  The sequential loop therefore collapses into
    two column gathers and masked selects — O(log r) tiny steps instead of
    min(m, n) full passes."""
    import numpy as np

    rmax = min(m, n)
    c = jnp.arange(n, dtype=jnp.int32)
    t = jnp.arange(rmax, dtype=jnp.int32)
    qv = q[:rmax]
    real = (t < r) & (qv != t)  # real swaps (Q[j] > j since Q[j] >= j)

    # src_event[c] = the j with Q[j] = c (if any real one exists)
    src_event = jnp.full((n,), jnp.int32(n))
    src_event = src_event.at[jnp.where(real, qv, jnp.int32(n))].set(
        t, mode="drop")
    # chase the chain j <- (j' with Q[j'] = j) to its origin column
    f = jnp.where(src_event[:rmax] < n, src_event[:rmax], t)
    for _ in range(max(1, int(np.ceil(np.log2(max(rmax, 2)))))):
        f = f[f]

    sv = src_event < n  # column is a swap source
    o1 = jnp.where(sv, f[jnp.clip(src_event, 0, rmax - 1)], c)
    tv = jnp.zeros((n,), jnp.bool_).at[:rmax].set(real)  # column is a target
    o2 = jnp.where(tv, jnp.pad(qv, (0, n - rmax)), c)

    # Work fully packed: transpose, per-COLUMN (now row) packed gathers and
    # threshold-mask merges, transpose back.  The unpacked formulation this
    # replaces materialized several m x n int8 intermediates (~1 GB each at
    # 32768) — ~10x the memory traffic of the two butterfly transposes
    # here.
    from ..core.transpose import transpose

    dt = transpose(BitMatrix(data[:, :width_for(n)], n)).data  # (n, w(m))
    wm = dt.shape[1]
    g1 = dt[o1]  # packed source-origin columns
    g2 = dt[o2]  # packed target-origin columns

    def row_ge_mask(th):
        """uint32[n, wm]: bit i set iff i >= th[c] (lane i of row c)."""
        wi = jnp.arange(wm, dtype=jnp.int32)[None, :]
        full = (wi >= ((th[:, None] + 31) // 32)).astype(jnp.uint32)
        part = (wi == (th[:, None] // 32))
        sh = (th[:, None] % 32).astype(jnp.uint32)
        return full * jnp.uint32(0xFFFFFFFF) | jnp.where(
            part, jnp.uint32(0xFFFFFFFF) << sh, jnp.uint32(0))

    m1 = row_ge_mask(jnp.where(sv, src_event, jnp.int32(m)))
    m2 = row_ge_mask(jnp.where(tv, c, jnp.int32(m)))
    # per column: [0, src): orig, [src, c): g1, [c, m): g2
    out_t = (dt & ~m1 & ~m2) | (g1 & m1 & ~m2) | (g2 & m2)
    packed = transpose(BitMatrix(out_t, m)).data
    w = data.shape[1]
    if packed.shape[1] < w:
        packed = jnp.pad(packed, ((0, 0), (0, w - packed.shape[1])))
    return packed[:, :w]


def ple(a: BitMatrix, nb: int | None = None):
    """PLE decomposition (reference API: mzd_ple, ple.c:33).

    Returns (M, P, Q, rank): M holds L (unit lower, columns 0..r-1,
    compressed) and S=E in place exactly like the reference; P, Q are
    LAPACK-style swap arrays (mzp_t format)."""
    data, p, q, r = block_factor(a, preserve_l=True, nb=nb)
    data = _compress_l_impl(data, q, r, a.nrows, a.ncols)
    return mask_padding(BitMatrix(data, a.ncols)), p, q, r


def pluq(a: BitMatrix, nb: int | None = None):
    """PLUQ decomposition (reference API: mzd_pluq = _mzd_ple +
    mzd_apply_p_right_trans_tri, ple.c:50-60).

    The L-compression and the path-blend tri-apply stay separate
    dispatches: the path blend reads Q on the host, and fusing the two
    would hold the compression back until that read."""
    from ..core.permutation import apply_p_right_trans_tri
    m, p, q, r = ple(a, nb=nb)
    m = apply_p_right_trans_tri(m, q)
    return m, p, q, r
