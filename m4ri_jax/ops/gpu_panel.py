"""Pivot-loop kernel for the panel factorization on the GPU (Pallas
through Triton).

The canonical nb-column pivot hunt of models/ple.py (``_make_colstep``) is
serial by nature.  As an XLA ``fori_loop`` every column costs several
dependent kernel launches.  Here one program runs the whole panel: the
h-row window of fused [panel | L] words is a loop-carried value that stays
on chip for all nb columns, and every step that the XLA loop does with a
dynamic row index becomes a masked block reduction — the pivot search a
min over the rows, the fetch of rows rs/ps a masked sum over the rows,
the swap and the elimination selects over the whole window.

The current panel word of every row is cached pre-shifted (``cw``, column
j at bit 0), so the per-column bit extraction is one AND; the cache is
refilled from the window once per 32 columns (the outer loop over words).

Reference analogue: ple_russian.c:119-188 confines the serial pivot work
to a cache-resident window for the same reason.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..utils.config import WORD_BITS

__all__ = ["panel_loop", "MAX_ROWS"]

# Window rows one block holds (after padding to a power of two): the
# window is carried in registers, at most 1024 x 32 words.
MAX_ROWS = 1024


def _pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


def _kernel(s_ref, al_in, al_ref, rp_ref, tch_ref, pp_ref, qq_ref, r_ref,
            *, h: int, hp: int, nb: int, preserve_l: bool,
            search_window: int):
    # every block dimension is a power of two (Triton's rule): hp rows,
    # wp >= 2*nbw lanes ([panel | L | zero pad]), nbp >= nb record slots
    nbw = nb // WORD_BITS
    wp = al_in.shape[1]
    nbp = pp_ref.shape[0]
    r0, base, m = s_ref[0], s_ref[1], s_ref[2]
    idx = jnp.arange(hp, dtype=jnp.int32)
    lane = jnp.arange(wp, dtype=jnp.int32)
    slots = jnp.arange(nbp, dtype=jnp.int32)
    tslots = jnp.arange(2 * nbp, dtype=jnp.int32)
    pos_ok = (idx < h) & (base + idx < m)
    ones = jnp.uint32(0xFFFFFFFF)
    zero = jnp.uint32(0)

    def word_step(wloc, st):
        AL, rp, r, tch, pp, qq = st
        cw = jnp.sum(jnp.where(lane[None, :] == wloc, AL, zero), axis=1)
        at_w = lane == wloc

        def bit_step(sh, st):
            AL, cw, rp, r, tch, pp, qq = st
            j = wloc * WORD_BITS + sh
            shu = sh.astype(jnp.uint32)
            col = (cw & 1).astype(jnp.int32)
            rs = jnp.minimum(r - base, h - 1)
            cand = (col == 1) & (idx >= rs) & pos_ok
            if search_window:
                cand = cand & (idx < rs + search_window)
            first = jnp.min(jnp.where(cand, idx, jnp.int32(hp)))
            found = first < hp
            ps = jnp.where(found, first, rs)
            at_rs, at_ps = idx == rs, idx == ps

            # the two rows (masked sums over the rows), and both rowperm
            # entries in one sum: rp < 2**15, so they pack into one int32
            row_rs = jnp.sum(jnp.where(at_rs[:, None], AL, zero), axis=0)
            row_ps = jnp.sum(jnp.where(at_ps[:, None], AL, zero), axis=0)
            rp2 = jnp.sum(jnp.where(at_rs, rp, 0)
                          + jnp.where(at_ps, rp << 16, 0))
            rp_rs, rp_ps = rp2 & 0xFFFF, rp2 >> 16
            # cw caches AL[:, wloc] >> sh, so the rows' cached words
            # come from the fetched rows (a reduction over 32 lanes)
            cw_rs = jnp.sum(jnp.where(at_w, row_rs, zero)) >> shu
            cw_ps = jnp.sum(jnp.where(at_w, row_ps, zero)) >> shu
            AL = jnp.where(at_rs[:, None], row_ps[None, :],
                           jnp.where(at_ps[:, None], row_rs[None, :], AL))
            cw = jnp.where(at_rs, cw_ps, jnp.where(at_ps, cw_rs, cw))
            rp = jnp.where(at_rs, rp_ps, jnp.where(at_ps, rp_rs, rp))

            slot = r - r0
            tch = jnp.where(tslots == 2 * j, rs,
                            jnp.where(tslots == 2 * j + 1, ps, tch))
            pp = jnp.where(slots == slot, ps, pp)
            qq = jnp.where(slots == slot, j, qq)

            if preserve_l:
                # keep columns <= j intact (reference: row_add from j+1)
                gt = ~(((jnp.uint32(1) << shu) << 1) - 1)
                wmask = jnp.where(lane > wloc, ones,
                                  jnp.where(at_w, gt, zero))
                wmask = jnp.where(lane < nbw, wmask, zero)
            else:
                wmask = jnp.where(lane < nbw, ones, zero)
            lbit = jnp.where(
                lane == nbw + slot // WORD_BITS,
                jnp.uint32(1) << (slot % WORD_BITS).astype(jnp.uint32),
                zero)
            elim_row = (row_ps & wmask) | lbit
            # the eliminated word at lane wloc in cw's shifted domain
            ew = jnp.sum(jnp.where(at_w, elim_row, zero)) >> shu
            # post-swap column bits: position ps received old row rs
            col2 = jnp.where(at_ps, (cw_rs & 1).astype(jnp.int32), col)
            elim = (col2 == 1) & (idx > rs) & found
            AL = AL ^ jnp.where(elim[:, None], elim_row[None, :], zero)
            cw = (cw ^ jnp.where(elim, ew, zero)) >> 1
            return (AL, cw, rp, r + found.astype(jnp.int32), tch, pp, qq)

        AL, _, rp, r, tch, pp, qq = lax.fori_loop(
            0, WORD_BITS, bit_step, (AL, cw, rp, r, tch, pp, qq))
        return (AL, rp, r, tch, pp, qq)

    st = (al_in[...], idx,
          r0, jnp.zeros((2 * nbp,), jnp.int32),
          jnp.zeros((nbp,), jnp.int32), jnp.zeros((nbp,), jnp.int32))
    AL, rp, r, tch, pp, qq = lax.fori_loop(0, nbw, word_step, st)
    al_ref[...] = AL
    rp_ref[...] = rp
    tch_ref[...] = tch
    pp_ref[...] = pp
    qq_ref[...] = qq
    r_ref[...] = jnp.full((16,), r, jnp.int32)


@functools.partial(jax.jit, static_argnames=("nb", "preserve_l",
                                             "search_window", "num_warps",
                                             "interpret"))
def panel_loop(al0, r0, base, m, nb: int, preserve_l: bool,
               search_window: int = 0, num_warps: int | None = None,
               interpret: bool = False):
    """Run the canonical nb-column pivot loop on a fused [panel | L] window.

    al0: uint32 (h, 2*nbw), h <= MAX_ROWS; r0/base/m: traced int32
    scalars (current rank, global position of window row 0, valid row
    count).  Returns (AL, rowperm (h,), r, touched (2nb,), p_pan (nb,),
    q_pan (nb,)) with the *local* conventions of models/ple.py
    _make_colstep (p_pan/q_pan are window-local; the caller adds base /
    panel-column offsets)."""
    h, w2 = al0.shape
    if w2 != 2 * (nb // WORD_BITS) or h > MAX_ROWS:
        raise ValueError(f"window {al0.shape} does not fit the kernel for "
                         f"nb={nb} (at most {MAX_ROWS} rows)")
    hp, wp, nbp = _pow2(h), _pow2(w2), _pow2(nb)
    al = al0
    if (hp, wp) != (h, w2):
        al = jnp.pad(al0, ((0, hp - h), (0, wp - w2)))
    scalars = jnp.stack([jnp.asarray(r0, jnp.int32),
                         jnp.asarray(base, jnp.int32),
                         jnp.asarray(m, jnp.int32)])
    # 4 warps for a 512 x 16-word window, 8 for 1024 x 32
    warps = num_warps or max(4, min(16, hp * wp // 4096))
    al_o, rp, tch, pp, qq, r = pl.pallas_call(
        functools.partial(_kernel, h=h, hp=hp, nb=nb, preserve_l=preserve_l,
                          search_window=search_window),
        out_shape=[
            jax.ShapeDtypeStruct((hp, wp), jnp.uint32),
            jax.ShapeDtypeStruct((hp,), jnp.int32),
            jax.ShapeDtypeStruct((2 * nbp,), jnp.int32),
            jax.ShapeDtypeStruct((nbp,), jnp.int32),
            jax.ShapeDtypeStruct((nbp,), jnp.int32),
            jax.ShapeDtypeStruct((16,), jnp.int32),
        ],
        compiler_params=pltriton.CompilerParams(num_warps=warps,
                                                num_stages=1),
        interpret=interpret,
        name="gf2_panel_loop",
    )(scalars, al)
    return (al_o[:h, :w2], rp[:h], r[0], tch[:2 * nb], pp[:nb], qq[:nb])
