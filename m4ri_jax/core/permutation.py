"""LAPACK-style permutations (reference: mzp_t, mzp.h:37-49, mzp.c).

A permutation is stored as a swap array ``v`` with ``v[i] >= i``; applying it
"left" (to rows) means performing ``swap(i, v[i])`` for i ascending
(mzd_apply_p_left, mzp.c:65-72); the transpose applies the swaps descending
(mzp.c:74-81).  We keep this exact format so P/Q outputs are interchangeable
with the reference's.

Design: instead of materializing each swap as a row copy, the swap
sequence is folded into a single permutation vector (a sequential fori_loop
over *scalars*), and the matrix is permuted with one gather.  Column
applications gather bit-columns through unpack/pack.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp

from ..utils.config import WORD_BITS
from .bitmatrix import BitMatrix, mask_padding
from ..ops.mul import pack_bits, unpack_bits

__all__ = [
    "swaps_to_perm", "invert_perm", "apply_p_left", "apply_p_left_trans",
    "apply_p_right", "apply_p_right_trans", "apply_p_right_trans_tri",
    "permute_rows", "permute_cols",
]

# int32 elements per (rows x ncols) temporary in apply_p_right_trans_tri
# (~512 MB); module-level so tests can shrink it to force chunking
_TRANS_TRI_CHUNK_ELEMS = 1 << 27


def swaps_to_perm_seq(v: jnp.ndarray, ascending: bool = True) -> jnp.ndarray:
    """Sequential reference model of the swap fold (one fori step per
    swap) — kept as the cross-validation oracle for swaps_to_perm."""
    n = v.shape[0]

    def body(k, perm):
        i = k if ascending else n - 1 - k
        j = v[i]
        pi, pj = perm[i], perm[j]
        return perm.at[i].set(pj).at[j].set(pi)

    return jax.lax.fori_loop(0, n, body, jnp.arange(n, dtype=jnp.int32))


def swaps_to_perm(v: jnp.ndarray, ascending: bool = True) -> jnp.ndarray:
    """Fold the swap sequence into a permutation ``perm`` such that
    ``new[i] = old[perm[i]]``.

    Vectorized (no O(n)-step scalar loop): with the LAPACK contract
    ``v[i] >= i``, step i is the LAST step that touches slot i (later
    steps touch only slots >= i+1), so ``perm[i]`` equals the content of
    slot v[i] just before step i.  That content is determined by two
    dataflow relations — ``pred(i)`` = previous step with the same target
    value, and ``tgt_pred(x)`` = last step before x that targeted slot x
    — whose chains are chased to their terminals with pointer doubling
    (O(log n) gathers), exactly the _compress_l_impl technique
    (models/ple.py).  Reference semantics: mzp.c:65-81."""
    import numpy as np

    n = v.shape[0]
    if n == 0:
        return jnp.arange(0, dtype=jnp.int32)
    v = v.astype(jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)

    # pred[i] = previous occurrence of value v[i] (or -1): stable argsort
    # groups equal values in index order, so the sorted left neighbour of
    # an equal value is the previous occurrence.
    order = jnp.argsort(v, stable=True)
    sv = v[order]
    prev_sorted = jnp.where((idx > 0) & (sv == jnp.roll(sv, 1)),
                            jnp.roll(order, 1), jnp.int32(-1))
    pred = jnp.zeros((n,), jnp.int32).at[order].set(prev_sorted)

    # last[c] = last step targeting slot c (scatter-max; v[j] = c => j<=c)
    last = jnp.full((n,), -1, jnp.int32).at[v].max(idx, mode="drop")

    # tgt_pred(x) = last step < x with target x.  All targets of x are at
    # steps <= x; step x itself targets x only when v[x] == x, in which
    # case its previous occurrence is pred(x).
    tp = jnp.where(v == idx, pred, last)
    f = jnp.where(tp >= 0, tp, idx)  # terminal steps point to themselves
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))))):
        f = f[f]
    # g[x] = f-terminal = original index occupying slot x before step x
    perm = jnp.where(pred >= 0, f[jnp.clip(pred, 0)], v)
    if not ascending:
        # descending application composes the same transpositions in
        # reverse order, i.e. the inverse permutation (mzp.c:74-81)
        perm = invert_perm(perm)
    return perm


def invert_perm(perm: jnp.ndarray) -> jnp.ndarray:
    n = perm.shape[0]
    return jnp.zeros((n,), jnp.int32).at[perm].set(jnp.arange(n, dtype=jnp.int32))


def permute_rows(m: BitMatrix, perm: jnp.ndarray) -> BitMatrix:
    return BitMatrix(m.data[perm, :], m.ncols)


def permute_cols(m: BitMatrix, perm: jnp.ndarray) -> BitMatrix:
    """new[:, j] = old[:, perm[j]] via unpack/gather/pack."""
    bits = unpack_bits(m.data, jnp.uint8)  # (rows, width*32)
    out = bits[:, perm]
    return mask_padding(BitMatrix(pack_bits(out), m.ncols))


@jax.jit
def apply_p_left(m: BitMatrix, v: jnp.ndarray) -> BitMatrix:
    """Row swaps ascending (reference: mzd_apply_p_left, mzp.c:65)."""
    return permute_rows(m, swaps_to_perm(v[: m.nrows], True))


@jax.jit
def apply_p_left_trans(m: BitMatrix, v: jnp.ndarray) -> BitMatrix:
    """Row swaps descending (reference: mzd_apply_p_left_trans, mzp.c:74)."""
    return permute_rows(m, swaps_to_perm(v[: m.nrows], False))


@jax.jit
def apply_p_right(m: BitMatrix, v: jnp.ndarray) -> BitMatrix:
    """Column swaps descending (reference: mzd_apply_p_right applies swaps
    from the last index down, mzp.c:252-262)."""
    return permute_cols(m, swaps_to_perm(v[: m.ncols], False))


@jax.jit
def apply_p_right_trans(m: BitMatrix, v: jnp.ndarray) -> BitMatrix:
    """Column swaps ascending (reference: mzd_apply_p_right_trans)."""
    return permute_cols(m, swaps_to_perm(v[: m.ncols], True))


def apply_p_right_trans_tri_seq(m: BitMatrix, v: jnp.ndarray) -> BitMatrix:
    """Sequential reference model (one fori step per swap) — the
    cross-validation oracle for apply_p_right_trans_tri, and the exact
    semantics for arbitrary (non-PLE) swap arrays."""
    n = min(m.ncols, v.shape[0])
    ridx = jnp.arange(m.nrows, dtype=jnp.int32)[:, None]

    def body(i, data):
        a = jnp.int32(i)
        b = v[i]
        wa, sa = a // WORD_BITS, (a % WORD_BITS).astype(jnp.uint32)
        wb, sb = b // WORD_BITS, (b % WORD_BITS).astype(jnp.uint32)
        bits_a = (data[:, wa] >> sa) & 1
        bits_b = (data[:, wb] >> sb) & 1
        diff = (bits_a ^ bits_b) * (ridx[:, 0] < a).astype(jnp.uint32)
        data = data.at[:, wa].set(data[:, wa] ^ (diff << sa))
        data = data.at[:, wb].set(data[:, wb] ^ (diff << sb))
        return data

    data = jax.lax.fori_loop(0, n, body, m.data)
    return BitMatrix(data, m.ncols)


def _trans_tri_rowchunk(m: BitMatrix, v: jnp.ndarray) -> BitMatrix:
    return _trans_tri_rowchunk_impl(m, v, _TRANS_TRI_CHUNK_ELEMS)


@functools.partial(jax.jit, static_argnames=("chunk_elems",))
def _trans_tri_rowchunk_impl(m: BitMatrix, v: jnp.ndarray,
                             chunk_elems: int) -> BitMatrix:
    """Row-chunked lane-gather implementation of trans_tri (see
    apply_p_right_trans_tri for the semantics).

    Vectorized under the PLE-Q contract (v[i] >= i; at most one *real*
    swap — v[j] > j — targets any column, which holds for PLE's Q since
    pivot columns are distinct and the tail is identity).  Each real-step
    column c < n receives the pristine column v[c] in rows < c; every
    other cell chains through ``pre(x)`` = the real step targeting column
    x.  Because both pre and its inverse are partial functions, the
    chains are disjoint descending paths, and the per-row answer is
    ``orig[r, min(A[r, path(c)], c)]`` where A[r, T] = the smallest node
    of path T that is > r — built with one scatter plus a reverse
    row-cummin instead of an n-step scalar loop.

    The final per-row lane gather (take_along_axis axis=1) is a
    per-element gather — production sizes use _trans_tri_banded instead;
    this stays as the small-size path and as a second vectorized model for
    tests."""
    nrows, ncols = m.nrows, m.ncols
    n = min(ncols, v.shape[0])
    c = jnp.arange(ncols, dtype=jnp.int32)
    v_ext = jnp.concatenate([v[:n].astype(jnp.int32),
                             jnp.arange(n, ncols, dtype=jnp.int32)])
    real = v_ext > c
    # pre[x] = the real step targeting column x (unique per the contract)
    pre = jnp.full((ncols,), -1, jnp.int32).at[
        jnp.where(real, v_ext, ncols)].max(c, mode="drop")
    # path id = terminal of the pre-chain (pointer doubling, 1-D)
    import numpy as np
    f = jnp.where(pre >= 0, pre, c)
    for _ in range(max(1, int(np.ceil(np.log2(max(ncols, 2)))))):
        f = f[f]
    pathid = f

    # A[r, T] = min{node y on path T : y > r}: node y activates rows < y
    # (scatter at row min(y-1, nrows-1)), then reverse cummin down the
    # rows.  Row-chunked bottom-up with a running min carry so the
    # (rows x ncols) int32 temporaries stay ~512 MB at any n (an
    # unchunked 32768^2 pluq would hold several 4 GB buffers at once).
    sentinel = jnp.int32(2**31 - 1)
    node_row = jnp.clip(c - 1, 0, nrows - 1)
    node_val = jnp.where(c >= 1, c, sentinel)
    bits = unpack_bits(m.data, jnp.uint8)[:, :ncols]
    chunk = max(1, min(nrows, chunk_elems // max(ncols, 1)))
    carry = jnp.full((ncols,), sentinel)
    out_rows = [None] * ((nrows + chunk - 1) // chunk)
    starts = list(range(0, nrows, chunk))
    for ci in reversed(range(len(starts))):
        r1 = starts[ci]
        rows = min(chunk, nrows - r1)
        B = jnp.full((rows, ncols), sentinel)
        # mask nodes outside the chunk BEFORE scattering: negative
        # indices wrap (numpy semantics) before mode="drop" applies
        local = node_row - r1
        ok = (local >= 0) & (local < rows)
        B = B.at[jnp.where(ok, local, rows), pathid].min(
            jnp.where(ok, node_val, sentinel), mode="drop")
        A = jnp.minimum(jax.lax.cummin(B, axis=0, reverse=True),
                        carry[None, :])
        carry = A[0]
        sel = jnp.minimum(A[:, pathid], c[None, :]).astype(jnp.int32)
        ridx = (r1 + jnp.arange(rows, dtype=jnp.int32))[:, None]
        src = jnp.where(real[None, :] & (ridx < c[None, :]),
                        jnp.broadcast_to(v_ext[None, :], sel.shape), sel)
        out_rows[ci] = jnp.take_along_axis(bits[r1:r1 + rows], src, axis=1)
    out = out_rows[0] if len(out_rows) == 1 else \
        jnp.concatenate(out_rows, axis=0)
    packed = pack_bits(out)
    w = m.data.shape[1]
    if packed.shape[1] < w:
        packed = jnp.pad(packed, ((0, 0), (0, w - packed.shape[1])))
    return mask_padding(BitMatrix(packed[:, :w], ncols))


# rows per band in the banded trans_tri (8 packed words); module-level so
# tests can shrink it to exercise multi-band seams on small matrices
_TRANS_TRI_BAND = 256
# rows per sub-band for the in-band correction's matmul decomposition
# (clamped to the band height; must divide it)
_TRANS_TRI_SUBBAND = 32


def _band_suffix_folds(w: jnp.ndarray) -> jnp.ndarray:
    """All suffix folds of per-band slot-space swap sequences.

    ``w`` is (B, 2h) int32 obeying the trans_tri contract per band
    (w[p] >= p; at most one real step targets any slot; steps exist only
    for p < h, higher slots are identity).  Returns src (B, h+1, 2h)
    where src[b, 1+j, p] is the slot whose ORIGINAL content ends up in
    slot p after applying steps j' > j ascending (band row j's view), and
    src[b, 0] is the full fold over all band steps (the j = -1 row, used
    to chain suffix permutations across bands).

    Same path/reverse-cummin construction as _trans_tri_rowchunk, batched
    over bands, with the extra leading row.  The node table is built with
    broadcast compares (an .at[].min scatter serializes per index) and
    the path-indexed read runs as an exact one-hot f32 matrix product
    instead of a take_along_axis lane gather."""
    import numpy as np

    Bn, two_h = w.shape
    h = two_h // 2
    c = jnp.arange(two_h, dtype=jnp.int32)
    bidx = jnp.arange(Bn, dtype=jnp.int32)[:, None]
    real = w > c[None, :]
    # pre[b, x] = the real step targeting slot x (unique per contract)
    pre = jnp.full((Bn, two_h), -1, jnp.int32).at[
        bidx, jnp.where(real, w, two_h)].max(
        jnp.broadcast_to(c[None, :], w.shape), mode="drop")
    f = jnp.where(pre >= 0, pre, c[None, :])
    for _ in range(max(1, int(np.ceil(np.log2(max(two_h, 2)))))):
        f = jnp.take_along_axis(f, f, axis=1)
    pathid = f
    # node y on a path activates rows j < y; with the leading j = -1 row
    # (index 0) node y lands at row index min(y, h).  Node values are
    # step indices (< h), but every slot is a node — trivial slots form
    # their own single-node path and reduce to the identity below.
    # Rows 0..h-1 hold one node each (y = row); row h folds nodes y >= h
    # with a masked min — no scatter anywhere.
    sentinel = jnp.int32(2**31 - 1)
    onehot_lo = pathid[:, :h, None] == c[None, None, :]      # (Bn, h, 2h)
    rows_lo = jnp.where(onehot_lo, c[None, :h, None], sentinel)
    onehot_hi = pathid[:, h:, None] == c[None, None, :]      # (Bn, h, 2h)
    row_hi = jnp.min(jnp.where(onehot_hi, c[None, h:, None], sentinel),
                     axis=1, keepdims=True)                  # (Bn, 1, 2h)
    B = jnp.concatenate([rows_lo, row_hi], axis=1)           # (Bn, h+1, 2h)
    A = jax.lax.cummin(B, axis=1, reverse=True)
    # src values are bounded by 2h after the min with c below, so clip
    # the sentinel to 2h and read A at pathid as an exact f32 product
    oh = (pathid[:, None, :] == c[None, :, None]).astype(jnp.float32)
    Ag = jnp.einsum("brq,bqp->brp", jnp.minimum(A, two_h).astype(jnp.float32),
                    oh, precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)
    sel = jnp.minimum(Ag, c[None, None, :])
    jrow = jnp.arange(-1, h, dtype=jnp.int32)[None, :, None]
    return jnp.where(real[:, None, :] & (jrow < c[None, None, :]),
                     jnp.broadcast_to(w[:, None, :], sel.shape), sel)


def _trans_tri_banded(m: BitMatrix, v: jnp.ndarray) -> BitMatrix:
    h = _TRANS_TRI_BAND
    # g must divide h (trace-time assert below); gcd keeps that true for
    # any h override (tests shrink _TRANS_TRI_BAND to exercise seams).
    g = math.gcd(_TRANS_TRI_SUBBAND, h)
    return _trans_tri_banded_impl(m, v, h, g)


@functools.partial(jax.jit, static_argnames=("h", "g"))
def _trans_tri_banded_impl(m: BitMatrix, v: jnp.ndarray, h: int,
                           g: int) -> BitMatrix:
    """Banded trans_tri: all heavy traffic is row-contiguous or a matrix
    product.

    Row r's result applies the swap suffix i > r; rows of a 256-row band
    share every swap at or beyond the band end.  Split per band b
    (rows [bh, bh+h)):

        out[r] = mid[r][G_b]        (band-uniform column permutation)
        mid[r] = in1[r][f_r]        (in-band suffix fold, support <= 2h)

    The in-band folds touch only S_b = {i} u {v[i]} (2h slots), so they
    are applied to a (h, 2h) extract per band; the extract, the
    write-back, and the final G gather all run in the TRANSPOSED packed
    domain, where the index varies per (column, band) — a banded row
    gather, versus the per-element gather of a per-row lane gather.

    The per-row fold itself is decomposed once more over g-row
    sub-bands: fold_j = infold_j o U_s, where U_s (the fold of band
    steps >= (s+1)g) is uniform across sub-band s and infold_j touches
    only the <= 2g slots T_s of the sub-band's own steps.  U_s is
    applied as an exact one-hot bf16 matrix product plus a rank-2g delta
    term (the in-sub-band correction), which replaces a 512-lane per-row
    gather.  Sub-band per-row folds reuse
    _band_suffix_folds on the 2g-slot local swap arrays."""
    from .transpose import transpose
    assert h % g == 0
    ns = h // g
    nrows, ncols = m.nrows, m.ncols
    n = min(ncols, v.shape[0])
    r_rows = min(nrows, n)                  # rows swaps can touch
    Br = max(1, -(-r_rows // h))            # row bands
    Bs = max(Br, -(-n // h))                # step bands
    n_pad = Bs * h
    c_all = jnp.arange(ncols, dtype=jnp.int32)
    v_ext = jnp.concatenate([v[:n].astype(jnp.int32),
                             jnp.arange(n, n_pad, dtype=jnp.int32)])

    # --- slot-space swap arrays: slot j < h is column bh+j; slot h+j is
    # step j's out-of-band target (dummy when trivial or in-band) ---
    base = (jnp.arange(Bs, dtype=jnp.int32) * h)[:, None]
    jj = jnp.arange(h, dtype=jnp.int32)[None, :]
    vb = v_ext.reshape(Bs, h)
    in_band = vb < base + h
    w_slots = jnp.concatenate(
        [jnp.where(in_band, vb - base, h + jj),
         jnp.broadcast_to(jnp.arange(h, 2 * h, dtype=jnp.int32)[None, :],
                          (Bs, h))], axis=1)
    # sb: global column id per slot; ncols marks an unused (dummy) slot
    sb = jnp.concatenate(
        [base + jj, jnp.where(in_band, jnp.int32(ncols), vb)], axis=1)
    sb = jnp.where(sb < ncols, sb, jnp.int32(ncols))

    # --- sub-band local swap arrays over the 2h band-slot space.  Step
    # j = sg+jl targets slot w_slots[j] >= j; "in-sub" targets (< (s+1)g)
    # get their local id, others a reserved dummy-paired slot g+jl.
    # T_s lists the touched band slots (2h marks a dummy). ---
    jl = jnp.arange(g, dtype=jnp.int32)
    send = (jnp.arange(ns, dtype=jnp.int32)[None, :, None] + 1) * g
    wj = w_slots[:, :h].reshape(Bs, ns, g)
    in_sub = wj < send
    wl = jnp.concatenate(
        [jnp.where(in_sub, wj - (send - g), g + jl[None, None, :]),
         jnp.broadcast_to(jnp.arange(g, 2 * g, dtype=jnp.int32),
                          (Bs, ns, g))], axis=2)           # (Bs, ns, 2g)
    tslot = jnp.concatenate(
        [jnp.broadcast_to(send - g + jl[None, None, :], (Bs, ns, g)),
         jnp.where(in_sub, jnp.int32(2 * h), wj)], axis=2)  # (Bs, ns, 2g)

    lf = _band_suffix_folds(wl.reshape(Bs * ns, 2 * g))
    lf_full = lf[:, 0].reshape(Bs, ns, 2 * g)
    lf_rows = lf[:, 1:].reshape(Bs, ns, g, 2 * g)[:Br]      # (Br,ns,g,2g)

    # --- expand full sub-folds to 2h-slot maps and compose the
    # sub-suffix folds U_s (steps >= (s+1)g) and the full band fold ---
    ident = jnp.arange(2 * h, dtype=jnp.int32)
    t_src = jnp.take_along_axis(tslot, lf_full, axis=2)
    bidx = jnp.arange(Bs, dtype=jnp.int32)[:, None, None]
    sidx = jnp.arange(ns, dtype=jnp.int32)[None, :, None]
    F = jnp.broadcast_to(ident[None, None, :], (Bs, ns, 2 * h)).at[
        bidx, sidx, tslot].set(t_src, mode="drop")          # (Bs, ns, 2h)
    u_cur = jnp.broadcast_to(ident[None, :], (Bs, 2 * h))
    u_list = [None] * ns
    for s in range(ns - 1, -1, -1):
        u_list[s] = u_cur                                    # U_s
        u_cur = jnp.take_along_axis(F[:, s], u_cur, axis=1)
    f_full = u_cur                                           # whole band
    U = jnp.stack(u_list, axis=1)                            # (Bs, ns, 2h)

    # --- suffix permutations G_b = fold of steps >= (b+1)h, built from
    # the full folds expanded to column-id maps (Bs cheap 1-D gathers) ---
    src_cols = jnp.take_along_axis(sb, f_full, axis=1)  # content source ids
    g_cur = c_all
    g_list = [None] * Br
    for b in range(Bs - 1, -1, -1):
        if b < Br:
            g_list[b] = g_cur
        f_col = c_all.at[sb[b]].set(src_cols[b], mode="drop")
        g_cur = f_col[g_cur]
    gidx = jnp.stack(g_list, axis=1)         # (ncols, Br)

    # --- transposed packed domain ---
    xt = transpose(m).data                   # (ncols, ceil(nrows/32))
    wr = xt.shape[1]
    wr_band = Br * (h // WORD_BITS)
    if wr_band > wr:
        xt = jnp.pad(xt, ((0, 0), (0, wr_band - wr)))
    xt3 = xt[:, :wr_band].reshape(ncols, Br, h // WORD_BITS)

    # extract E[b, j, q] = in1[bh+j, sb[b, q]] via banded sublane gather
    sbc = jnp.minimum(sb[:Br], ncols - 1)    # (Br, 2h); dummies unused
    e_pk = jnp.take_along_axis(xt3, sbc.T[:, :, None], axis=0)  # (2h,Br,wb)
    shifts = jnp.arange(WORD_BITS, dtype=jnp.uint32)
    e_bits = ((e_pk[:, :, :, None] >> shifts[None, None, None, :]) &
              jnp.uint32(1)).astype(jnp.uint8)
    e_bits = e_bits.reshape(2 * h, Br, h).transpose(1, 2, 0)  # (Br,h,2h)
    e4 = e_bits.reshape(Br, ns, g, 2 * h)

    # --- corrected[j, q] = e[j, fold_j[q]] = (e + delta)[j, U_s[q]]:
    # one-hot U product plus the in-sub-band delta at slots T_s ---
    slot_r = jnp.arange(2 * h, dtype=jnp.int32)
    oh_t = (tslot[:Br, :, None, :] ==
            slot_r[None, None, :, None]).astype(jnp.bfloat16)  # (Br,ns,2h,2g)
    e_t = jnp.einsum("bsjq,bsqt->bsjt", e4.astype(jnp.bfloat16), oh_t,
                     preferred_element_type=jnp.float32).astype(jnp.int8)
    e_tf = jnp.take_along_axis(e_t, lf_rows, axis=3)       # 2g-lane gather
    delta = (e_tf - e_t).astype(jnp.bfloat16)              # (Br, ns, g, 2g)
    oh_u = (U[:Br, :, None, :] ==
            slot_r[None, None, :, None]).astype(jnp.bfloat16)  # (Br,ns,2h,2h)
    oh_d = (U[:Br, :, None, :] ==
            tslot[:Br, :, :, None]).astype(jnp.bfloat16)       # (Br,ns,2g,2h)
    corr = (jnp.einsum("bsjq,bsqp->bsjp", e4.astype(jnp.bfloat16), oh_u,
                       preferred_element_type=jnp.float32) +
            jnp.einsum("bsjt,bstp->bsjp", delta, oh_d,
                       preferred_element_type=jnp.float32))
    corrected = corr.astype(jnp.uint8).reshape(Br, h, 2 * h)

    # pack the corrected columns back to words (rows minor)
    cpk = corrected.transpose(0, 2, 1).reshape(
        Br, 2 * h, h // WORD_BITS, WORD_BITS).astype(jnp.uint32)
    cpk = jnp.sum(cpk << shifts[None, None, None, :], axis=-1,
                  dtype=jnp.uint32)                       # (Br, 2h, wb)

    # write back (banded sublane scatter; dummy slots drop at index ncols)
    mid3 = xt3.at[sb[:Br], jnp.arange(Br, dtype=jnp.int32)[:, None], :] \
        .set(cpk, mode="drop")

    # band-uniform suffix move out3[c, b] = mid3[gidx[c, b], b], run as a
    # per-band co-sort on the inverse index (keys + wb payload words)
    # instead of an index-rate-bound take_along_axis
    invg = jnp.zeros_like(gidx).at[
        gidx, jnp.arange(Br, dtype=jnp.int32)[None, :]].set(
        jnp.broadcast_to(c_all[:, None], gidx.shape))
    sort_ops = (invg,) + tuple(mid3[:, :, i] for i in range(mid3.shape[2]))
    out3 = jnp.stack(jax.lax.sort(sort_ops, dimension=0, num_keys=1)[1:],
                     axis=2)

    out_t = out3.reshape(ncols, wr_band)
    if wr_band < wr:
        out_t = jnp.concatenate([out_t, xt[:, wr_band:]], axis=1)
    else:
        out_t = out_t[:, :wr]
    res = transpose(BitMatrix(out_t, nrows))
    return mask_padding(BitMatrix(res.data, ncols))


# --- path-blend trans_tri: the content-adaptive production fast path ---
# Under the PLE-Q contract the swap steps form DISJOINT INCREASING PATHS
# (each column is the target of at most one step and v[i] > i for live
# steps, so i -> v[i] has in/out-degree <= 1).  Applying the suffix
# steps i > r along a path n1 < n2 < ... < nk rotates content:
#     slot n_t   <- a[n_{t+1}]   for every LIVE STEP n_t > r   (t < k)
#     slot nk    <- a[min node > r]        (the path END column)
#     everything else identity.
# So the whole trans_tri is (1) a column-shift blend out[r, c] =
# in[r, v[c]] masked by (c live & c > r) — pure elementwise passes when
# the displacements v[c]-c are small, which they are for typical inputs
# (displacement <= running corank; a full-rank random matrix has Q ==
# identity) — plus (2) a fix-up of the <= #paths path-end columns from a
# host-precomputed "next node > r" staircase.  Worst cases (large
# displacement / many paths / traced v) fall back to the banded engine.
_PATHBLEND_MAX_D = 32    # max column displacement the blend unrolls
_PATHBLEND_K = 8         # path-end columns fixed per call (padded)


def _pathblend_host(vh: "np.ndarray", nrows: int, ncols: int, W: int):
    """Host-side analysis of a concrete swap array.  Returns None when
    ineligible (contract violation, displacement > max, too many paths),
    "identity" when v is trivial, else the device-ready constants.
    ``ncols`` is the true column count; masks span the padded W words."""
    import numpy as np

    n = min(ncols, len(vh))
    if n == 0:
        return "identity"
    c = np.arange(n, dtype=np.int64)
    vv = vh[:n].astype(np.int64)
    if np.any(vv < c) or np.any(vv >= ncols):
        return None
    live = vv > c
    if not live.any():
        return "identity"
    offs = vv - c
    d = int(offs[live].max())
    if d > _PATHBLEND_MAX_D:
        return None
    steps = c[live]
    tg = vv[live]
    if len(np.unique(tg)) != len(tg):
        return None  # one-target contract violated
    is_step = np.zeros(max(ncols, W * 32), bool)
    is_step[steps] = True
    ends = tg[~is_step[tg]]
    if len(ends) > _PATHBLEND_K:
        return None
    # path end of every node by pointer doubling over i -> v[i]
    f = np.arange(max(ncols, W * 32), dtype=np.int64)
    f[steps] = tg
    for _ in range(max(1, int(np.ceil(np.log2(max(n, 2)))))):
        f = f[f]
    # per-delta packed column masks (delta = 1..d_pow2, zero-padded)
    d_pow = 1
    while d_pow < d:
        d_pow *= 2
    masks = np.zeros((d_pow, W), np.uint32)
    bitw = (np.uint32(1) << np.uint32(np.arange(32)))
    for delta in range(1, d + 1):
        cols = steps[offs[live] == delta]
        bits = np.zeros(W * 32, bool)
        bits[cols] = True
        masks[delta - 1] = (bits.reshape(W, 32) * bitw).sum(
            axis=1, dtype=np.uint32)
    livemask = np.bitwise_or.reduce(masks, axis=0) if d else \
        np.zeros(W, np.uint32)
    # per-path node membership, packed (K, W) — the device builds the
    # "min node > r" staircase from these via one reverse cummin (the
    # packed masks are a few KB where an explicit (nrows, K) index table
    # would be ~1 MB of host-to-device upload)
    nodebits = np.zeros((_PATHBLEND_K, W), np.uint32)
    ends_pad = np.full(_PATHBLEND_K, W * 32, np.int64)
    for p, e in enumerate(ends):
        nodes = steps[f[steps] == e]  # sorted ascending
        bits = np.zeros(W * 32, bool)
        bits[nodes] = True
        nodebits[p] = (bits.reshape(W, 32) * bitw).sum(
            axis=1, dtype=np.uint32)
        ends_pad[p] = e
    return (d_pow, jnp.asarray(masks), jnp.asarray(livemask),
            jnp.asarray(nodebits),
            jnp.asarray(ends_pad.astype(np.int32)))


@functools.partial(jax.jit, static_argnames=("d",))
def _pathblend_impl(data: jnp.ndarray, masks: jnp.ndarray,
                    livemask: jnp.ndarray, nodebits: jnp.ndarray,
                    ends: jnp.ndarray, d: int) -> jnp.ndarray:
    nrows, W = data.shape
    NC = W * 32
    K = nodebits.shape[0]
    ext = jnp.concatenate(
        [data, jnp.zeros((nrows, 1), jnp.uint32)], axis=1)
    # staircase nx[r, p] = min path-p node > r (else the end column),
    # computed at the WORD level: in-word candidates by bit masking +
    # count-trailing-zeros, cross-word via a reverse cummin over only W
    # elements (a cummin over the full NC-long axis is a long serial scan
    # and slow to compile)
    def _ctz32(x):
        # popcount(~x & (x-1)); bit-parallel popcount, all elementwise
        y = (~x) & (x - jnp.uint32(1))
        y = y - ((y >> 1) & jnp.uint32(0x55555555))
        y = (y & jnp.uint32(0x33333333)) + ((y >> 2) & jnp.uint32(0x33333333))
        y = (y + (y >> 4)) & jnp.uint32(0x0F0F0F0F)
        return ((y * jnp.uint32(0x01010101)) >> 24).astype(jnp.int32)

    wa = jnp.arange(W, dtype=jnp.int32)
    nzw = jnp.where(nodebits != 0, wa[None, :], jnp.int32(W))
    sufw = jax.lax.cummin(nzw, axis=1, reverse=True)        # (K, W)
    nextw = jnp.concatenate(
        [sufw[:, 1:], jnp.full((K, 1), W, jnp.int32)], axis=1)
    ctzw = _ctz32(nodebits)                                 # (K, W)
    # cross-word fallback value per word: 32*nextw + ctz(word[nextw])
    ctz_next = jnp.take_along_axis(
        jnp.concatenate([ctzw, jnp.zeros((K, 1), jnp.int32)], axis=1),
        nextw, axis=1)
    cross = jnp.where(nextw < W, nextw * 32 + ctz_next, jnp.int32(NC))
    # per (word, bit) grid: nodes strictly above bit j within the word
    j = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
    above = nodebits[:, :, None] & ~((jnp.uint32(2) << j) - jnp.uint32(1))
    inword = wa[None, :, None] * 32 + _ctz32(above)
    nx_all = jnp.where(above != 0, inword, cross[:, :, None])
    nx_all = jnp.where(nx_all < NC, nx_all,
                       ends[:, None, None]).reshape(K, NC)
    if nrows <= NC:
        nx = nx_all[:, :nrows].T                            # (nrows, K)
    else:
        nx = jnp.concatenate(
            [nx_all, jnp.broadcast_to(ends[:, None], (K, nrows - NC))],
            axis=1).T
    # (1) blend: acc[r] = in[r, c + delta] on the delta-mask columns
    acc = jnp.zeros_like(data)
    for delta in range(1, d + 1):
        if delta == 32:
            # a whole-word move: no shift amount may reach the bit width
            # (out-of-range shifts are undefined on some backends)
            z = ext[:, 1:]
        else:
            z = (ext[:, :-1] >> delta) | (ext[:, 1:] << (32 - delta))
        acc = acc | (z & masks[delta - 1][None, :])
    # triangular row condition c > r, packed per (row, word)
    r = jnp.arange(nrows, dtype=jnp.int32)[:, None]
    wbase = jnp.arange(W, dtype=jnp.int32)[None, :] * 32
    rel = jnp.clip(r + 1 - wbase, 0, 32)  # first kept bit within word
    tri = jnp.where(rel >= 32, jnp.uint32(0),
                    jnp.uint32(0xFFFFFFFF) << rel.astype(jnp.uint32))
    sel = livemask[None, :] & tri
    out = (data & ~sel) | (acc & sel)
    # (2) path-end fix-up: bit r of column e <- in[r, nx[r, p]]
    wsel = jnp.take_along_axis(ext, jnp.minimum(nx // 32, W), axis=1)
    bits = (wsel >> (nx % 32).astype(jnp.uint32)) & jnp.uint32(1)
    eb = (ends % 32).astype(jnp.uint32)
    vals = bits << eb[None, :]                       # (nrows, K)
    onehot = (jnp.arange(W, dtype=jnp.int32)[None, :]
              == (ends // 32)[:, None])              # (K, W)
    clear = jnp.sum(jnp.where(
        onehot, (jnp.uint32(1) << eb)[:, None], jnp.uint32(0)),
        axis=0, dtype=jnp.uint32)                    # distinct bits -> OR
    oh_f = onehot.astype(jnp.float32)
    hi = jnp.einsum("rk,kw->rw", (vals >> 16).astype(jnp.float32), oh_f,
                    precision=jax.lax.Precision.HIGHEST)
    lo = jnp.einsum("rk,kw->rw", (vals & 0xFFFF).astype(jnp.float32), oh_f,
                    precision=jax.lax.Precision.HIGHEST)
    fix = (hi.astype(jnp.uint32) << 16) | lo.astype(jnp.uint32)
    return (out & ~clear[None, :]) | fix


def _try_pathblend(m: BitMatrix, v: jnp.ndarray):
    import numpy as np
    vh = np.asarray(v)
    plan = _pathblend_host(vh, m.nrows, m.ncols, m.data.shape[1])
    if plan is None:
        return None
    if plan == "identity":
        return mask_padding(BitMatrix(m.data, m.ncols))
    d, masks, livemask, nodebits, ends = plan
    out = _pathblend_impl(m.data, masks, livemask, nodebits, ends, d)
    return mask_padding(BitMatrix(out, m.ncols))


def apply_p_right_trans_tri(m: BitMatrix, v: jnp.ndarray) -> BitMatrix:
    """For i ascending: swap columns (i, v[i]) in rows [0, i) only
    (reference: mzd_apply_p_right_trans_tri, mzp.c:279-292).  Moves pivot
    columns onto the diagonal in the triangular region after PLE.

    Assumes the PLE-Q contract (v[i] >= i, at most one real swap targets
    any column); arbitrary swap arrays go through
    apply_p_right_trans_tri_seq.  With a concrete (non-traced) v the
    content-adaptive path-blend engine handles the common small-
    displacement case in a few elementwise passes; otherwise dispatch to
    the banded transposed formulation at production sizes and the
    row-chunked lane-gather model below it (all validated cell-exactly
    against the sequential model)."""
    if not isinstance(v, jax.core.Tracer) and not isinstance(
            m.data, jax.core.Tracer):
        res = _try_pathblend(m, v)
        if res is not None:
            return res
    if min(m.nrows, m.ncols) >= 2 * _TRANS_TRI_BAND:
        return _trans_tri_banded(m, v)
    return _trans_tri_rowchunk(m, v)
