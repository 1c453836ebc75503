"""PLE/PLUQ tests (reference: tests/test_ple.c check_ple + test_pluq.c).

check_ple recipe (test_ple.c:6-43): run PLE, apply Q^T on the triangular
region, read L and E out of the in-place matrix, then verify
P-rowswapped Q^T-colswapped A == L @ E over GF(2)."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.core.permutation import (apply_p_left, apply_p_right_trans,
                                       apply_p_right_trans_tri)
from m4ri_jax.models.ple import ple, pluq

import oracle
from conftest import random_dense


def _check_pluq(a_np):
    m, n = a_np.shape
    A = m4.from_numpy(a_np)
    M, P, Q, r = pluq(A)
    r = int(r)
    Md = m4.to_numpy(M)
    L = np.zeros((m, max(r, 1)), np.uint8)
    for j in range(r):
        L[j + 1 :, j] = Md[j + 1 :, j]
        L[j, j] = 1
    U = np.triu(Md)[:r]
    Acopy = apply_p_left(m4.from_numpy(a_np), P)
    Acopy = apply_p_right_trans(Acopy, Q)
    lhs = m4.to_numpy(Acopy)
    rhs = (L.astype(np.int64) @ U.astype(np.int64)) % 2 if r else np.zeros((m, n))
    np.testing.assert_array_equal(lhs, rhs.astype(np.uint8))
    return Q, r


def check_ple(a_np):
    m, n = a_np.shape
    A = m4.from_numpy(a_np)
    M, P, Q, r = ple(A)
    r = int(r)
    assert r == oracle.rank(a_np), (r, oracle.rank(a_np))
    M2 = apply_p_right_trans_tri(M, Q)
    Md = m4.to_numpy(M2)

    L = np.zeros((m, m), np.uint8)
    E = np.zeros((m, n), np.uint8)
    for i in range(r):
        L[i, :i] = Md[i, :i]
        E[i, i + 1 :] = Md[i, i + 1 :]
        L[i, i] = 1
        E[i, i] = 1
    L[r:m, :r] = Md[r:m, :r]

    Acopy = apply_p_left(m4.from_numpy(a_np), P)
    Acopy = apply_p_right_trans(Acopy, Q)
    lhs = m4.to_numpy(Acopy)
    rhs = (L.astype(np.int64) @ E.astype(np.int64)) % 2
    np.testing.assert_array_equal(lhs, rhs.astype(np.uint8))


SIZES = [(2, 4), (7, 7), (17, 16), (32, 32), (37, 29), (64, 64), (64, 128),
         (97, 65), (128, 128), (129, 257), (200, 77), (256, 256)]


@pytest.mark.parametrize("m,n", SIZES)
def test_ple_random(rng, m, n):
    check_ple(random_dense(rng, m, n))


@pytest.mark.parametrize("m,n", [(64, 64), (128, 100), (100, 128)])
def test_ple_low_rank(rng, m, n):
    k = min(m, n) // 4
    u = random_dense(rng, m, k)
    v = random_dense(rng, k, n)
    check_ple(oracle.mul(u, v).astype(np.uint8))


def test_ple_strings():
    # string cases in the spirit of test_ple.c:142-148
    cases = [
        (2, 4, "1001110100111101"[:8]),
        (4, 4, "1000010000100001"),
        (4, 4, "0000000000000000"),
        (3, 5, "110010101101011"),
    ]
    for m, n, s in cases:
        a = np.array([int(c) for c in s], np.uint8).reshape(m, n)
        check_ple(a)


def test_ple_zero_and_identity():
    check_ple(np.zeros((8, 8), np.uint8))
    check_ple(np.eye(8, dtype=np.uint8))
    check_ple(np.ones((6, 9), np.uint8))


@pytest.mark.parametrize("m,n", [(64, 64), (96, 64), (63, 100)])
def test_pluq_reconstruction(rng, m, n):
    """PLUQ: in-place result is L (strict lower) + U (upper); same
    reconstruction as check_ple since mzd_pluq = ple + tri-apply."""
    _check_pluq(random_dense(rng, m, n))


@pytest.mark.parametrize("m,n", [(48, 40), (40, 40)])
def test_pluq_column_displacement_32(rng, m, n):
    """Columns 0..31 are zero, so pivot i sits at column i + 32: every
    column displacement of Q is exactly one word.  The path-blend
    trans_tri must take its whole-word branch (no shift by 32) and the
    PLUQ reconstruction must hold."""
    from m4ri_jax.core.permutation import (_pathblend_host,
                                           apply_p_right_trans_tri_seq)
    a_np = random_dense(rng, m, n)
    a_np[:, :32] = 0
    Q, r = _check_pluq(a_np)
    q = np.asarray(Q)
    assert r == n - 32 and (q[:r] - np.arange(r) == 32).all(), q[:r]
    W = m4.from_numpy(a_np).data.shape[1]
    plan = _pathblend_host(q, m, n, W)
    assert isinstance(plan, tuple) and plan[0] == 32, plan
    M, _, _, _ = ple(m4.from_numpy(a_np))
    np.testing.assert_array_equal(
        m4.to_numpy(apply_p_right_trans_tri(M, Q)),
        m4.to_numpy(apply_p_right_trans_tri_seq(M, Q)))


def _window_cases(rng):
    """Structured inputs that stress the window pivot hunt: zero top blocks
    (pivots beyond the window -> exact miss fallback), striped sparsity
    (displacement shuffle dynamics), and low rank."""
    z = np.zeros((100, 64), np.uint8)
    dense = random_dense(rng, 60, 64)
    yield "zero-top", np.concatenate([z, dense], axis=0)
    stripes = random_dense(rng, 160, 64)
    stripes[::2] = 0
    yield "stripes", stripes
    k = 20
    lowrank = oracle.mul(random_dense(rng, 150, k),
                         random_dense(rng, k, 96)).astype(np.uint8)
    yield "low-rank", lowrank
    mid = random_dense(rng, 180, 64)
    mid[40:140] = 0
    yield "zero-mid", mid
    yield "random", random_dense(rng, 200, 96)


@pytest.mark.parametrize("preserve_l", [False, True])
def test_window_matches_full_height(rng, preserve_l):
    """The windowed pivot hunt (including its batched below-window
    elimination and the miss fallback) must reproduce the full-height
    sequential engine bit for bit: same in-place data, P, Q, rank."""
    from m4ri_jax.models.ple import _round_up, block_factor
    for name, a_np in _window_cases(rng):
        A = m4.from_numpy(a_np)
        full_w = _round_up(a_np.shape[0], 32)
        got = block_factor(A, preserve_l=preserve_l, nb=32, window=32)
        want = block_factor(A, preserve_l=preserve_l, nb=32, window=full_w)
        for g, w, what in zip(got, want, ["data", "P", "Q", "rank"]):
            np.testing.assert_array_equal(
                np.asarray(g), np.asarray(w), err_msg=f"{name}: {what}")


def test_window_fallback_check_ple(rng):
    """Full PLE reconstruction on inputs that force the miss fallback."""
    for _, a_np in _window_cases(rng):
        check_ple(a_np)


@pytest.mark.parametrize("m,n", [(32, 32), (64, 100), (100, 64), (129, 129)])
def test_compress_l_vectorized_matches_sequential(rng, m, n):
    """The pointer-chase compression must reproduce the reference's
    sequential column-swap semantics bit for bit."""
    from m4ri_jax.models.ple import (_compress_l_impl, _compress_l_seq,
                                     block_factor)
    # low-ish rank inputs exercise chains (Q[j] > j cases)
    k = min(m, n) * 2 // 3
    a = oracle.mul(random_dense(rng, m, k), random_dense(rng, k, n)).astype(
        np.uint8)
    A = m4.from_numpy(a)
    data, p, q, r = block_factor(A, preserve_l=True)
    out_v = np.asarray(_compress_l_impl(data, q, r, m, n))
    out_s = np.asarray(_compress_l_seq(data, q, r, m, n))
    np.testing.assert_array_equal(out_v, out_s)


# --- vectorized permutation layer vs sequential oracles (VERDICT r2 #5) ---

def _random_lapack(rng, n):
    """Random LAPACK swap array: v[i] uniform in [i, n)."""
    return np.array([rng.integers(i, n) for i in range(n)], np.int32)


def _random_ple_q(rng, n, nreal=None):
    """Swap array satisfying the PLE-Q contract: v[i] >= i, real swaps
    (v[i] > i) have DISTINCT targets, everything else identity.  Includes
    multi-hop chains (pivot columns pointing at later pivot rows)."""
    v = np.arange(n, dtype=np.int32)
    steps = rng.permutation(n - 1)[: (nreal or n // 3)]
    used = set()
    for j in sorted(steps):
        cands = [c for c in range(j + 1, n) if c not in used]
        if not cands:
            continue
        c = int(rng.choice(cands))
        v[j] = c
        used.add(c)
    return v


def test_swaps_to_perm_matches_sequential(rng):
    from m4ri_jax.core.permutation import swaps_to_perm, swaps_to_perm_seq
    for n in (1, 2, 7, 33, 64, 130):
        for trial in range(4):
            v = _random_lapack(rng, n)
            for asc in (True, False):
                got = np.asarray(swaps_to_perm(jnp_arr(v), asc))
                want = np.asarray(swaps_to_perm_seq(jnp_arr(v), asc))
                np.testing.assert_array_equal(got, want, err_msg=f"{n} {asc} {v}")
    # adversarial: every step targets the last slot (maximal value chain)
    for n in (5, 40):
        v = np.full((n,), n - 1, np.int32)
        v[n - 1] = n - 1
        for asc in (True, False):
            got = np.asarray(swaps_to_perm(jnp_arr(v), asc))
            want = np.asarray(swaps_to_perm_seq(jnp_arr(v), asc))
            np.testing.assert_array_equal(got, want)


def jnp_arr(v):
    import jax.numpy as jnp
    return jnp.asarray(v, jnp.int32)


def test_apply_p_right_trans_tri_matches_sequential(rng):
    from m4ri_jax.core.permutation import (apply_p_right_trans_tri,
                                           apply_p_right_trans_tri_seq)
    for (m_, n) in ((40, 40), (64, 40), (33, 70), (100, 100)):
        for trial in range(3):
            a = random_dense(rng, m_, n)
            v = _random_ple_q(rng, n)
            A = m4.from_numpy(a)
            got = m4.to_numpy(apply_p_right_trans_tri(A, jnp_arr(v)))
            want = m4.to_numpy(apply_p_right_trans_tri_seq(A, jnp_arr(v)))
            np.testing.assert_array_equal(got, want, err_msg=f"{m_}x{n} {v}")
    # explicit multi-hop chain: v[0]=5, v[5]=9 (pre(9)=5, pre(5)=0)
    a = random_dense(rng, 12, 12)
    v = np.arange(12, dtype=np.int32)
    v[0], v[5] = 5, 9
    A = m4.from_numpy(a)
    got = m4.to_numpy(apply_p_right_trans_tri(A, jnp_arr(v)))
    want = m4.to_numpy(apply_p_right_trans_tri_seq(A, jnp_arr(v)))
    np.testing.assert_array_equal(got, want)
    # swap array shorter than ncols: columns beyond n are target-only
    a = random_dense(rng, 16, 24)
    v = np.arange(10, dtype=np.int32)
    v[2], v[7] = 18, 20
    A = m4.from_numpy(a)
    got = m4.to_numpy(apply_p_right_trans_tri(A, jnp_arr(v)))
    want = m4.to_numpy(apply_p_right_trans_tri_seq(A, jnp_arr(v)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("engine", ["xla", "triton_interpret"])
def test_block_factor_aggregated_bit_identical(rng, engine):
    """The two-level block-aggregated sweep (per-panel updates restricted
    to the block slab + one deep aggregated trailing update per block)
    must be BIT-identical to the flat sweep — same canonical pivots,
    same P/Q, same in-place L/E layout — across block seams, ragged
    blocks, rank deficiency, and non-square shapes."""
    from m4ri_jax.models.ple import _block_factor_impl
    nb = 64
    cases = [(300, 300, False), (200, 520, False), (520, 200, False),
             (300, 300, True)]
    for (m_, n, low_rank) in cases:
        a = random_dense(rng, m_, n)
        if low_rank:
            k = min(m_, n) // 3
            b = random_dense(rng, m_, k)
            c = random_dense(rng, k, n)
            a = (b.astype(np.int64) @ c.astype(np.int64) % 2).astype(np.uint8)
        A = m4.from_numpy(a)
        ref = _block_factor_impl(A.data, m_, n, nb, True, 0, 128,
                                 engine, 1)
        for agg in (2, 3):
            got = _block_factor_impl(A.data, m_, n, nb, True, 0, 128,
                                     engine, agg)
            for name, x, y in zip("dPQr", ref, got):
                np.testing.assert_array_equal(
                    np.asarray(x), np.asarray(y),
                    err_msg=f"{m_}x{n} lr={low_rank} agg={agg} {name}")


def test_apply_p_right_trans_tri_banded(rng, monkeypatch):
    """The banded transposed formulation (production path for large n)
    must agree cell-exactly with the sequential oracle across band
    seams: in-band chains, cross-band chains, out-of-band targets,
    non-square shapes, and a short swap array."""
    from m4ri_jax.core import permutation as perm
    monkeypatch.setattr(perm, "_TRANS_TRI_BAND", 32)  # multi-band at test n
    # ns=4 sub-bands per band: exercises the U_s composition loop,
    # cross-sub-band targets, and the seam delta correction (ADVICE r4).
    monkeypatch.setattr(perm, "_TRANS_TRI_SUBBAND", 8)
    cases = [(40, 40), (64, 40), (33, 70), (100, 100), (96, 200),
             (200, 96), (130, 130)]
    for (m_, n) in cases:
        a = random_dense(rng, m_, n)
        v = _random_ple_q(rng, n)
        A = m4.from_numpy(a)
        got = m4.to_numpy(perm._trans_tri_banded(A, jnp_arr(v)))
        want = m4.to_numpy(perm.apply_p_right_trans_tri_seq(A, jnp_arr(v)))
        np.testing.assert_array_equal(got, want, err_msg=f"{m_}x{n}")
    # short v: columns beyond len(v) are target-only
    a = random_dense(rng, 16, 24)
    v = np.arange(10, dtype=np.int32)
    v[2], v[7] = 18, 20
    A = m4.from_numpy(a)
    got = m4.to_numpy(perm._trans_tri_banded(A, jnp_arr(v)))
    want = m4.to_numpy(perm.apply_p_right_trans_tri_seq(A, jnp_arr(v)))
    np.testing.assert_array_equal(got, want)


def test_apply_p_right_trans_tri_dispatch(rng, monkeypatch):
    """The public op picks the banded path at production sizes and the
    row-chunked path below; both must match the oracle at the seam."""
    from m4ri_jax.core import permutation as perm
    monkeypatch.setattr(perm, "_TRANS_TRI_BAND", 32)
    monkeypatch.setattr(perm, "_TRANS_TRI_SUBBAND", 8)  # multi-sub-band
    for m_, n in ((64, 64), (63, 70)):  # just at / below the 2-band gate
        a = random_dense(rng, m_, n)
        v = _random_ple_q(rng, n)
        A = m4.from_numpy(a)
        got = m4.to_numpy(perm.apply_p_right_trans_tri(A, jnp_arr(v)))
        want = m4.to_numpy(perm.apply_p_right_trans_tri_seq(A, jnp_arr(v)))
        np.testing.assert_array_equal(got, want, err_msg=f"{m_}x{n}")


def test_apply_p_right_trans_tri_chunked(rng, monkeypatch):
    """The row-chunked cummin (memory bound for big-n pluq) must agree
    with the sequential oracle across chunk boundaries and carry."""
    from m4ri_jax.core import permutation as perm
    monkeypatch.setattr(perm, "_TRANS_TRI_CHUNK_ELEMS", 64 * 40)  # 64 rows
    a = random_dense(rng, 530, 40)
    v = np.arange(40, dtype=np.int32)
    v[0], v[5], v[12], v[20] = 5, 9, 30, 25  # chains + plain swaps
    A = m4.from_numpy(a)
    got = m4.to_numpy(perm.apply_p_right_trans_tri(A, jnp_arr(v)))
    want = m4.to_numpy(perm.apply_p_right_trans_tri_seq(A, jnp_arr(v)))
    np.testing.assert_array_equal(got, want)


def test_trans_tri_pathblend(rng):
    """The content-adaptive path-blend engine (production fast path for
    concrete PLE-Q arrays) must agree cell-exactly with the sequential
    oracle: chains, multiple paths, non-square shapes, short v, identity,
    and boundary displacements; ineligible inputs must return None."""
    from m4ri_jax.core import permutation as perm

    def check(m_, n, v, expect_blend=True):
        a = random_dense(rng, m_, n)
        A = m4.from_numpy(a)
        res = perm._try_pathblend(A, jnp_arr(np.asarray(v, np.int32)))
        if not expect_blend:
            assert res is None, (m_, n)
            return
        assert res is not None, (m_, n)
        want = m4.to_numpy(perm.apply_p_right_trans_tri_seq(
            A, jnp_arr(np.asarray(v, np.int32))))
        np.testing.assert_array_equal(m4.to_numpy(res), want,
                                      err_msg=f"{m_}x{n} v={list(v)[:12]}")

    # identity
    check(40, 40, np.arange(40))
    # one long chain 0->1->...->k (displacement 1)
    v = np.arange(64)
    v[:20] = np.arange(1, 21)
    check(64, 64, v)
    # random PLE-Q arrays (mixed chains), various shapes incl. short v;
    # few real swaps so the path count stays under _PATHBLEND_K (the
    # many-path fallback is asserted separately below)
    blended = 0
    for m_, n in ((40, 40), (64, 40), (33, 70), (100, 100), (96, 200),
                  (200, 96), (130, 130), (16, 24)):
        for _ in range(4):
            v = _random_ple_q(rng, min(n, 64), nreal=5)
            disp = (v - np.arange(len(v)))[v > np.arange(len(v))].max(
                initial=0)
            if disp <= perm._PATHBLEND_MAX_D:
                a = random_dense(rng, m_, n)
                A = m4.from_numpy(a)
                res = perm._try_pathblend(A, jnp_arr(v))
                if res is not None:  # may fall back on path count
                    blended += 1
                    want = m4.to_numpy(perm.apply_p_right_trans_tri_seq(
                        A, jnp_arr(v)))
                    np.testing.assert_array_equal(
                        m4.to_numpy(res), want, err_msg=f"{m_}x{n}")
    assert blended >= 10, blended
    # boundary displacement: exactly MAX_D blends, MAX_D+1 falls back
    n = 2 * perm._PATHBLEND_MAX_D + 8
    v = np.arange(n)
    v[0] = perm._PATHBLEND_MAX_D
    check(n, n, v)
    v = np.arange(n)
    v[0] = perm._PATHBLEND_MAX_D + 1
    check(n, n, v, expect_blend=False)
    # too many paths falls back
    v = np.arange(64)
    for j in range(perm._PATHBLEND_K + 1):
        v[2 * j] = 2 * j + 1  # K+1 disjoint length-1 paths
    check(64, 64, v, expect_blend=False)
    # contract violations fall back
    v = np.arange(32)
    v[5] = 3  # v < i
    check(32, 32, v, expect_blend=False)
    v = np.arange(32)
    v[1] = 9
    v[2] = 9  # duplicate target
    check(32, 32, v, expect_blend=False)


def test_trans_tri_dispatch_uses_pathblend(rng, monkeypatch):
    """apply_p_right_trans_tri with a concrete eligible v must take the
    path-blend engine (and still match the oracle)."""
    from m4ri_jax.core import permutation as perm
    called = {}
    orig = perm._try_pathblend

    def spy(m_, v_):
        res = orig(m_, v_)
        called["blend"] = res is not None
        return res

    monkeypatch.setattr(perm, "_try_pathblend", spy)
    a = random_dense(rng, 100, 80)
    v = _random_ple_q(rng, 60)
    A = m4.from_numpy(a)
    got = m4.to_numpy(perm.apply_p_right_trans_tri(A, jnp_arr(v)))
    want = m4.to_numpy(perm.apply_p_right_trans_tri_seq(A, jnp_arr(v)))
    np.testing.assert_array_equal(got, want)
    assert "blend" in called
