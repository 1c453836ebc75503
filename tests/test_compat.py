"""Reference-API compatibility surface: a program written against the mzd_*
names must run unchanged (modulo functional return values)."""

import numpy as np

import m4ri_jax.compat as m4ri
import m4ri_jax as m4

import oracle
from conftest import random_dense


def test_reference_style_program(rng):
    """The canonical reference usage pattern, straight from its README."""
    m4ri.m4ri_srandom(17)
    A = m4ri.mzd_init(100, 100)
    A = m4ri.mzd_randomize(A)
    B = m4ri.mzd_init(100, 100)
    B = m4ri.mzd_randomize(B)

    C = m4ri.mzd_mul(None, A, B, 0)
    C2 = m4ri.mzd_mul_naive(None, A, B)
    C3 = m4ri.mzd_mul_m4rm(None, A, B, 0)
    assert bool(m4ri.mzd_equal(C, C2)) and bool(m4ri.mzd_equal(C, C3))

    E, r = m4ri.mzd_echelonize(m4ri.mzd_copy(None, A), full=True)
    a_np = m4.to_numpy(A)
    assert int(r) == oracle.rank(a_np)
    np.testing.assert_array_equal(m4.to_numpy(E), oracle.rref(a_np))

    M, P, Q, rr = m4ri.mzd_ple(m4ri.mzd_copy(None, A), None, None, 0)
    assert int(rr) == int(r)

    X, ok = m4ri.mzd_solve_left(A, C, 0, 1)
    assert bool(ok)
    np.testing.assert_array_equal(oracle.mul(a_np, m4.to_numpy(X)),
                                  m4.to_numpy(C))

    inv = m4ri.mzd_inv_m4ri(None, A, 0) if int(r) == 100 else None
    if inv is not None:
        np.testing.assert_array_equal(oracle.mul(a_np, m4.to_numpy(inv)),
                                      np.eye(100, dtype=np.uint8))


def test_compat_bit_ops(rng):
    a = random_dense(rng, 10, 70)
    A = m4.from_numpy(a)
    assert int(m4ri.mzd_read_bit(A, 3, 40)) == a[3, 40]
    B = m4ri.mzd_row_add(A, 0, 5)
    expect = a.copy()
    expect[5] ^= expect[0]
    np.testing.assert_array_equal(m4.to_numpy(B), expect)
    T = m4ri.mzd_transpose(None, A)
    np.testing.assert_array_equal(m4.to_numpy(T), a.T)
    W = m4ri.mzd_init_window(A, 2, 3, 8, 40)
    np.testing.assert_array_equal(m4.to_numpy(W), a[2:8, 3:40])


def test_compat_randomize_matches_reference_stream():
    m4ri.m4ri_srandom(17)
    A = m4ri.mzd_randomize(m4ri.mzd_init(7, 100))
    B = m4.randomize_reference(7, 100, seed=17)
    assert bool(m4.equal(A, B))


def test_compat_trsm(rng):
    n = 64
    u = np.triu(random_dense(rng, n, n), 1) ^ np.eye(n, dtype=np.uint8)
    b = random_dense(rng, n, 32)
    X = m4ri.mzd_trsm_upper_left(m4.from_numpy(u), m4.from_numpy(b), 0)
    np.testing.assert_array_equal(oracle.mul(u, m4.to_numpy(X)), b)


def test_randomize_advances_stream():
    """Successive un-seeded mzd_randomize calls must differ (the reference
    advances its RNG stream on every call)."""
    from m4ri_jax import compat
    a = compat.mzd_init(32, 32)
    m1 = compat.mzd_randomize(a)
    m2 = compat.mzd_randomize(a)
    assert not np.array_equal(m4.to_numpy(m1), m4.to_numpy(m2))


def test_inv_m4ri_raises_on_singular(rng):
    """The reference m4ri_die()s on non-invertible input; we raise."""
    import pytest as _pytest
    from m4ri_jax import compat
    a = np.zeros((16, 16), np.uint8)
    a[0, 0] = 1  # rank 1
    with _pytest.raises(ValueError, match="not invertible"):
        compat.mzd_inv_m4ri(None, m4.from_numpy(a))
    # and a genuinely invertible one still works
    u = np.triu(random_dense(rng, 16, 16), 1)
    np.fill_diagonal(u, 1)
    inv = compat.mzd_inv_m4ri(None, m4.from_numpy(u))
    import oracle
    np.testing.assert_array_equal(
        oracle.mul(u, m4.to_numpy(inv)), np.eye(16, dtype=np.uint8))


def test_compat_umbrella_surface_complete():
    """Every public (non-underscore) function name declared in the
    reference umbrella header's modules must exist in the compat layer —
    the round-1 VERDICT's 'grep of m4ri.h is empty' criterion."""
    import glob
    import re
    hdrs = glob.glob("/root/reference/m4ri/*.h")
    if not hdrs:
        import pytest
        pytest.skip("reference tree not available")
    text = "".join(open(h).read() for h in hdrs)
    names = set(re.findall(r"\b((?:mzd|mzp|m4ri|djb)_[a-z0-9_]+)\s*\(", text))
    missing = sorted(n for n in names if not hasattr(m4ri, n)
                     and not hasattr(m4, n))
    assert not missing, f"compat gaps: {missing}"


def test_compat_make_table_process_rows(rng):
    """mzd_make_table + mzd_process_rows must perform a correct Gray-code
    elimination step: rows reduce to zero in the k pivot columns."""
    k = 4
    a_np = random_dense(rng, 40, 64)
    # make rows 0..k-1 a full-rank basis of the leading k columns
    a_np[:k, :k] = np.eye(k, dtype=np.uint8)
    A = m4.from_numpy(a_np)
    T, L = m4ri.mzd_make_table(A, 0, 0, k)
    out = m4ri.mzd_process_rows(A, k, 40, 0, k, T, L)
    got = m4.to_numpy(out)
    # after processing, every row's leading k bits are zero
    assert (got[k:, :k] == 0).all()
    # and each processed row differs from the original by a span element
    t_np = m4.to_numpy(T)
    for i in (k, 17, 39):
        diff = got[i] ^ a_np[i]
        assert any((diff == t).all() for t in t_np), f"row {i}"


def test_compat_combine_and_rows(rng):
    a_np = random_dense(rng, 8, 70)
    b_np = random_dense(rng, 8, 70)
    A, B = m4.from_numpy(a_np), m4.from_numpy(b_np)
    C = m4ri.mzd_combine(A, 3, 0, A, 1, 0, B, 2, 0)
    want = a_np.copy()
    want[3] = a_np[1] ^ b_np[2]
    np.testing.assert_array_equal(m4.to_numpy(C), want)
    C2 = m4ri.mzd_combine_even_in_place(A, 0, 0, B, 7, 0)
    np.testing.assert_array_equal(m4.to_numpy(C2)[0], a_np[0] ^ b_np[7])
    np.testing.assert_array_equal(m4ri.mzd_row(A, 5),
                                  np.asarray(A.data[5]))


def test_compat_capped_right_perm(rng):
    """Capped column permutation touches only rows >= start_row."""
    import jax.numpy as jnp
    a_np = random_dense(rng, 10, 40)
    A = m4.from_numpy(a_np)
    p = jnp.asarray(np.arange(40, dtype=np.int32))
    p = p.at[3].set(9)  # swap cols 3<->9 (LAPACK style)
    full = m4ri.mzd_apply_p_right(A, p)
    capped = m4ri.mzd_apply_p_right_even_capped(A, p, 6, 0)
    got = m4.to_numpy(capped)
    np.testing.assert_array_equal(got[:6], a_np[:6])
    np.testing.assert_array_equal(got[6:], m4.to_numpy(full)[6:])


def test_compat_djb_builder(rng):
    """A hand-built DJB program via djb_init/push_back applies like the
    compiled one."""
    from m4ri_jax.models.djb import djb_apply
    # replay is in reverse (djb.c:142-153), so later list entries run
    # first: y0 = x1; y1 = x0 ^ y0  (i.e. y1 = x0 ^ x1)
    z = m4ri.djb_init(2, 2)
    z = m4ri.djb_push_back(z, 1, 0, m4ri.source_target)
    z = m4ri.djb_push_back(z, 1, 0, m4ri.source_source)
    z = m4ri.djb_push_back(z, 0, 1, m4ri.source_source)
    v = m4.from_numpy(np.array([[1], [1]], np.uint8))
    y = m4.to_numpy(djb_apply(z, v))
    np.testing.assert_array_equal(y, [[1], [0]])


def test_compat_misc_long_tail():
    assert m4ri.m4ri_gray_code(3, 3) == (3 ^ (3 >> 1))
    assert m4ri.m4ri_radix == 32
    assert m4ri.m4ri_coin_flip() in (0, 1)
    ordv, inc = m4ri.m4ri_build_code(3)
    assert len(ordv) == 8 and len(inc) == 8  # reference allocates 2^k each
    try:
        m4ri.m4ri_die("boom %d", 7)
    except RuntimeError as e:
        assert "boom 7" in str(e)
    else:
        raise AssertionError("m4ri_die must raise")
    assert m4ri.m4ri_init() is None and m4ri.m4ri_fini() is None
    buf = m4ri.m4ri_mm_malloc_aligned(128)
    assert buf.shape == (128,)
    p = m4ri.mzp_init(6)
    w = m4ri.mzp_init_window(p, 2, 5)
    assert list(np.asarray(w)) == [2, 3, 4]
    assert m4ri.mzp_free(p) is None


def test_compat_bit_fields_64(rng):
    """33..64-bit field ops match reference radix-64 semantics
    (mzd.h:892-901): read/xor/and/clear across word-pair boundaries,
    including an unaligned 64-bit field spanning three 32-bit words."""
    a = random_dense(rng, 4, 160)
    A = m4.from_numpy(a)

    def field_of(bits, i, j, n):
        v = 0
        for t in range(n):
            v |= int(bits[i, j + t]) << t
        return v

    for (i, j, n) in [(0, 0, 64), (1, 17, 64), (2, 31, 33),
                      (3, 95, 48), (0, 32, 40), (1, 63, 64)]:
        got = m4ri.mzd_read_bits(A, i, j, n)
        assert int(got) == field_of(a, i, j, n), (i, j, n)

    # xor a 64-bit value at an unaligned offset; verify bitwise
    v = 0xDEADBEEFCAFEF00D
    B = m4ri.mzd_xor_bits(A, 1, 17, 64, v)
    expect = a.copy()
    for t in range(64):
        expect[1, 17 + t] ^= (v >> t) & 1
    np.testing.assert_array_equal(m4.to_numpy(B), expect)

    # and with a mask value
    C = m4ri.mzd_and_bits(A, 2, 31, 40, v)
    expect = a.copy()
    for t in range(40):
        expect[2, 31 + t] &= (v >> t) & 1
    np.testing.assert_array_equal(m4.to_numpy(C), expect)

    # clear an unaligned 64-bit field
    D = m4ri.mzd_clear_bits(A, 3, 33, 64)
    expect = a.copy()
    expect[3, 33:97] = 0
    np.testing.assert_array_equal(m4.to_numpy(D), expect)

    # round-trip: read back what xor wrote into a zero matrix
    Z = m4.from_numpy(np.zeros((2, 128), np.uint8))
    Z = m4ri.mzd_xor_bits(Z, 0, 39, 64, v)
    assert m4ri.mzd_read_bits(Z, 0, 39, 64) == v
