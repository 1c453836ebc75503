"""Misc API parity tests (reference: tests/test_misc.c — bit-field ops,
extract_u/extract_l, submatrix; plus set_ui/find_pivot/row_add_offset)."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.core import bitops

from conftest import random_dense


def test_read_bits(rng):
    a = random_dense(rng, 4, 100)
    A = m4.from_numpy(a)
    for (i, j, k) in [(0, 0, 5), (1, 30, 8), (2, 31, 32), (3, 60, 13),
                      (0, 95, 5)]:
        expect = 0
        for t in range(k):
            expect |= int(a[i, j + t]) << t
        assert int(bitops.read_bits(A, i, j, k)) == expect


def test_xor_and_clear_bits(rng):
    a = random_dense(rng, 3, 70)
    A = m4.from_numpy(a)
    B = bitops.xor_bits(A, 1, 28, 8, 0xFF)
    expect = a.copy()
    expect[1, 28:36] ^= 1
    np.testing.assert_array_equal(m4.to_numpy(B), expect)
    C = bitops.clear_bits(A, 0, 60, 10)
    expect = a.copy()
    expect[0, 60:70] = 0
    np.testing.assert_array_equal(m4.to_numpy(C), expect)
    D = bitops.and_bits(A, 2, 30, 4, 0b0101)
    expect = a.copy()
    expect[2, 30:34] &= np.array([1, 0, 1, 0], np.uint8)
    np.testing.assert_array_equal(m4.to_numpy(D), expect)


def test_row_add_offset(rng):
    a = random_dense(rng, 5, 100)
    A = m4.from_numpy(a)
    B = bitops.row_add_offset(A, 2, 4, 37)
    expect = a.copy()
    expect[2, 37:] ^= expect[4, 37:]
    np.testing.assert_array_equal(m4.to_numpy(B), expect)
    C = bitops.row_add(A, 0, 3)
    expect = a.copy()
    expect[3] ^= expect[0]
    np.testing.assert_array_equal(m4.to_numpy(C), expect)


@pytest.mark.parametrize("m,n", [(10, 10), (7, 12), (12, 7), (64, 64),
                                 (70, 33)])
def test_extract_u_l(rng, m, n):
    a = random_dense(rng, m, n)
    A = m4.from_numpy(a)
    k = min(m, n)
    np.testing.assert_array_equal(m4.to_numpy(bitops.extract_u(A)),
                                  np.triu(a[:k, :k]))
    np.testing.assert_array_equal(m4.to_numpy(bitops.extract_l(A)),
                                  np.tril(a[:k, :k]))


def test_find_pivot():
    a = np.zeros((6, 40), np.uint8)
    a[3, 17] = 1
    a[5, 2] = 1
    A = m4.from_numpy(a)
    found, i, j = bitops.find_pivot(A, 0, 0)
    assert bool(found) and (int(i), int(j)) == (5, 2)
    found, i, j = bitops.find_pivot(A, 0, 3)
    assert bool(found) and (int(i), int(j)) == (3, 17)
    found, _, _ = bitops.find_pivot(A, 4, 18)
    assert not bool(found)


def test_set_ui(rng):
    a = random_dense(rng, 5, 9)
    I = bitops.set_ui(m4.from_numpy(a), 1)
    np.testing.assert_array_equal(m4.to_numpy(I), np.eye(5, 9, dtype=np.uint8))
    Z = bitops.set_ui(m4.from_numpy(a), 0)
    assert not m4.to_numpy(Z).any()


def test_word_bit_utils():
    """reference: test_misc.c spread/shrink bits round trips."""
    from m4ri_jax.utils.bits import (lesser_lsb, parity64, shrink_bits,
                                     spread_bits, swap_bits)
    rng = np.random.default_rng(17)
    assert swap_bits(1, 32) == 1 << 31
    assert swap_bits(swap_bits(0xDEADBEEF, 32), 32) == 0xDEADBEEF
    for _ in range(20):
        length = int(rng.integers(1, 16))
        q = np.sort(rng.choice(32, size=length, replace=False))
        # q must satisfy q[i] >= i for spread to shift left
        q = np.maximum(q, np.arange(length))
        v = int(rng.integers(0, 1 << length))
        s = spread_bits(v, q, length)
        assert shrink_bits(s, q, length) == v
    assert lesser_lsb(0b100, 0b1000) and not lesser_lsb(0b1000, 0b100)
    assert not lesser_lsb(0, 5) and lesser_lsb(5, 0)
    buf = np.array([3, 1, 7], dtype=np.uint64)
    assert parity64(buf) == 0b110  # popcounts 2,1,3 -> parities 0,1,1


def test_new_row_apis(rng):
    a = random_dense(rng, 8, 70)
    A = m4.from_numpy(a)
    B = bitops.copy_row(A, 2, A, 5)
    expect = a.copy(); expect[2] = expect[5]
    np.testing.assert_array_equal(m4.to_numpy(B), expect)
    C = bitops.row_clear_offset(A, 3, 33)
    expect = a.copy(); expect[3, 33:] = 0
    np.testing.assert_array_equal(m4.to_numpy(C), expect)
    D = bitops.row_combine(A, 0, [1, 4, 6])
    expect = a.copy(); expect[0] = expect[1] ^ expect[4] ^ expect[6]
    np.testing.assert_array_equal(m4.to_numpy(D), expect)
    assert int(bitops.cmp(A, A)) == 0
    b2 = a.copy(); b2[0, 0] ^= 1
    assert int(bitops.cmp(A, m4.from_numpy(b2))) != 0
    z = np.zeros((6, 10), np.uint8); z[:4] = random_dense(rng, 4, 10) | np.eye(4, 10, dtype=np.uint8).astype(np.uint8)
    assert int(bitops.first_zero_row(m4.from_numpy(z))) <= 4


def test_echelonize_naive_and_gauss_delayed(rng):
    from m4ri_jax.models.echelon import echelonize_naive, gauss_delayed
    import oracle
    a = random_dense(rng, 60, 90)
    R, r = echelonize_naive(m4.from_numpy(a), full=True)
    np.testing.assert_array_equal(m4.to_numpy(R), oracle.rref(a))
    assert int(r) == oracle.rank(a)
    # gauss_delayed from column 20: ranks of the right part
    R2, r2 = gauss_delayed(m4.from_numpy(a), start_col=20)
    assert int(r2) == oracle.rank(a[:, 20:])


def test_pluq_solve_left(rng):
    from m4ri_jax.models.ple import pluq
    from m4ri_jax.models.solve import pluq_solve_left
    import oracle
    a = random_dense(rng, 64, 64)
    x0 = random_dense(rng, 64, 10)
    b = oracle.mul(a, x0).astype(np.uint8)
    M, P, Q, r = pluq(m4.from_numpy(a))
    X, ok = pluq_solve_left(M, P, Q, r, m4.from_numpy(b))
    assert bool(ok)
    np.testing.assert_array_equal(oracle.mul(a, m4.to_numpy(X)), b)


def test_cmp_word_order(rng):
    """mzd_cmp semantics (mzd.c:1333-1361): within a row the high-index
    word is most significant, so rows differing in more than one word must
    take their sign from the *highest* differing column block."""
    from m4ri_jax.core.bitops import cmp

    def ref_cmp(a, b):
        # reference model: per row, compare 64-bit words high-index first
        for i in range(a.shape[0]):
            for j in range(a.shape[1] - 1, -1, -1):
                if a[i, j] != b[i, j]:
                    return -1 if a[i, j] < b[i, j] else 1
        return 0

    n = 130  # > 2 x 64-bit words per row
    for _ in range(50):
        a = random_dense(rng, 3, n)
        b = a.copy()
        # flip a couple of random bits so both words of a pair can differ
        for _ in range(rng.integers(1, 4)):
            b[rng.integers(3), rng.integers(n)] ^= 1
        A, B = m4.from_numpy(a), m4.from_numpy(b)
        # pack into 64-bit words for the reference model
        def pack64(x):
            bits = np.packbits(x, axis=1, bitorder="little")
            pad = (-bits.shape[1]) % 8
            bits = np.pad(bits, ((0, 0), (0, pad)))
            return bits.view(np.uint64)
        assert int(cmp(A, B)) == ref_cmp(pack64(a), pack64(b))
        assert int(cmp(B, A)) == ref_cmp(pack64(b), pack64(a))
        assert int(cmp(A, A)) == 0


def test_config_is_device_derived(monkeypatch):
    """get_config() must actually inspect the backend, and honor
    M4RI_JAX_* environment overrides."""
    from m4ri_jax.utils import config as C
    C.get_config.cache_clear()
    cfg = C.get_config()
    # tests run on CPU: the derived config must say so
    assert cfg.derived_from == "cpu"
    # env override wins
    monkeypatch.setenv("M4RI_JAX_PANEL_WIDTH", "128")
    monkeypatch.setenv("M4RI_JAX_ECHELON_DENSITY_CROSSOVER", "0.25")
    C.get_config.cache_clear()
    cfg2 = C.get_config()
    assert cfg2.panel_width == 128 and cfg2.echelon_density_crossover == 0.25
    monkeypatch.delenv("M4RI_JAX_PANEL_WIDTH")
    monkeypatch.delenv("M4RI_JAX_ECHELON_DENSITY_CROSSOVER")
    C.get_config.cache_clear()


class _FakeGpu:
    platform = "gpu"

    def __init__(self, kind, limit):
        self.device_kind = kind
        self._limit = limit

    def memory_stats(self):
        return {"bytes_limit": self._limit}


@pytest.mark.parametrize("gib,blk", [(60, 16384), (12, 8192), (2, 4096)])
def test_gpu_config_derivation(monkeypatch, gib, blk):
    """The GPU branch derives its product blocks and Strassen cutoff from
    the device's memory budget (an 80 GB card gives JAX ~60 GiB) and keeps
    the pivot kernel's window within one block."""
    import jax
    from m4ri_jax.ops.gpu_panel import MAX_ROWS
    from m4ri_jax.utils import config as C
    dev = _FakeGpu("NVIDIA H100 80GB HBM3", gib * 1024**3)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    cfg = C._derive()
    assert cfg.derived_from == "gpu:NVIDIA H100 80GB HBM3"
    assert cfg.mul_block_m == cfg.mul_block_k == cfg.mul_block_threshold \
        == blk
    assert cfg.strassen_cutoff == blk // 2
    # int32 block of the plain product within 1/16 of the budget
    assert blk * blk * 4 * 16 <= gib * 1024**3
    nb, W = cfg.panel_width, cfg.panel_window
    hp = 1 << (W - 1).bit_length()
    assert W >= nb and hp <= MAX_ROWS
    assert hp * 2 * (nb // 32) <= MAX_ROWS * 32


def test_invert_naive_cross_check(rng):
    """Independent naive-Gauss inversion engine vs the factorization-based
    invert (reference discipline: test_invert.c cross-checks engines)."""
    from m4ri_jax.models.echelon import invert, invert_naive
    u = np.triu(random_dense(rng, 40, 40), 1)
    np.fill_diagonal(u, 1)
    a = (u ^ np.tril(random_dense(rng, 40, 40), -1))  # invertible-ish? no:
    # build a guaranteed invertible matrix: product of unit upper and lower
    l = np.tril(random_dense(rng, 40, 40), -1)
    np.fill_diagonal(l, 1)
    import oracle
    a = oracle.mul(l, u).astype(np.uint8)
    A = m4.from_numpy(a)
    inv1, ok = invert_naive(A)
    inv2, r = invert(A)
    assert bool(ok) and int(r) == 40
    np.testing.assert_array_equal(m4.to_numpy(inv1), m4.to_numpy(inv2))
    np.testing.assert_array_equal(
        oracle.mul(a, m4.to_numpy(inv1)), np.eye(40, dtype=np.int64) % 2)
    # singular input: ok must be False (reference returns NULL)
    s = np.zeros((8, 8), np.uint8)
    s[0, 0] = 1
    _, ok2 = invert_naive(m4.from_numpy(s))
    assert not bool(ok2)


def test_mul_va(rng):
    """Vector-matrix product (reference: mzd_mul_va, mzd.c:1256-1268)."""
    from m4ri_jax import compat
    import oracle
    v = random_dense(rng, 1, 64)
    a = random_dense(rng, 64, 90)
    out = compat.mzd_mul_va(None, m4.from_numpy(v), m4.from_numpy(a))
    np.testing.assert_array_equal(m4.to_numpy(out), oracle.mul(v, a))


def test_debug_dump_stream(rng, capsys):
    """debug_dump(True) must emit an op-hash line per public call, and the
    stream must be deterministic (the engine-diffing property of the
    reference's --enable-debug-dump)."""
    from m4ri_jax.utils.hashing import debug_dump
    a = random_dense(rng, 32, 32)
    b = random_dense(rng, 32, 32)
    A, B = m4.from_numpy(a), m4.from_numpy(b)

    def run():
        m4.mul(A, B)
        m4.transpose(A)
        m4.echelonize(A)
        return capsys.readouterr().out

    debug_dump(True)
    try:
        out1 = run()
        out2 = run()
    finally:
        debug_dump(False)
    assert "mzd_mul:" in out1 and "mzd_transpose:" in out1
    assert "mzd_echelonize" in out1
    assert out1 == out2  # deterministic op-hash stream
    assert capsys.readouterr().out == ""  # silent when disabled
    m4.mul(A, B)
    assert capsys.readouterr().out == ""
