"""RNG contract tests (reference: tests/test_random.c — fixes the
mzd_randomize stream under srandom(17): row-major, one 64-bit word per word,
masked last word)."""

import numpy as np

import m4ri_jax as m4
from m4ri_jax.utils.rng import GlibcRandom

# Generated by glibc: srandom(17); random() x 10  (see tests for provenance).
GLIBC_SEED17 = [1227918265, 3978157, 263514239, 1969574147, 1833982879,
                488658959, 231688945, 1043863911, 1421669753, 1942003127]


def test_glibc_stream_bit_exact():
    g = GlibcRandom(17)
    assert [g.random() for _ in range(10)] == GLIBC_SEED17


def test_random_word_composition():
    g = GlibcRandom(17)
    a0, a1, a2 = GLIBC_SEED17[:3]
    expect = (a0 ^ (a1 << 24) ^ (a2 << 48)) & 0xFFFFFFFFFFFFFFFF
    assert g.random_word() == expect


def test_randomize_reference_reproducible():
    A = m4.randomize_reference(10, 100, seed=17)
    B = m4.randomize_reference(10, 100, seed=17)
    assert bool(m4.equal(A, B))
    C = m4.randomize_reference(10, 100, seed=18)
    assert not bool(m4.equal(A, C))


def test_randomize_reference_masking():
    """Last 64-bit word of each row is masked to ncols (mzd.c:1270-1280)."""
    A = m4.randomize_reference(8, 70, seed=17)
    dense = m4.to_numpy(A)
    assert dense.shape == (8, 70)
    # padding words in our packing must be zero beyond ncols
    from m4ri_jax.core.bitmatrix import padding_mask
    mask = padding_mask(70)
    assert np.all((np.asarray(A.data) & ~mask[None, :]) == 0)
    # stream consumption: a 70-col row consumes 2 x 64-bit words; row 1
    # must differ from a fresh seed-17 fill of a 2-word row (i.e. the
    # generator advanced) while row 0 matches it.
    B = m4.randomize_reference(1, 70, seed=17)
    np.testing.assert_array_equal(np.asarray(A.data)[0], np.asarray(B.data)[0])


def test_randomize_jax():
    import jax
    A = m4.randomize(50, 77, jax.random.PRNGKey(0))
    B = m4.randomize(50, 77, jax.random.PRNGKey(0))
    assert bool(m4.equal(A, B))
    d = float(m4.density(A))
    assert 0.3 < d < 0.7
