"""Coverage for the GPU kernels (ops/gpu_mul.py, ops/gpu_panel.py).

On the CPU both kernels run under the Pallas interpreter
(``interpret=True``) against the plain references: the popcount oracle
(tests/oracle.py) for the product, the XLA ``fori_loop`` for the pivot
loop.  The tests marked ``gpu`` compile the kernels for the card and skip
elsewhere (``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import m4ri_jax as m4
from m4ri_jax.ops.gpu_mul import gf2_mul_triton

import oracle
from conftest import random_dense


def _mul_case(rng, m, k, n, interpret=True, tile=None):
    a = random_dense(rng, m, k)
    b = random_dense(rng, k, n)
    A, B = m4.from_numpy(a), m4.from_numpy(b)
    kw = {} if tile is None else {"tile": tile}
    out = gf2_mul_triton(A.data, B.data, interpret=interpret, **kw)
    np.testing.assert_array_equal(m4.to_numpy(m4.BitMatrix(out, n)),
                                  oracle.mul(a, b), err_msg=f"{m}x{k}x{n}")


@pytest.mark.parametrize("m,k,n", [
    (128, 64, 128),      # one tile, one contraction step
    (256, 512, 256),     # shallow k: the Schur-update shape class
    (128, 2048, 128),    # deep k: many contraction steps
    (300, 150, 200),     # ragged m, k and n (tile padding)
    (129, 33, 97),       # one past every tile edge
    (256, 160, 4096),    # kw = 5 words: odd word count
    (64, 4000, 96),      # deep and ragged k
])
def test_product_kernel_interpret(rng, m, k, n):
    _mul_case(rng, m, k, n)


@pytest.mark.parametrize("tile", [(64, 2, 2, 4), (128, 8, 4, 4)])
def test_product_kernel_other_tiles_interpret(rng, tile):
    _mul_case(rng, 256, 300, 640, tile=tile)


def _schur_case(rng, m, k, n, r0, c0, interpret=True):
    """c ^ lp@up with lp rows < r0 and up columns < c0 zero (the panel
    factorization's contract): exact for every tile-boundary alignment,
    including tiles skipped outright."""
    c = random_dense(rng, m, n)
    lp = random_dense(rng, m, k)
    up = random_dense(rng, k, n)
    lp[:r0] = 0
    up[:, :c0] = 0
    C, L, U = m4.from_numpy(c), m4.from_numpy(lp), m4.from_numpy(up)
    out = gf2_mul_triton(L.data, U.data, C.data, r0, c0 // 32,
                         interpret=interpret)
    np.testing.assert_array_equal(
        m4.to_numpy(m4.BitMatrix(out, n)), c ^ oracle.mul(lp, up),
        err_msg=f"m={m} k={k} n={n} r0={r0} c0={c0}")


@pytest.mark.parametrize("r0,c0", [
    (0, 0),          # nothing skipped
    (128, 256),      # tile-aligned skip region
    (100, 160),      # bounds inside a tile (partial tiles stay active)
    (384, 1024),     # everything skipped: C passes through
    (37, 32 * 5),    # unaligned row bound, word bound inside a tile
])
def test_product_kernel_accumulate_bounds_interpret(rng, r0, c0):
    _schur_case(rng, 384, 64, 1024, r0, c0)


def test_product_kernel_accumulate_ragged_interpret(rng):
    # padded C rows/words must not leak into the result
    _schur_case(rng, 200, 96, 300, 50, 64)


def test_product_kernel_bounds_ignored_without_c(rng):
    """Bounds only mean something with a C to keep: a plain product
    computes every tile."""
    a = random_dense(rng, 256, 64)
    b = random_dense(rng, 64, 256)
    A, B = m4.from_numpy(a), m4.from_numpy(b)
    out = gf2_mul_triton(A.data, B.data, None, 200, 5, interpret=True)
    np.testing.assert_array_equal(m4.to_numpy(m4.BitMatrix(out, 256)),
                                  oracle.mul(a, b))


# ---------------------------------------------------------------- pivot loop

def _pivot_case(win_np, nb, preserve_l, search_window=0, r=0, m=None,
                interpret=True):
    from m4ri_jax.models.ple import run_panel_loop
    W = win_np.shape[0]
    win = m4.from_numpy(win_np).data
    m = W + 5 if m is None else m
    args = (win, jnp.int32(r), jnp.int32(0), jnp.int32(0), jnp.int32(r), m,
            nb, preserve_l, search_window)
    want = run_panel_loop(*args, "xla")
    got = run_panel_loop(*args, "triton_interpret" if interpret
                         else "triton")
    for g, w, what in zip(got, want, ["AL", "rowperm", "r", "touched",
                                     "P", "Q"]):
        np.testing.assert_array_equal(
            np.asarray(g), np.asarray(w),
            err_msg=f"{what}: W={W} nb={nb} preserve_l={preserve_l} "
                    f"sw={search_window}")


@pytest.mark.parametrize("nb,W", [(32, 32), (32, 48), (64, 100), (128, 160),
                                  (96, 120), (224, 230)])
@pytest.mark.parametrize("preserve_l", [False, True])
def test_pivot_kernel_matches_xla_loop(rng, nb, W, preserve_l):
    _pivot_case(random_dense(rng, W, nb), nb, preserve_l)


@pytest.mark.parametrize("preserve_l", [False, True])
def test_pivot_kernel_rank_deficient_window(rng, preserve_l):
    """Repeated rows and zero columns: columns without a pivot, rank < nb,
    and rows past the valid count m that must never pivot."""
    nb, W = 64, 96
    win = random_dense(rng, W, nb)
    win[20:60] = win[0:40]
    win[:, 10:14] = 0
    _pivot_case(win, nb, preserve_l, m=80)


@pytest.mark.parametrize("search_window", [8, 32])
def test_pivot_kernel_search_window(rng, search_window):
    nb = 32
    win = random_dense(rng, nb + search_window, nb)
    win[:12] = 0
    _pivot_case(win, nb, False, search_window=search_window)


def test_pivot_kernel_nonzero_start_rank(rng):
    """A window whose rank counter starts above zero (a later panel)."""
    _pivot_case(random_dense(rng, 64, 32), 32, True, r=3)


def test_block_factor_triton_engine_matches_xla(rng):
    """block_factor through both kernels (interpreted) is bit-identical to
    the XLA engine — data, P, Q and rank — including the below-window
    batch elimination and the full-height miss fallback."""
    from m4ri_jax.models.ple import block_factor
    z = random_dense(rng, 160, 96)
    z[10:90] = 0  # forces the miss fallback at W=32
    A = m4.from_numpy(z)
    for pres in (False, True):
        want = block_factor(A, preserve_l=pres, nb=32, window=32,
                            engine="xla")
        got = block_factor(A, preserve_l=pres, nb=32, window=32,
                           engine="triton_interpret")
        for g, w, what in zip(got, want, ["data", "P", "Q", "rank"]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=f"{pres}: {what}")


def test_block_factor_triton_engine_search_window(rng):
    from m4ri_jax.models.ple import block_factor
    a = random_dense(rng, 400, 256)
    a[50:150] = 0
    A = m4.from_numpy(a)
    want = block_factor(A, preserve_l=False, nb=128, window=256,
                        search_window=128, engine="xla")
    got = block_factor(A, preserve_l=False, nb=128, window=256,
                       search_window=128, engine="triton_interpret")
    for g, w, what in zip(got, want, ["data", "P", "Q", "rank"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=what)


def test_block_factor_triton_engine_wide(rng):
    """Several panels and several Schur column tiles, rank-deficient."""
    from m4ri_jax.models.ple import block_factor
    a = random_dense(rng, 320, 2048)
    a[100:200] = 0
    A = m4.from_numpy(a)
    want = block_factor(A, preserve_l=True, engine="xla")
    got = block_factor(A, preserve_l=True, engine="triton_interpret")
    for g, w, what in zip(got, want, ["data", "P", "Q", "rank"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=what)


def test_panel_loop_window_cap():
    """The kernel's register window is capped; taller windows (the
    full-height miss fallback) stay on the XLA loop."""
    from m4ri_jax.ops.gpu_panel import MAX_ROWS, panel_loop
    al = jnp.zeros((MAX_ROWS + 1, 2), jnp.uint32)
    with pytest.raises(ValueError):
        panel_loop(al, 0, 0, 1, nb=32, preserve_l=True, interpret=True)


# ------------------------------------------------------------ on the card

@pytest.mark.gpu
@pytest.mark.parametrize("m,k,n", [(512, 2048, 4096), (300, 150, 200),
                                   (1024, 512, 1024)])
def test_product_kernel_on_gpu(gpu, rng, m, k, n):
    _mul_case(rng, m, k, n, interpret=False)


@pytest.mark.gpu
def test_product_kernel_accumulate_on_gpu(gpu, rng):
    np_rng = np.random.default_rng(3)
    c = random_dense(np_rng, 1024, 2048)
    lp = random_dense(np_rng, 1024, 512)
    up = random_dense(np_rng, 512, 2048)
    lp[:300] = 0
    up[:, :640] = 0
    C, L, U = m4.from_numpy(c), m4.from_numpy(lp), m4.from_numpy(up)
    out = gf2_mul_triton(L.data, U.data, C.data, 300, 20)
    np.testing.assert_array_equal(m4.to_numpy(m4.BitMatrix(out, 2048)),
                                  c ^ oracle.mul(lp, up))


@pytest.mark.gpu
@pytest.mark.parametrize("preserve_l", [False, True])
def test_pivot_kernel_on_gpu(gpu, rng, preserve_l):
    win = random_dense(rng, 576, 512)
    win[100:300] = win[0:200]
    _pivot_case(win, 512, preserve_l, interpret=False)


@pytest.mark.gpu
@pytest.mark.parametrize("nb,W", [(96, 120), (224, 230)])
def test_pivot_kernel_odd_width_on_gpu(gpu, rng, nb, W):
    """Panel widths whose word count is not a power of two (a matrix
    narrower than the panel): the kernel pads its blocks to powers of
    two."""
    _pivot_case(random_dense(rng, W, nb), nb, True, interpret=False)


@pytest.mark.gpu
def test_ple_on_gpu_matches_xla_engine(gpu, rng):
    from m4ri_jax.models.ple import block_factor
    a = random_dense(rng, 700, 1300)
    a[100:400] = 0
    A = m4.from_numpy(a)
    want = block_factor(A, preserve_l=True, engine="xla")
    got = block_factor(A, preserve_l=True)  # default: the GPU kernels
    for g, w, what in zip(got, want, ["data", "P", "Q", "rank"]):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=what)
