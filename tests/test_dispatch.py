"""Production dispatch-seam coverage.

The reference deliberately straddles its cutoffs (test_ple.c:142-148); here
every branch of mul_packed_data's dispatch (fused XLA / blocked XLA / GPU
product kernel) and the Strassen engagement seam execute under shrunken
Config thresholds, with a spy asserting *which* path ran.  The kernel
branch runs under the Pallas interpreter on CPU, with the backend check
patched to report a GPU."""

import numpy as np
import pytest

import m4ri_jax as m4
from m4ri_jax.utils.config import Config

import oracle
from conftest import random_dense


def _spy_kernel(monkeypatch, calls, backend="gpu"):
    from m4ri_jax.ops import gpu_mul
    from m4ri_jax.ops import mul as mulmod

    from m4ri_jax.utils.config import get_config
    get_config()  # derive (for the CPU) before the backend is patched
    real = gpu_mul.gf2_mul_triton

    def spy(a, b, *args, **kw):
        calls.append(("kernel", a.shape, b.shape))
        kw["interpret"] = True
        return real(a, b, *args, **kw)

    monkeypatch.setattr(gpu_mul, "gf2_mul_triton", spy)
    # the dispatch gates on the backend; pretend we are on a GPU (the spy
    # forces interpret mode so the kernel still runs on CPU)
    monkeypatch.setattr(mulmod.jax, "default_backend", lambda: backend)
    return calls


def _check(a_np, b_np, cfg, expect_kernel, monkeypatch, backend="gpu",
           allow_kernels=True):
    from m4ri_jax.ops.mul import mul_packed_data
    calls = _spy_kernel(monkeypatch, [], backend)
    A, B = m4.from_numpy(a_np), m4.from_numpy(b_np)
    out = mul_packed_data(A.data, B.data, cfg=cfg,
                          allow_kernels=allow_kernels)
    got = m4.to_numpy(m4.BitMatrix(out, b_np.shape[1]))
    np.testing.assert_array_equal(got, oracle.mul(a_np, b_np))
    assert (len(calls) > 0) == expect_kernel, calls


def test_dispatch_kernel_shallow_k(rng, monkeypatch):
    """kw <= 16, m >= 1024, nw >= 32 on a GPU: the Schur-update shape
    class routes through the product kernel."""
    a = random_dense(rng, 1024, 256)
    b = random_dense(rng, 256, 1024)
    _check(a, b, Config(), True, monkeypatch)


@pytest.mark.parametrize("k,expect", [(256, True), (480, True), (512, True),
                                      (513, False), (1024, False)])
def test_dispatch_kernel_depth_bound(rng, monkeypatch, k, expect):
    """The kernel takes contractions up to KERNEL_MAX_KW words (512 bits,
    the deepest where it measured faster); one bit deeper stays on XLA."""
    from m4ri_jax.ops.mul import KERNEL_MAX_KW
    assert KERNEL_MAX_KW * 32 == 512
    _check(random_dense(rng, 1024, k), random_dense(rng, k, 1024),
           Config(), expect, monkeypatch)


@pytest.mark.parametrize("k", [256, 1024])
def test_dispatch_accumulate_form(rng, monkeypatch, k):
    """mul_packed_data(..., c, r0, c0w): C ^ A B under the Schur contract
    (rows of A above r0 and words of B left of c0w zero), through the
    kernel at a panel-deep k and through XLA deeper, both bit-exact."""
    from m4ri_jax.ops.mul import mul_packed_data
    calls = _spy_kernel(monkeypatch, [])
    r0, c0w = 300, 5
    a = random_dense(rng, 1024, k)
    a[:r0] = 0
    b = random_dense(rng, k, 1024)
    b[:, : c0w * 32] = 0
    c = random_dense(rng, 1024, 1024)
    out = mul_packed_data(m4.from_numpy(a).data, m4.from_numpy(b).data,
                          c=m4.from_numpy(c).data, r0=r0, c0w=c0w)
    got = m4.to_numpy(m4.BitMatrix(out, 1024))
    np.testing.assert_array_equal(got, c ^ oracle.mul(a, b))
    assert (len(calls) > 0) == (k <= 512), calls


@pytest.mark.parametrize("engine,k,expect", [
    ("triton", 256, True), ("triton", 1024, False), ("xla", 256, False),
    ("triton_interpret", 1024, True)])
def test_schur_update_follows_the_gate(rng, monkeypatch, engine, k, expect):
    """The factorization's Schur update takes its route from the same
    shape gate as every other product; "xla" pins the plain route and
    "triton_interpret" the interpreted kernel at any shape."""
    from m4ri_jax.models.ple import schur_update
    calls = _spy_kernel(monkeypatch, [])
    a = random_dense(rng, 1024, k)
    b = random_dense(rng, k, 1024)
    c = random_dense(rng, 1024, 1024)
    out = schur_update(m4.from_numpy(c).data, m4.from_numpy(a).data,
                       m4.from_numpy(b).data, 0, 0, engine)
    got = m4.to_numpy(m4.BitMatrix(out, 1024))
    np.testing.assert_array_equal(got, c ^ oracle.mul(a, b))
    assert (len(calls) > 0) == expect, calls


def test_trsm_and_solve_reach_the_kernel_only_in_the_schur_update(
        monkeypatch):
    """At the full size (32768, 256 right-hand sides; traced only) on a
    GPU, no TRSM product takes the kernel, and solve_left reaches it only
    through its factorization's panel-deep Schur updates."""
    import jax
    import jax.numpy as jnp
    from m4ri_jax.ops.mul import KERNEL_MAX_KW
    from m4ri_jax.utils import config as C
    # the GPU panel (256 bits on a 512-row window)
    gpu = C.gpu_config("NVIDIA H100 80GB HBM3", 60 * 1024**3)
    monkeypatch.setenv("M4RI_JAX_PANEL_WIDTH", str(gpu.panel_width))
    monkeypatch.setenv("M4RI_JAX_PANEL_WINDOW", str(gpu.panel_window))
    C.get_config.cache_clear()
    try:
        calls = _spy_kernel(monkeypatch, [])
        assert C.get_config().panel_width == 256
        n, w = 32768, 32768 // 32
        sq = m4.BitMatrix(jax.ShapeDtypeStruct((n, w), jnp.uint32), n)
        rhs = m4.BitMatrix(jax.ShapeDtypeStruct((n, 8), jnp.uint32), 256)
        for fn in (m4.trsm_upper_left, m4.trsm_lower_left):
            jax.eval_shape(fn, sq, rhs)
        assert not calls, calls
        jax.eval_shape(lambda a, b: m4.solve_left(a, b), sq, rhs)
        assert calls and all(a[1] <= KERNEL_MAX_KW for _, a, _ in calls), \
            calls
    finally:
        C.get_config.cache_clear()


def test_dispatch_kernel_not_for_deep_k(rng, monkeypatch):
    """Deep contractions stay on the plain XLA route on a GPU (the kernel
    measured slower there)."""
    a = random_dense(rng, 1024, 1056)
    b = random_dense(rng, 1056, 1024)
    _check(a, b, Config(), False, monkeypatch)


@pytest.mark.parametrize("backend", ["cpu", "metal"])
def test_dispatch_kernel_gpu_only(rng, monkeypatch, backend):
    """The kernel shape on any other backend takes the XLA route."""
    a = random_dense(rng, 1024, 64)
    b = random_dense(rng, 64, 1024)
    _check(a, b, Config(), False, monkeypatch, backend=backend)


def test_dispatch_kernel_small_shapes_stay_on_xla(rng, monkeypatch):
    """Below the row / width gate (m < 1024 or nw < 32) XLA's one fused
    dot is used even on a GPU."""
    _check(random_dense(rng, 512, 64), random_dense(rng, 64, 1024),
           Config(), False, monkeypatch)
    _check(random_dense(rng, 1024, 64), random_dense(rng, 64, 992),
           Config(), False, monkeypatch)


def test_dispatch_allow_kernels_false(rng, monkeypatch):
    """allow_kernels=False pins the XLA route (callers under vmap)."""
    a = random_dense(rng, 1024, 64)
    b = random_dense(rng, 64, 1024)
    _check(a, b, Config(), False, monkeypatch, allow_kernels=False)


def test_vmap_never_reaches_the_kernel(rng, monkeypatch):
    """The vmapped callers (ops/m4rm.py) keep kernels out of the batched
    trace even on a GPU."""
    import jax
    import jax.numpy as jnp
    from m4ri_jax.ops.mul import mul_packed_data
    calls = _spy_kernel(monkeypatch, [])
    mats = [(random_dense(rng, 1024, 64), random_dense(rng, 64, 1024))
            for _ in range(2)]
    apk = jnp.stack([m4.from_numpy(a).data for a, _ in mats])
    bpk = jnp.stack([m4.from_numpy(b).data for _, b in mats])
    out = jax.vmap(lambda a, b: mul_packed_data(
        a, b, allow_kernels=False))(apk, bpk)
    for i, (a, b) in enumerate(mats):
        np.testing.assert_array_equal(
            m4.to_numpy(m4.BitMatrix(out[i], 1024)), oracle.mul(a, b))
    assert not calls, calls
    # and the m4rm engine, which vmaps internally, stays exact
    a, b = mats[0]
    got = m4.mul_m4rm(m4.from_numpy(a), m4.from_numpy(b))
    np.testing.assert_array_equal(m4.to_numpy(got), oracle.mul(a, b))
    assert not calls, calls


def test_block_factor_default_engine_on_gpu(rng, monkeypatch):
    """block_factor's engine follows the backend: the GPU kernels there,
    plain XLA elsewhere."""
    from m4ri_jax.models import ple as plemod
    assert plemod.default_engine() == "xla"
    monkeypatch.setattr(plemod.jax, "default_backend", lambda: "gpu")
    assert plemod.default_engine() == "triton"


def test_dispatch_fused_below_threshold(rng, monkeypatch):
    """Small products stay on the single fused XLA dot."""
    cfg = Config()
    a = random_dense(rng, 200, 130)
    b = random_dense(rng, 130, 170)
    _check(a, b, cfg, False, monkeypatch)


def test_dispatch_blocked_xla(rng, monkeypatch):
    """Above-threshold: the depth/row blocked XLA path (partial-parity XOR
    combining)."""
    cfg = Config(mul_block_threshold=64, mul_block_m=64, mul_block_k=64)
    a = random_dense(rng, 100, 200)
    b = random_dense(rng, 200, 90)
    _check(a, b, cfg, False, monkeypatch)


def test_dispatch_threshold_straddle(rng, monkeypatch):
    """One word below / at / above mul_block_threshold, all bit-exact
    (reference discipline: test_ple.c straddles __M4RI_PLE_CUTOFF)."""
    for n in (96, 128, 160):
        cfg = Config(mul_block_threshold=128, mul_block_m=64, mul_block_k=64)
        a = random_dense(rng, n, n)
        b = random_dense(rng, n, n)
        _check(a, b, cfg, False, monkeypatch)


def test_strassen_engagement_seam(rng, monkeypatch):
    """mul() must engage Strassen exactly at 2*cutoff and stay bit-exact
    on both sides of the seam."""
    from m4ri_jax.ops import mul as mulmod
    from m4ri_jax.ops import strassen as strmod
    small = Config(strassen_cutoff=64, strassen_max_levels=2)
    monkeypatch.setattr(mulmod, "get_config", lambda: small)
    monkeypatch.setattr(strmod, "get_config", lambda: small)
    rec_calls = []
    real_rec = strmod._mul_rec

    def spy(a, b, depth):
        rec_calls.append(depth)
        return real_rec(a, b, depth)

    monkeypatch.setattr(strmod, "_mul_rec", spy)
    for n, engaged in [(127, False), (128, True), (256, True)]:
        rec_calls.clear()
        a = random_dense(rng, n, n)
        b = random_dense(rng, n, n)
        got = m4.to_numpy(mulmod.mul(m4.from_numpy(a), m4.from_numpy(b)))
        np.testing.assert_array_equal(got, oracle.mul(a, b))
        assert (len(rec_calls) > 0) == engaged, (n, rec_calls)


def test_panel_window_seam(rng):
    """Factorizations with window exactly nb, nb + 1 row block, and full
    height agree bit for bit (the window/fallback dispatch seam)."""
    from m4ri_jax.models.ple import block_factor
    a = random_dense(rng, 200, 96)
    a[:70] = 0
    A = m4.from_numpy(a)
    outs = []
    for w in (32, 64, 224):
        outs.append(block_factor(A, preserve_l=True, nb=32, window=w,
                                 engine="xla"))
    for got in outs[1:]:
        for g, w_, what in zip(got, outs[0], ["data", "P", "Q", "rank"]):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w_),
                                          err_msg=what)
