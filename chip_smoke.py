#!/usr/bin/env python3
"""Smoke run of the GF(2) engine on one GPU, through its public API, at
the sizes its users run.

Phases (each prints one ``PHASE {...}`` line with its checks, wall time,
backend compile time, persistent-cache hits and the device's
``peak_bytes_in_use`` so far):

0. gpu_tests — the card-only tests (``pytest -m gpu``) in their own
   process, before this process opens the card.
1. kernels — each GPU kernel against the plain XLA version beside it, at
   real widths: the packed product at 4096^3, 16384^3 and the Schur shape
   (32768 x panel width x 32768, XOR-accumulate, nonzero row/column
   bounds); the pivot-loop kernel on the configured window (512 rows of a
   256-bit panel on the GPU), preserve_l on and off.  Every comparison is bit for bit (GF(2) is exact).
2. main_path — mul 4096/16384/65536, rank+RREF 16384, PLE/PLUQ 32768,
   solve_left 32768 with 256 right-hand sides, the four TRSMs at 32768,
   invert 16384, and rows of the 16384 product against the native C++
   oracle on the host.
3. golden — the 27 reference-binary golden cases.

With ``--four-cards`` it runs only the distributed path (SUMMA and k-split
mul at 65536^3 on a 2x2 mesh, dist_ple 32768, dist_solve_left 32768 with
B=256) against the one-card results, and prints where each shard lives.

Any failed check exits non-zero.  The last line of a passing run is one
JSON object: {"ok": true, "device": {...}}.  There is no CPU fallback:
without a GPU the run fails, except under ``--rehearse``, which runs every
phase on the CPU at 1/16 of the sizes with the kernels in interpret mode
(a rehearsal of the script, not a measurement).

Usage: python chip_smoke.py [--four-cards] [--rehearse]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

INT8_EXACT = "int8 0/1 operands, exact int32 accumulation"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the distributed path on four GPUs")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU rehearsal at 1/16 size, kernels interpreted")
    args = ap.parse_args()

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        if args.four_cards:
            os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                       " --xla_force_host_platform_device_count=4")
    from m4ri_jax.utils import runtime  # fails outside the repo

    card = runtime.card_info()
    if not args.rehearse and card.startswith("nvidia-smi"):
        print(f"FAIL: no GPU ({card})", file=sys.stderr)
        return 2
    gpu_tests = None
    if not args.rehearse and not args.four_cards:
        gpu_tests = _run_gpu_tests()

    import jax
    runtime.use_compile_cache()
    clock = runtime.CompileClock()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        print(f"FAIL: no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        return 2
    print(f"device: {dev.device_kind} x{len(jax.devices())} "
          f"({dev.platform}), jax {jax.__version__}, "
          f"compile cache {jax.config.jax_compilation_cache_dir}", flush=True)
    print(f"card: {card}", flush=True)

    ctx = Ctx(jax, clock, scale=16 if args.rehearse else 1,
              interpret=args.rehearse)
    if gpu_tests is not None:
        ctx.phase_line("gpu_tests", [gpu_tests], 0.0, (0.0, 0, 0))
        if not gpu_tests["ok"]:
            return 1
    phases = ([four_cards] if args.four_cards
              else [kernels, main_path, golden])
    for phase in phases:
        if not ctx.run_phase(phase):
            return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


def _run_gpu_tests() -> dict:
    """The card-only tests, in their own process (this one has not opened
    the card yet)."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu", "-p",
         "no:cacheprovider", os.path.join(HERE, "tests")],
        cwd=HERE, env=env, capture_output=True, text=True)
    tail = (r.stdout.strip().splitlines() or ["?"])[-1]
    print(f"check gpu_tests rc={r.returncode}: {tail}", flush=True)
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-2000:], file=sys.stderr)
    return {"name": "pytest -m gpu", "ok": r.returncode == 0,
            "summary": tail, "wall_s": time.perf_counter() - t0}


class Ctx:
    def __init__(self, jax, clock, scale: int, interpret: bool):
        self.jax = jax
        self.clock = clock
        self.S = scale
        self.interpret = interpret
        self.checks = []

    def peak(self):
        stats = self.jax.devices()[0].memory_stats() or {}
        return stats.get("peak_bytes_in_use")

    def phase_line(self, name, checks, wall, c0):
        c1 = self.clock.snapshot()
        print("PHASE " + json.dumps({
            "phase": name, "ok": all(c["ok"] for c in checks),
            "checks": [c["name"] for c in checks],
            "n_ok": sum(c["ok"] for c in checks), "n": len(checks),
            "wall_s": wall, "compile_s": c1[0] - c0[0],
            "cache_hits": c1[1] - c0[1], "cache_misses": c1[2] - c0[2],
            "peak_bytes_in_use": self.peak()}), flush=True)

    def run_phase(self, phase) -> bool:
        self.checks = []
        c0 = self.clock.snapshot()
        t0 = time.perf_counter()
        try:
            phase(self)
            err = None
        except Exception as e:  # the phase fails; the run exits non-zero
            import traceback
            traceback.print_exc()
            err = f"{type(e).__name__}: {e}"
            self.checks.append({"name": "error", "ok": False, "error": err})
        self.phase_line(phase.__name__, self.checks,
                        time.perf_counter() - t0, c0)
        return err is None and all(c["ok"] for c in self.checks)

    def check(self, name, fn, note: str = ""):
        """Run one check; it returns a dict of details or raises."""
        t0 = time.perf_counter()
        detail = fn() or {}
        wall = time.perf_counter() - t0
        self.checks.append({"name": name, "ok": True, "wall_s": wall,
                            **detail})
        extra = " ".join(f"{k}={v}" for k, v in detail.items())
        print(f"check {name} ok wall={wall:.3f}s {extra}"
              + (f" [{note}]" if note else ""), flush=True)


# ---------------------------------------------------------------- helpers

def _rand(n, m=None, seed=0):
    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, mask_padding, width_for
    m = m or n
    return mask_padding(BitMatrix(
        jax.random.bits(jax.random.PRNGKey(seed), (m, width_for(n)),
                        dtype=jnp.uint32), n))


def _eq(x, y) -> bool:
    import jax.numpy as jnp
    return bool(jnp.array_equal(x, y))


def _ready(x):
    import jax
    return jax.block_until_ready(x)


# ----------------------------------------------------------------- phase 1

def kernels(ctx):
    import jax.numpy as jnp
    from m4ri_jax.models.ple import run_panel_loop
    from m4ri_jax.ops.gpu_mul import gf2_mul_triton
    from m4ri_jax.ops.mul import mul_packed_data
    S, interp = ctx.S, ctx.interpret

    def product(n):
        a, b = _rand(n, seed=1), _rand(n, seed=2)
        got = _ready(gf2_mul_triton(a.data, b.data, interpret=interp))
        want = mul_packed_data(a.data, b.data, allow_kernels=False)
        assert _eq(got, want), f"product kernel != plain at {n}"
        return {"shape": f"{n}x{n}x{n}"}

    ctx.check("kernel_mul_4096", lambda: product(4096 // S), INT8_EXACT)
    ctx.check("kernel_mul_16384", lambda: product(16384 // S), INT8_EXACT)

    def schur():
        from m4ri_jax.utils.config import get_config
        n, k = 32768 // S, get_config().panel_width
        r0, c0w = n // 3 + 5, n // 96 + 3
        c = _rand(n, seed=3).data
        rows = jnp.arange(n)[:, None] >= r0
        lp = _rand(k, m=n, seed=4).data * rows.astype(jnp.uint32)
        words = jnp.arange(c.shape[1])[None, :] >= c0w
        up = _rand(n, m=k, seed=5).data * words.astype(jnp.uint32)
        want = c ^ mul_packed_data(lp, up, allow_kernels=False)
        got = _ready(gf2_mul_triton(lp, up, c, r0, c0w, interpret=interp))
        assert _eq(got, want), "Schur-shape kernel != plain"
        return {"shape": f"{n}x{k}x{n}", "r0": r0, "c0w": c0w}

    ctx.check("kernel_schur_update", schur, INT8_EXACT + "; C ^= Lp@Up")

    def pivot(preserve_l):
        from m4ri_jax.utils.config import get_config
        cfg = get_config()
        nb, W = cfg.panel_width // max(1, S // 4), cfg.panel_window // max(
            1, S // 4)
        win = _rand(nb, m=W, seed=6).data
        # a rank-deficient band: rows W/8 .. 3W/8 repeat rows 0 .. W/4
        q = W // 8
        win = win.at[q:3 * q].set(win[0:2 * q])
        args = (win, jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
                W + 7, nb, preserve_l, 0)
        want = run_panel_loop(*args, "xla")
        got = _ready(run_panel_loop(
            *args, "triton_interpret" if interp else "triton"))
        for g, w, what in zip(got, want, ["AL", "rowperm", "r", "touched",
                                         "P", "Q"]):
            assert _eq(g, w), f"pivot kernel {what} differs"
        return {"window": f"{W}x{nb}", "rank": int(got[2])}

    ctx.check("kernel_pivot_loop_preserve_l", lambda: pivot(True),
              "uint32 bit operations only")
    ctx.check("kernel_pivot_loop_plain", lambda: pivot(False),
              "uint32 bit operations only")


# ----------------------------------------------------------------- phase 2

def main_path(ctx):
    import jax
    import jax.numpy as jnp
    import numpy as np
    import m4ri_jax as m4
    from m4ri_jax.core.bitmatrix import (BitMatrix, identity, mask_padding,
                                         width_for)
    from m4ri_jax.core.bitops import _triangle_mask
    from m4ri_jax.core.permutation import (apply_p_left, apply_p_right_trans,
                                           apply_p_right_trans_tri)
    from m4ri_jax.models.solve import _keep_below
    from m4ri_jax.ops.mul import mul_packed_data
    S = ctx.S

    def mul_check(n):
        a, b = _rand(n, seed=10), _rand(n, seed=11)
        c = _ready(m4.mul(a, b))
        want = mul_packed_data(a.data, b.data, allow_kernels=False)
        assert _eq(c.data, want), f"mul {n} != plain product"
        return {"n": n}

    ctx.check("mul_4096", lambda: mul_check(4096 // S), INT8_EXACT)

    def mul_16384_native():
        from m4ri_jax.native.build import native_mul
        n = 16384 // S
        a, b = _rand(n, seed=12), _rand(n, seed=13)
        c = _ready(m4.mul(a, b))
        want = mul_packed_data(a.data, b.data, allow_kernels=False)
        assert _eq(c.data, want), "mul 16384 != plain product"
        rows = 64
        a_h, b_h = np.asarray(a.data[:rows]), np.asarray(b.data)
        ref = native_mul(a_h, b_h, n, n)
        oracle = "native C++ popcount"
        if ref is None:  # no host compiler: numpy, still JAX-free
            au = np.unpackbits(a_h.view(np.uint8), axis=1,
                               bitorder="little")[:, :n].astype(np.float32)
            bu = np.unpackbits(b_h.view(np.uint8), axis=1,
                               bitorder="little")[:, :n].astype(np.float32)
            ref = np.packbits((au @ bu).astype(np.int64) % 2 == 1, axis=1,
                              bitorder="little").view(np.uint32)
            oracle = "numpy float32 (exact: k < 2**24)"
        assert np.array_equal(np.asarray(c.data[:rows]), ref), \
            "mul 16384 rows != host oracle"
        return {"n": n, "host_rows": rows, "oracle": oracle}

    ctx.check("mul_16384_strassen_vs_host", mul_16384_native, INT8_EXACT)

    def rank_rref():
        n = 16384 // S
        a = _rand(n, seed=14)
        r = int(m4.rank(a))
        E, r2 = m4.echelonize(a, full=True)
        E2, r3 = m4.echelonize(E, full=True)
        assert r == int(r2) == int(r3), (r, int(r2), int(r3))
        assert _eq(E2.data, E.data), "RREF is not a fixed point"
        return {"n": n, "rank": r}

    ctx.check("rank_rref_16384", rank_rref)

    def reconstruct(a, M, P, Q, r, trans_tri):
        m_, n = a.nrows, a.ncols
        Mu = apply_p_right_trans_tri(M, Q) if trans_tri else M
        data = Mu.data
        iidx = jnp.arange(m_, dtype=jnp.int32)
        kb = _keep_below(jnp.minimum(iidx, r), data.shape[1])
        L = BitMatrix((data & kb)[:, : width_for(m_)] | identity(m_).data, m_)
        U = mask_padding(BitMatrix(
            (data & ~kb) * (iidx < r)[:, None].astype(jnp.uint32), n))
        lhs = apply_p_right_trans(apply_p_left(a, P), Q)
        assert _eq(m4.mul(L, U).data, lhs.data), "P L U Q != A"

    def ple_check():
        n = 32768 // S
        a = _rand(n, seed=15)
        M, P, Q, r = m4.ple(a)
        _ready(M.data)
        reconstruct(a, M, P, Q, int(r), trans_tri=True)
        return {"n": n, "rank": int(r)}

    ctx.check("ple_32768", ple_check)

    def pluq_check():
        n = 32768 // S
        a = _rand(n, seed=16)
        M, P, Q, r = m4.pluq(a)
        reconstruct(a, M, P, Q, int(r), trans_tri=False)
        return {"n": n, "rank": int(r)}

    ctx.check("pluq_32768", pluq_check)

    def solve_check():
        n = 32768 // S
        a = _rand(n, seed=17)
        x0 = _rand(256, m=n, seed=18)
        b = m4.mul(a, x0)
        x, ok = m4.solve_left(a, b)
        assert bool(ok), "consistent system flagged inconsistent"
        assert _eq(m4.mul(a, x).data, b.data), "A X != B"
        return {"n": n, "rhs": 256}

    ctx.check("solve_left_32768_b256", solve_check)

    def trsm_check(upper, left):
        n = 32768 // S
        tdata = jax.random.bits(jax.random.PRNGKey(19), (n, width_for(n)),
                                dtype=jnp.uint32)
        t = mask_padding(BitMatrix(
            (tdata & _triangle_mask(n, upper=upper)) | identity(n).data, n))
        b = _rand(n, seed=20)
        fn = {(True, True): m4.trsm_upper_left,
              (True, False): m4.trsm_upper_right,
              (False, True): m4.trsm_lower_left,
              (False, False): m4.trsm_lower_right}[(upper, left)]
        x = fn(t, b)
        resid = m4.mul(t, x) if left else m4.mul(x, t)
        assert _eq(resid.data, b.data), "T X != B"
        return {"n": n}

    for upper in (True, False):
        for left in (True, False):
            name = (f"trsm_{'upper' if upper else 'lower'}_"
                    f"{'left' if left else 'right'}_32768")
            ctx.check(name, lambda u=upper, l=left: trsm_check(u, l))

    def invert_check():
        n = 16384 // S
        lo = mask_padding(BitMatrix(
            (_rand(n, seed=21).data & _triangle_mask(n, upper=False))
            | identity(n).data, n))
        up = mask_padding(BitMatrix(
            (_rand(n, seed=22).data & _triangle_mask(n, upper=True))
            | identity(n).data, n))
        a = m4.mul(lo, up)
        ainv, r = m4.invert(a)
        assert int(r) == n, f"rank {int(r)} != {n}"
        assert _eq(m4.mul(a, ainv).data, identity(n).data), "A A^-1 != I"
        return {"n": n}

    ctx.check("invert_16384", invert_check)

    def mul_65536():
        from m4ri_jax.ops.strassen import strassen_mul_data
        n = 65536 // S
        a, b = _rand(n, seed=23), _rand(n, seed=24)
        c = _ready(m4.mul(a, b))
        rows = 4096 // S
        want = mul_packed_data(a.data[:rows], b.data, allow_kernels=False)
        assert _eq(c.data[:rows], want), "65536 spot-check rows"
        ma = strassen_mul_data.lower(a.data, b.data, n, n, n).compile() \
            .memory_analysis()
        print(f"memory_analysis mul_{n}: {ma}", flush=True)
        return {"n": n, "spot_rows": rows}

    ctx.check("mul_65536_strassen3", mul_65536, INT8_EXACT)

    def ple_memory():
        from m4ri_jax.models.ple import _block_factor_impl, default_engine
        from m4ri_jax.utils.config import get_config
        cfg = get_config()
        n = 32768 // S
        a = _rand(n, seed=15)
        ma = _block_factor_impl.lower(
            a.data, n, n, cfg.panel_width, True, 0, cfg.panel_window,
            default_engine(),
            cfg.ple_block_panels).compile().memory_analysis()
        print(f"memory_analysis ple_{n}: {ma}", flush=True)
        return {"n": n}

    ctx.check("memory_analysis_ple_32768", ple_memory)


# ----------------------------------------------------------------- phase 3

def golden(ctx):
    sys.path.insert(0, os.path.join(HERE, "tests"))
    from golden_cases import case_id, check_case, load_cases
    for rec in load_cases():
        ctx.check(f"golden_{rec['op']}_{case_id(rec)}",
                  lambda rec=rec: check_case(rec))


# ---------------------------------------------------------------- 4 cards

def four_cards(ctx):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    import m4ri_jax as m4
    from m4ri_jax.parallel.dist_mul import mul_dist, mul_dist_ksplit
    from m4ri_jax.parallel.dist_ple import dist_ple
    from m4ri_jax.parallel.dist_solve import dist_solve_left
    from m4ri_jax.parallel.mesh import make_mesh
    S = ctx.S
    devs = jax.devices()
    assert len(devs) == 4, f"--four-cards needs 4 devices, found {len(devs)}"
    mesh = make_mesh(4)
    mesh1d = Mesh(np.array(devs).reshape(4, 1), ("x", "y"))
    print(f"mesh 2x2: {mesh.devices.tolist()}", flush=True)

    def peaks():
        return [d.memory_stats().get("peak_bytes_in_use")
                if d.memory_stats() else None for d in devs]

    def shards(x):
        return sorted({str(s.device) for s in x.addressable_shards})

    def warm(fn):
        """Seconds of one more call, compiled by now."""
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        return time.perf_counter() - t0

    def muls():
        n = 65536 // S
        a, b = _rand(n, seed=30), _rand(n, seed=31)
        want = _ready(m4.mul(a, b)).data
        t0 = time.perf_counter()
        c1 = _ready(mul_dist(a, b, mesh))
        t1 = time.perf_counter()
        c2 = _ready(mul_dist_ksplit(a, b, mesh))
        t2 = time.perf_counter()
        print(f"  summa shards on {shards(c1.data)}; ksplit shards on "
              f"{shards(c2.data)}", flush=True)
        assert _eq(c1.data, want), "SUMMA != one-card mul"
        assert _eq(c2.data, want), "k-split != one-card mul"
        return {"n": n, "summa_first_s": t1 - t0, "ksplit_first_s": t2 - t1,
                "one_card_warm_s": warm(lambda: m4.mul(a, b).data),
                "summa_warm_s": warm(lambda: mul_dist(a, b, mesh).data),
                "ksplit_warm_s": warm(
                    lambda: mul_dist_ksplit(a, b, mesh).data),
                "peak_per_card": peaks()}

    ctx.check("mul_dist_summa_ksplit_65536", muls, INT8_EXACT)

    def ple_d():
        n = 32768 // S
        a = _rand(n, seed=32)
        Mw, Pw, Qw, rw = m4.ple(a)
        _ready(Mw.data)
        t0 = time.perf_counter()
        Mg, Pg, Qg, rg = dist_ple(a, mesh1d)
        _ready(Mg.data)
        wall = time.perf_counter() - t0
        print(f"  dist_ple output shards on {shards(Mg.data)}", flush=True)
        assert int(rg) == int(rw), "rank"
        assert _eq(Mg.data, Mw.data), "M"
        assert _eq(Pg, Pw) and _eq(Qg, Qw), "P/Q"
        return {"n": n, "rank": int(rg), "dist_first_s": wall,
                "one_card_warm_s": warm(lambda: m4.ple(a)[0].data),
                "dist_warm_s": warm(lambda: dist_ple(a, mesh1d)[0].data),
                "peak_per_card": peaks()}

    ctx.check("dist_ple_32768", ple_d)

    def solve_d():
        n = 32768 // S
        a = _rand(n, seed=33)
        b = m4.mul(a, _rand(256, m=n, seed=34))
        xl, okl = m4.solve_left(a, b)
        _ready(xl.data)
        t0 = time.perf_counter()
        xs, ok = dist_solve_left(a, b, mesh1d)
        _ready(xs.data)
        wall = time.perf_counter() - t0
        print(f"  dist_solve_left output shards on {shards(xs.data)}",
              flush=True)
        assert bool(ok) and bool(okl), "inconsistent flag"
        assert _eq(xs.data, xl.data), "X differs from one-card solve_left"
        return {"n": n, "rhs": 256, "dist_first_s": wall,
                "one_card_warm_s": warm(lambda: m4.solve_left(a, b)[0].data),
                "dist_warm_s": warm(
                    lambda: dist_solve_left(a, b, mesh1d)[0].data),
                "peak_per_card": peaks()}

    ctx.check("dist_solve_left_32768_b256", solve_d)


if __name__ == "__main__":
    sys.exit(main())
