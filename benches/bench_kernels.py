"""Each GPU kernel against what XLA makes of the plain version, in one
process: the layer timings and the end-to-end timings that decide whether
a kernel stays (a kernel stays only if it is faster end to end).

Layer rows (median of timed runs around block_until_ready, after a
warm-up; every kernel result is first compared bit for bit with the plain
version):
  mul_kernel / mul_plain      packed product at 4096^3 and 16384^3
  schur_kernel / schur_plain  C ^= Lp @ Up at 32768 x 256 x 32768, with
                              the bounds of the first, middle and last
                              panel of a PLE 32768 sweep
  pivot_kernel / pivot_plain  one 256-column panel's pivot loop on a
                              512-row window
  gate_kernel / gate_plain    C ^= A @ B with no skipped tiles, over the
                              contraction depth (128-2048 bits at
                              32768 x k x 32768) and the size (k = 256 at
                              1024, 4096, 32768): where the product
                              kernel's shape gate (ops/mul.py) stops
  dot_int8 / dot_bf16 / ...   the plain route's unpack-dot-pack at 16384^3
                              with each operand dtype
End-to-end rows (the factorization behind PLE 32768 and rank 16384, with
the GPU kernels, engine "triton", and with plain XLA, engine "xla").

Prints one JSON line per row (device kind, card name and power limit in
each) and writes them to chiprun_out/bench_kernels.jsonl.

Usage: python benches/bench_kernels.py [--quick]
                                       [--only layers,gate,dtype,e2e,sweep]
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def timed(fn, reps: int = 5, warm: int = 1) -> float:
    import jax
    for _ in range(warm):
        jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="fewer repetitions")
    ap.add_argument("--only", default="layers,gate,dtype,e2e",
                    help="comma list of sections: layers, gate (product "
                         "kernel vs plain over depth and size), dtype "
                         "(plain-dot operand dtypes), sweep (tile / warp / "
                         "panel variants), e2e (kernels on and off)")
    args = ap.parse_args()
    only = set(args.only.split(","))

    from m4ri_jax.utils import runtime
    import jax
    import jax.numpy as jnp
    runtime.use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU (platform {dev.platform!r})")
    card = runtime.card_info()
    print(f"card: {card}", flush=True)

    from m4ri_jax.core.bitmatrix import BitMatrix, mask_padding, width_for
    from m4ri_jax.models import ple as plemod
    from m4ri_jax.ops import mul as mulmod
    from m4ri_jax.ops.gpu_mul import gf2_mul_triton
    reps = 3 if args.quick else 7
    os.makedirs(os.path.join(runtime.ROOT, "chiprun_out"), exist_ok=True)
    out = open(os.path.join(runtime.ROOT, "chiprun_out",
                            "bench_kernels.jsonl"), "a")

    def emit(**rec):
        rec.update(device=dev.device_kind, card=card)
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")

    def rand(n, m=None, seed=0):
        m = m or n
        return mask_padding(BitMatrix(jax.random.bits(
            jax.random.PRNGKey(seed), (m, width_for(n)), dtype=jnp.uint32),
            n)).data

    plain = jax.jit(lambda a, b: mulmod.mul_packed_data(
        a, b, allow_kernels=False))
    plain_acc = jax.jit(lambda c, a, b: c ^ mulmod.mul_packed_data(
        a, b, allow_kernels=False))

    if "layers" in only:
        for n in (4096, 16384):
            a, b = rand(n, seed=1), rand(n, seed=2)
            assert bool(jnp.array_equal(gf2_mul_triton(a, b), plain(a, b)))
            emit(row="mul_kernel", n=n, s=timed(lambda: gf2_mul_triton(a, b),
                                                 reps))
            emit(row="mul_plain", n=n, s=timed(lambda: plain(a, b), reps))
            del a, b

        n, k = 32768, 256
        m_pad = n + 512  # PLE's padded row count at this size
        c = rand(n, m=m_pad, seed=3)
        lp_full = rand(k, m=m_pad, seed=4)
        up_full = rand(n, m=k, seed=5)
        for t in (0, 64, 127):  # first, middle and last panel
            r0, c0w = t * k, (t + 1) * (k // 32)
            lp = lp_full * (jnp.arange(m_pad)[:, None] >= r0).astype(
                jnp.uint32)
            up = up_full * (jnp.arange(up_full.shape[1])[None, :] >= c0w
                            ).astype(jnp.uint32)
            want = plain_acc(c, lp, up)
            assert bool(jnp.array_equal(
                gf2_mul_triton(lp, up, c, r0, c0w), want))
            emit(row="schur_kernel", panel=t,
                 s=timed(lambda: gf2_mul_triton(lp, up, c, r0, c0w), reps))
            emit(row="schur_plain", panel=t,
                 s=timed(lambda: plain_acc(c, lp, up), reps))
        del c, lp_full, up_full, lp, up, want

        nb, W = 256, 512
        win = rand(nb, m=W, seed=6)
        for eng in ("triton", "xla"):
            f = jax.jit(lambda w, eng=eng: plemod.run_panel_loop(
                w, jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
                1 << 20, nb, True, 0, eng))
            emit(row="pivot_kernel" if eng == "triton" else "pivot_plain",
                 window=W, nb=nb, s=timed(lambda: f(win), reps))

    if "gate" in only:
        gate(emit, rand, plain_acc, reps)

    if "dtype" in only:
        def dot_as(dt, precision=None):
            """The plain route's unpack-dot-pack with ``dt`` operands: 0/1
            is exact in each; int8 accumulates in int32, the floats in
            f32 (exact for k <= 2**24 unless XLA lowers the accumulation
            precision, hence the explicit ``precision``)."""
            acc = jnp.int32 if dt == jnp.int8 else jnp.float32

            def f(a, b):
                p = jax.lax.dot_general(
                    mulmod.unpack_bits(a, dt), mulmod.unpack_bits(b, dt),
                    (((1,), (0,)), ((), ())), precision=precision,
                    preferred_element_type=acc)
                return mulmod.pack_bits(p.astype(jnp.int32) & 1)
            return jax.jit(f)

        ref8 = dot_as(jnp.int8)
        n = 16384
        a, b = rand(n, seed=7), rand(n, seed=8)
        for dt in (jnp.int8, jnp.bfloat16, jnp.float8_e4m3fn):
            g = dot_as(dt, jax.lax.Precision.HIGHEST)
            try:
                ok = bool(jnp.array_equal(g(a, b), ref8(a, b)))
                emit(row=f"dot_{jnp.dtype(dt).name}", n=n, exact=ok,
                     s=timed(lambda: g(a, b), reps))
            except Exception as e:  # a dtype XLA cannot lower here
                emit(row=f"dot_{jnp.dtype(dt).name}", n=n,
                     error=f"{type(e).__name__}: {str(e)[:200]}")
        del a, b

    if "sweep" in only:
        sweep(emit, rand, plain_acc, reps)

    if "e2e" not in only:
        return

    # ---- end to end: the factorization with the kernels and without ----
    # rank(a) is block_factor(a, preserve_l=False)'s rank; ple(a) is
    # block_factor(a, preserve_l=True) plus an L compression that does not
    # depend on the engine.
    A16 = BitMatrix(rand(16384, seed=9), 16384)
    A32 = BitMatrix(rand(32768, seed=11), 32768)
    ref = {}
    for eng in ("triton", "xla"):
        name = "kernels" if eng == "triton" else "plain"
        for row, A, keep_l in (("e2e_ple_32768", A32, True),
                               ("e2e_rank_16384", A16, False)):
            def run(A=A, keep_l=keep_l):
                return plemod.block_factor(A, preserve_l=keep_l, engine=eng)
            t0 = time.perf_counter()
            got = jax.block_until_ready(run())
            first = time.perf_counter() - t0
            emit(row=row, variant=name, first_call_s=first,
                 s=timed(run, max(3, reps // 2), warm=0))
            if row in ref:
                assert all(bool(jnp.array_equal(x, y)) for x, y in
                           zip(got, ref[row])), f"{row}: engines differ"
            else:
                ref[row] = got
    out.close()


def gate(emit, rand, plain_acc, reps):
    """C ^= A @ B through the kernel and through the plain route, every
    tile computed (r0 = c0w = 0), over the contraction depth at the Schur
    shape's m = n = 32768 and over the size at the panel depth (256)."""
    import jax.numpy as jnp
    from m4ri_jax.ops.gpu_mul import gf2_mul_triton
    shapes = [(32768, k) for k in (128, 256, 512, 1024, 2048)] + \
        [(1024, 256), (4096, 256)]
    for n, k in shapes:
        c = rand(n, seed=40)
        a, b = rand(k, m=n, seed=41), rand(n, m=k, seed=42)
        want = plain_acc(c, a, b)
        assert bool(jnp.array_equal(gf2_mul_triton(a, b, c), want)), \
            (n, k)
        emit(row="gate_kernel", m=n, k=k, n=n,
             s=timed(lambda: gf2_mul_triton(a, b, c), reps))
        emit(row="gate_plain", m=n, k=k, n=n,
             s=timed(lambda: plain_acc(c, a, b), reps))
        del c, a, b, want


def sweep(emit, rand, plain_acc, reps):
    """Tile, warp and panel-shape variants of the two kernels."""
    import jax
    import jax.numpy as jnp
    from m4ri_jax.models import ple as plemod
    from m4ri_jax.ops.gpu_mul import gf2_mul_triton
    from m4ri_jax.ops.gpu_panel import panel_loop
    tiles = [(128, 8, 4, 8), (128, 16, 4, 8), (128, 8, 8, 8), (64, 16, 4, 8),
             (128, 8, 4, 4), (256, 8, 4, 8), (64, 8, 4, 4)]
    n, k = 32768, 256
    c = rand(n, m=n + 1024, seed=3)
    lp, up = rand(k, m=n + 1024, seed=4), rand(n, m=k, seed=5)
    want = plain_acc(c, lp, up)
    for tile in tiles:
        f = jax.jit(lambda lp, up, c, tile=tile: gf2_mul_triton(
            lp, up, c, 0, 0, tile=tile))
        try:
            assert bool(jnp.array_equal(f(lp, up, c), want))
            emit(row="sweep_schur_tile", tile=tile, panel=0,
                 s=timed(lambda: f(lp, up, c), reps))
        except Exception as e:
            emit(row="sweep_schur_tile", tile=tile,
                 error=f"{type(e).__name__}: {str(e)[:200]}")
    del c, lp, up, want
    a, b = rand(16384, seed=1), rand(16384, seed=2)
    for tile in tiles:
        f = jax.jit(lambda a, b, tile=tile: gf2_mul_triton(a, b, tile=tile))
        try:
            emit(row="sweep_mul_tile", tile=tile, n=16384,
                 s=timed(lambda: f(a, b), reps))
        except Exception as e:
            emit(row="sweep_mul_tile", tile=tile,
                 error=f"{type(e).__name__}: {str(e)[:200]}")
    del a, b
    for W, nb in ((512, 256), (256, 128)):
        win = rand(nb, m=W, seed=6)
        al0 = jnp.concatenate(
            [win, jnp.zeros((W, nb // 32), jnp.uint32)], axis=1)
        ref = plemod.run_panel_loop(win, jnp.int32(0), jnp.int32(0),
                                    jnp.int32(0), jnp.int32(0), 1 << 20, nb,
                                    True, 0, "xla")
        fx = jax.jit(lambda w: plemod.run_panel_loop(
            w, jnp.int32(0), jnp.int32(0), jnp.int32(0), jnp.int32(0),
            1 << 20, nb, True, 0, "xla"))
        emit(row="sweep_pivot_plain", window=W, nb=nb,
             s=timed(lambda: fx(win), reps))
        for warps in (2, 4, 8):
            f = jax.jit(lambda al, warps=warps: panel_loop(
                al, 0, 0, 1 << 20, nb=nb, preserve_l=True,
                num_warps=warps))
            try:
                assert bool(jnp.array_equal(f(al0)[0], ref[0]))
                emit(row="sweep_pivot_kernel", window=W, nb=nb,
                     warps=warps, s=timed(lambda: f(al0), reps))
            except Exception as e:
                emit(row="sweep_pivot_kernel", window=W, nb=nb,
                     warps=warps,
                     error=f"{type(e).__name__}: {str(e)[:200]}")


if __name__ == "__main__":
    main()
