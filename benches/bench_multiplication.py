"""GF(2) multiply benchmark (reference: bench/bench_multiplication.c —
`bench_multiplication n [cutoff]`).

Usage: python benches/bench_multiplication.py [n] [engine]
  engine in {dispatch, base, m4rm, strassen, naive}

``dispatch`` is the production `mul()` path (Strassen schedules engage at
min-dim >= 2*strassen_cutoff, depth auto-capped at 2); ``base`` is the raw
product dispatch (GPU kernel or blocked XLA route, no Strassen) — useful
for ablations.
"""

import sys
import os

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, run_timed, start, xla_counters

REF_4096_S = 0.03943  # reference bench_multiplication 4096 on host CPU


def main():
    start()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    engine = sys.argv[2] if len(sys.argv) > 2 else "base"

    import jax
    import jax.numpy as jnp
    from m4ri_jax.ops.mul import mul_packed_data
    from m4ri_jax.ops.strassen import strassen_mul_data

    w = n // 32
    a = jax.random.bits(jax.random.PRNGKey(0), (n, w), dtype=jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(1), (n, w), dtype=jnp.uint32)

    if engine == "dispatch":
        from m4ri_jax.core.bitmatrix import BitMatrix
        from m4ri_jax.ops.mul import mul
        core = lambda x, y: mul(BitMatrix(x, n), BitMatrix(y, n)).data
    elif engine == "base":
        core = mul_packed_data
    elif engine == "strassen":
        core = lambda x, y: strassen_mul_data(x, y, n, n, n, cutoff=n // 4)
    elif engine == "m4rm":
        from m4ri_jax.core.bitmatrix import BitMatrix
        from m4ri_jax.ops.m4rm import mul_m4rm
        core = lambda x, y: mul_m4rm(BitMatrix(x, n), BitMatrix(y, n)).data
    elif engine == "naive":
        from m4ri_jax.core.bitmatrix import BitMatrix
        from m4ri_jax.ops.mul import mul_naive
        core = lambda x, y: mul_naive(BitMatrix(x, n), BitMatrix(y, n)).data
    else:
        raise SystemExit(f"unknown engine {engine}")

    prod = jax.jit(core)
    jax.block_until_ready(prod(a, b))  # compile (excluded from timing)
    res = run_timed(lambda: jax.block_until_ready(prod(a, b)),
                    max_samples=20, max_time=120)
    bitops = 2.0 * n**3 / res.mean
    vs = (bitops / (2.0 * 4096**3 / REF_4096_S)) if n == 4096 else None
    emit(f"gf2_mul_{n}_{engine}", bitops / 1e12, "Tbit-op/s", res.mean, vs,
         counters=xla_counters(prod, a, b))

if __name__ == "__main__":
    main()
