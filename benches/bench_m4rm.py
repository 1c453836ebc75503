"""M4RM (Gray-code table) multiplication benchmark (reference:
bench/bench_m4rm.c — `bench_m4rm n k` or `bench_m4rm m n l k`; k = 0
means auto via m4ri_opt_k).

Usage: python benches/bench_m4rm.py [m] [n] [l] [k]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, profiled, run_timed, start


def main():
    start()
    args = [int(a) for a in sys.argv[1:]]
    if len(args) <= 2:
        m = n = l = (args[0] if args else 4096)
        k = args[1] if len(args) > 1 else 0
    else:
        m, n, l = args[0], args[1], args[2]
        k = args[3] if len(args) > 3 else 0

    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, width_for
    from m4ri_jax.ops.m4rm import mul_m4rm

    a = BitMatrix(jax.random.bits(jax.random.PRNGKey(0), (m, width_for(l)),
                                  dtype=jnp.uint32), l)
    b = BitMatrix(jax.random.bits(jax.random.PRNGKey(1), (l, width_for(n)),
                                  dtype=jnp.uint32), n)

    def once():
        c = mul_m4rm(a, b, k)
        jax.device_get(c.data[0])

    once = profiled(once)
    once()
    res = run_timed(once, max_samples=8, max_time=120)
    emit(f"mul_m4rm_{m}x{l}x{n}_k{k}", res.mean, "s", res.mean,
         bitops=2.0 * m * l * n)


if __name__ == "__main__":
    main()
