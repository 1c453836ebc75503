"""Rank benchmark (reference: bench/bench_rank.c — non-reduced echelon).
Reference baseline: 16384^2 m4ri = 0.8867 s on host CPU.

Usage: python benches/bench_rank.py [m] [n]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, profiled, run_timed, start


def main():
    start()
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n = int(sys.argv[2]) if len(sys.argv) > 2 else m

    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, width_for
    from m4ri_jax.models.echelon import rank

    a = BitMatrix(jax.random.bits(jax.random.PRNGKey(0), (m, width_for(n)),
                                  dtype=jnp.uint32), n)

    def once():
        jax.device_get(rank(a))

    once = profiled(once)
    once()
    res = run_timed(once, max_samples=10, max_time=120)
    ref = 0.8867 if (m == 16384 and n == 16384) else None
    emit(f"rank_{m}x{n}", res.mean, "s", res.mean,
         (ref / res.mean) if ref else None,
         bitops=float(m) * n * min(m, n))


if __name__ == "__main__":
    main()
