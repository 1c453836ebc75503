"""Inversion benchmark (reference: bench/bench_invert.c — `bench_invert
n direction alg`).  Reference baseline on this host CPU (gcc -O3
-march=native): full inversion 16384^2 = 4.6274 s.

Usage: python benches/bench_invert.py [n]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, profiled, run_timed, start


def main():
    start()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096

    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, identity, width_for
    from m4ri_jax.models.echelon import invert

    data = jax.random.bits(jax.random.PRNGKey(0), (n, width_for(n)),
                           dtype=jnp.uint32)
    a = BitMatrix(data | identity(n).data, n)  # diagonal set: likely full rank

    def once():
        inv, r = invert(a)
        jax.device_get(r)
        jax.device_get(inv.data[0])

    once = profiled(once)
    once()
    res = run_timed(once, max_samples=8, max_time=120)
    ref = 4.6274 if n == 16384 else None
    emit(f"invert_{n}", res.mean, "s", res.mean,
         (ref / res.mean) if ref else None, bitops=2.0 * n ** 3)


if __name__ == "__main__":
    main()
