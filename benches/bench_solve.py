"""Linear-system solve benchmark (driver config: PLE + mzd_solve_left at
32768^2; the reference has no standalone solve bench — solve rides
bench_ple's factorization plus two TRSMs).

Usage: python benches/bench_solve.py [n] [ncols_b]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, profiled, run_timed, start


def main():
    start()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    nb_cols = int(sys.argv[2]) if len(sys.argv) > 2 else 256

    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, width_for
    from m4ri_jax.models.solve import solve_left

    a = BitMatrix(jax.random.bits(jax.random.PRNGKey(0), (n, width_for(n)),
                                  dtype=jnp.uint32), n)
    b = BitMatrix(jax.random.bits(jax.random.PRNGKey(1),
                                  (n, width_for(nb_cols)),
                                  dtype=jnp.uint32), nb_cols)

    def once():
        x, ok = solve_left(a, b)
        jax.device_get(ok)
        jax.device_get(x.data[0])

    once = profiled(once)
    once()
    res = run_timed(once, max_samples=8, max_time=180)
    emit(f"solve_left_{n}x{n}_b{nb_cols}", res.mean, "s", res.mean,
         bitops=float(n) ** 3 + 2.0 * n * n * nb_cols)


if __name__ == "__main__":
    main()
