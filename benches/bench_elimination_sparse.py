"""Sparse-input echelonization benchmark (reference:
bench/bench_elimination_sparse.c — `bench_elimination_sparse m n (alg,
density, full)`; density defaults to 0.1).  Exercises the density-driven
engine dispatch (echelonform.h:37 crossover).

Usage: python benches/bench_elimination_sparse.py [m] [n] [alg] [density]
       [full]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, profiled, run_timed, start


def main():
    start()
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n = int(sys.argv[2]) if len(sys.argv) > 2 else m
    alg = sys.argv[3] if len(sys.argv) > 3 else "heuristic"
    density = float(sys.argv[4]) if len(sys.argv) > 4 else 0.1
    full = (sys.argv[5] != "0") if len(sys.argv) > 5 else True

    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, mask_padding, width_for
    from m4ri_jax.models.echelon import echelonize

    # Bernoulli(density) bits, built packed on device
    key = jax.random.PRNGKey(7)
    bits = (jax.random.uniform(key, (m, n)) < density).astype(jnp.uint8)
    from m4ri_jax.ops.mul import pack_bits
    a = mask_padding(BitMatrix(pack_bits(bits)[:, : width_for(n)], n))

    def once():
        r_mat, r = echelonize(a, full=full, strategy=alg)
        jax.device_get(r)
        jax.device_get(r_mat.data[0])

    once = profiled(once)
    once()
    res = run_timed(once, max_samples=8, max_time=120)
    emit(f"elimination_sparse_{alg}_{m}x{n}_d{density}", res.mean, "s",
         res.mean, bitops=float(m) * n * min(m, n))


if __name__ == "__main__":
    main()
