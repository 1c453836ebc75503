"""Echelonization benchmark (reference: bench/bench_elimination.c —
`bench_elimination m [n alg r]`, alg in {m4ri, pluq, naive}).

Usage: python benches/bench_elimination.py [m] [n] [alg] [full]
Reference baselines on this host CPU (BASELINE.md): RREF m4ri 16384^2 =
1.2349 s; rank-only 0.8867 s.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, profiled, run_timed, start

REF = {("m4ri", 16384, True): 1.2349, ("m4ri", 16384, False): 0.8867}


def main():
    start()
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n = int(sys.argv[2]) if len(sys.argv) > 2 else m
    alg = sys.argv[3] if len(sys.argv) > 3 else "m4ri"
    full = (sys.argv[4] != "0") if len(sys.argv) > 4 else True

    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, width_for
    from m4ri_jax.models.echelon import echelonize, echelonize_pluq

    data = jax.random.bits(jax.random.PRNGKey(0), (m, width_for(n)),
                           dtype=jnp.uint32)
    a = BitMatrix(data, n)
    fn = echelonize_pluq if alg == "pluq" else echelonize

    def once():
        r_mat, r = fn(a, full=full)
        jax.device_get(r)
        jax.device_get(r_mat.data[0])

    once = profiled(once)
    once()  # compile (excluded from timing)
    res = run_timed(once, max_samples=10, max_time=120)
    ref = REF.get((alg, m, full))
    emit(f"echelonize_{alg}_{m}x{n}_full={int(full)}", res.mean, "s",
         res.mean, (ref / res.mean) if ref else None,
         bitops=float(m) * n * min(m, n))


if __name__ == "__main__":
    main()
