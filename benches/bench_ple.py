"""PLE/PLUQ benchmark (reference: bench/bench_ple.c — `bench_ple m n
{ple,pluq}`).  Reference baseline: PLE 32768^2 = 7.0605 s on host CPU.

Usage: python benches/bench_ple.py [m] [n] [what]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, profiled, run_timed, start

REF = {("ple", 32768): 7.0605}


def main():
    start()
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n = int(sys.argv[2]) if len(sys.argv) > 2 else m
    what = sys.argv[3] if len(sys.argv) > 3 else "ple"

    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import BitMatrix, width_for
    from m4ri_jax.models.ple import ple, pluq

    data = jax.random.bits(jax.random.PRNGKey(0), (m, width_for(n)),
                           dtype=jnp.uint32)
    a = BitMatrix(data, n)
    fn = pluq if what == "pluq" else ple

    def once():
        mat, p, q, r = fn(a)
        jax.device_get(r)
        jax.device_get(mat.data[0])

    once = profiled(once)
    once()
    res = run_timed(once, max_samples=10, max_time=180)
    ref = REF.get((what, m))
    emit(f"{what}_{m}x{n}", res.mean, "s", res.mean,
         (ref / res.mean) if ref else None,
         bitops=float(m) * n * min(m, n))


if __name__ == "__main__":
    main()
