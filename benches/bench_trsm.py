"""TRSM benchmark, 4 variants (reference: bench/bench_trsm.c — `bench_trsm
m n upper left`).  Reference baselines 32768^2 on host CPU: lower_right
24.199 s, lower_left 9.156 s, upper_right 9.786 s, upper_left 11.002 s.

Usage: python benches/bench_trsm.py [m] [n] [upper] [left]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from harness import emit, profiled, run_timed, start

REF = {(32768, 0, 0): 24.199, (32768, 0, 1): 9.156,
       (32768, 1, 0): 9.786, (32768, 1, 1): 11.002}


def main():
    start()
    m = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    n = int(sys.argv[2]) if len(sys.argv) > 2 else m
    upper = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    left = int(sys.argv[4]) if len(sys.argv) > 4 else 1

    import jax
    import jax.numpy as jnp
    import numpy as np
    from m4ri_jax.core.bitmatrix import BitMatrix, width_for, mask_padding
    from m4ri_jax.core.bitops import _triangle_mask
    from m4ri_jax.models import triangular as tri

    tdim = n if left else n  # the triangular operand is n x n
    tdata = jax.random.bits(jax.random.PRNGKey(0), (n, width_for(n)),
                            dtype=jnp.uint32)
    keep = _triangle_mask(n, upper=bool(upper))
    from m4ri_jax.core.bitmatrix import identity
    t = mask_padding(BitMatrix((tdata & keep) | identity(n).data, n))
    bshape = (n, m) if left else (m, n)
    b = BitMatrix(jax.random.bits(jax.random.PRNGKey(1),
                                  (bshape[0], width_for(bshape[1])),
                                  dtype=jnp.uint32), bshape[1])
    fn = {(1, 1): tri.trsm_upper_left, (1, 0): tri.trsm_upper_right,
          (0, 1): tri.trsm_lower_left, (0, 0): tri.trsm_lower_right}[
        (upper, left)]

    def once():
        x = fn(t, b)
        jax.device_get(x.data[0])

    once = profiled(once)
    once()
    res = run_timed(once, max_samples=10, max_time=180)
    ref = REF.get((m, upper, left))
    name = f"trsm_{'upper' if upper else 'lower'}_{'left' if left else 'right'}"
    emit(f"{name}_{m}x{n}", res.mean, "s", res.mean,
         (ref / res.mean) if ref else None, bitops=float(n) * n * m)


if __name__ == "__main__":
    main()
