"""Benchmark entry: one JSON line on stdout.

Metric: dense GF(2) multiply at n (default 4096) through the public
``mul``, effective bit-op/s = 2*n^3 / wall, where wall is the median of
timed calls, each ended by ``block_until_ready``, after a warm-up call
that compiles.  ``vs_baseline`` compares against the reference M4RI
library compiled with gcc -O3 -march=native on a host CPU (BASELINE.md:
bench_multiplication 4096 = 0.03943 s == 3.49 Tbit-op/s).

Runs on the GPU and fails without one.  The device, card name and power
limit are printed on stderr and recorded in the JSON line.

Usage: python bench.py [n] [samples]
"""

from __future__ import annotations

import json
import statistics
import sys
import time

REFERENCE_WALL_S = 0.03943  # reference bench_multiplication 4096, host CPU


def bench_mul(n: int = 4096, samples: int = 11) -> float:
    """Median wall time of one n^3 GF(2) multiply on the device."""
    import jax
    import jax.numpy as jnp
    import m4ri_jax as m4
    from m4ri_jax.core.bitmatrix import BitMatrix

    w = n // 32
    a = BitMatrix(jax.random.bits(jax.random.PRNGKey(0), (n, w),
                                  dtype=jnp.uint32), n)
    b = BitMatrix(jax.random.bits(jax.random.PRNGKey(1), (n, w),
                                  dtype=jnp.uint32), n)
    jax.block_until_ready(m4.mul(a, b).data)  # compile + warm
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        jax.block_until_ready(m4.mul(a, b).data)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    samples = int(sys.argv[2]) if len(sys.argv) > 2 else 11
    from m4ri_jax.utils import runtime
    import jax
    runtime.use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"no GPU (JAX platform {dev.platform!r})", file=sys.stderr)
        sys.exit(2)
    card = runtime.card_info()
    print(f"# device {dev.device_kind} x{len(jax.devices())}; card {card}",
          file=sys.stderr)
    wall = bench_mul(n, samples)
    bitops = 2.0 * n**3 / wall
    ref_bitops = 2.0 * 4096**3 / REFERENCE_WALL_S
    print(json.dumps({
        "metric": f"gf2_mul_{n} effective bit-op/s",
        "value": bitops / 1e12,
        "unit": "Tbit-op/s",
        "wall_s": wall,
        "vs_baseline": bitops / ref_bitops,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }))


if __name__ == "__main__":
    main()
