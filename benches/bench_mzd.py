"""Micro-op benchmarks (reference: bench/bench_mzd.c:794-831 — a function
mapper over the mzd_* row/bit/structural ops).

Each op is expressed as a data -> data transform, and a chain of them runs
inside one jit so a single op's time is well above the dispatch cost; the
reported time is the chain's median wall over its length.  Ops whose
reference counterpart returns a scalar (is_zero, cmp, density,
find_pivot, ...) fold that scalar back into word [0,0] so the chain has a
true data dependency and nothing is dead-code-eliminated.

Usage: python benches/bench_mzd.py [op|list] [n]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import functools

from harness import emit, run_timed, start


def build_ops(n: int, w: int, a, b, key):
    """Return {name: core} where core(data) -> data, all shapes static."""
    import jax
    import jax.numpy as jnp
    from m4ri_jax.core import bitops
    from m4ri_jax.core.bitmatrix import (BitMatrix, col_swap, density, equal,
                                         is_zero, randomize, row_swap, stack,
                                         submatrix, write_bit)
    from m4ri_jax.core.transpose import transpose
    from m4ri_jax.ops.mul import mul_packed_data

    M = lambda x: BitMatrix(x, n)

    def fold(x, scalar_u32):
        """XOR a scalar back into word [0,0] (data dependency for chains)."""
        return x.at[0, 0].set(x[0, 0] ^ jnp.asarray(scalar_u32, jnp.uint32))

    half = n // 2

    return {
        # structural / whole-matrix ops (mzd_transpose, mzd_add, mzd_copy...)
        "transpose": lambda x: transpose(M(x)).data,
        "add": lambda x: x ^ b,
        "copy": lambda x: jnp.copy(x),
        "stack": lambda x: stack(BitMatrix(x[half:], n),
                                 BitMatrix(x[:half], n)).data,
        "submatrix": lambda x: fold(
            x, submatrix(M(x), 1, 32, 1 + half, 32 + 32 * (w // 2)).data[0, 0]),
        "randomize": lambda x: randomize(
            n, n, jax.random.fold_in(key, x[0, 0].astype(jnp.int32))).data,
        # row ops (mzd_row_swap, mzd_copy_row, mzd_row_add[_offset])
        "row_swap": lambda x: row_swap(M(x), 1, n - 2).data,
        "copy_row": lambda x: bitops.copy_row(M(x), 0, M(x), n - 1).data,
        "row_add": lambda x: bitops.row_add(M(x), n - 1, 0).data,
        "row_add_offset": lambda x: bitops.row_add_offset(
            M(x), 0, n - 1, 65).data,
        "col_swap": lambda x: col_swap(M(x), 1, n - 2).data,
        # bit-field ops (mzd_read_bits / xor_bits / write_bit)
        "read_bits": lambda x: fold(x, bitops.read_bits(M(x), 3, 61, 17)),
        "xor_bits": lambda x: bitops.xor_bits(M(x), 3, 61, 17, 0x1ABCD).data,
        "write_bit": lambda x: write_bit(M(x), 5, 77, x[0, 0] & 1).data,
        # scalar-returning predicates (mzd_equal/cmp/is_zero/density/
        # find_pivot/first_zero_row)
        "equal": lambda x: fold(x, equal(M(x), M(b)).astype(jnp.uint32)),
        "cmp": lambda x: fold(x, bitops.cmp(M(x), M(b)).astype(jnp.uint32)),
        "is_zero": lambda x: fold(x, is_zero(M(x)).astype(jnp.uint32)),
        "density": lambda x: fold(
            x, (density(M(x)) * (2.0 ** 31)).astype(jnp.uint32)),
        "find_pivot": lambda x: fold(
            x, (lambda rc: (rc[0].astype(jnp.uint32) << 16)
                ^ rc[1].astype(jnp.uint32))(bitops.find_pivot(M(x), 0, 0))),
        "first_zero_row": lambda x: fold(
            x, bitops.first_zero_row(M(x)).astype(jnp.uint32)),
        # vector-matrix product (_mzd_mul_va): one row times the matrix
        "mul_va": lambda x: x.at[0].set(mul_packed_data(x[:1], b)[0]),
    }


def main():
    start()
    op = sys.argv[1] if len(sys.argv) > 1 else "transpose"
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 8192

    import jax
    import jax.numpy as jnp
    from m4ri_jax.core.bitmatrix import width_for

    w = width_for(n)
    key = jax.random.PRNGKey(2)
    a = jax.random.bits(jax.random.PRNGKey(0), (n, w), dtype=jnp.uint32)
    b = jax.random.bits(jax.random.PRNGKey(1), (n, w), dtype=jnp.uint32)

    ops = build_ops(n, w, a, b, key)
    if op == "list":
        print(" ".join(sorted(ops)))
        return
    if op not in ops:
        raise SystemExit(f"unknown op {op}; try: {' '.join(sorted(ops))}")
    core = ops[op]

    @functools.partial(jax.jit, static_argnames="iters")
    def chain(x, iters):
        for _ in range(iters):
            x = core(x)
        return x

    iters = 20
    jax.block_until_ready(chain(a, iters))  # compile (excluded)
    res = run_timed(lambda: jax.block_until_ready(chain(a, iters)))
    slope = res.mean / iters
    gbps = n * w * 4 / slope / 1e9
    emit(f"mzd_{op}_{n}", slope * 1e6, "us", slope)
    print(f"# effective {gbps:.1f} GB/s touched", file=sys.stderr)


if __name__ == "__main__":
    main()
