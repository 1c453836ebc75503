"""Debug-dump hashing (reference analogue: debug_dump.[ch], mzd_hash
mzd.h:1174-1180 — a rolling row-rotate XOR hash printed after every mutator
when built with --enable-debug-dump; the key mechanism for diffing two
implementations op by op).

Ours is the structural equivalent on 32-bit words: per-row FNV-style fold,
rotated by row index, XOR-combined — cheap, order-sensitive, and computable
on device.  Enable op-level logging with ``debug_dump(True)``; every public
mutator then logs ``name: hash`` like the reference's __M4RI_DD_MZD macros.
"""

from __future__ import annotations

import jax.numpy as jnp

from ..core.bitmatrix import BitMatrix

_ENABLED = False


def debug_dump(enable: bool = True) -> None:
    global _ENABLED
    _ENABLED = enable


def matrix_hash(a: BitMatrix) -> jnp.ndarray:
    """Order-sensitive 32-bit hash of a BitMatrix."""
    data = a.data
    nrows = data.shape[0]
    # FNV-ish fold along the word axis
    prime = jnp.uint32(16777619)
    basis = jnp.uint32(2166136261)
    widx = jnp.arange(data.shape[1], dtype=jnp.uint32)
    golden = jnp.uint32(0x9E3779B9)
    rowh = jnp.bitwise_xor.reduce((data * prime) ^ (widx[None, :] * golden),
                                  axis=1) ^ basis
    rot = jnp.arange(nrows, dtype=jnp.uint32) % 32
    rolled = (rowh << rot) | (rowh >> ((32 - rot) % 32))
    return jnp.bitwise_xor.reduce(rolled) ^ jnp.uint32(a.ncols)


def dd(name: str, a: BitMatrix) -> None:
    """Log ``name: hash`` when debug-dump is enabled (reference:
    __M4RI_DD_MZD, debug_dump.h:29-61)."""
    if _ENABLED:
        print(f"[m4ri_jax dd] {name}: 0x{int(matrix_hash(a)):08x}")


def instrument(name: str, fn):
    """Wrap a public matrix-producing entry point so that, with
    debug_dump(True), every call logs the op name and result hash — the
    reference's op-by-op engine-diffing stream (__M4RI_DD_MZD at the end
    of every mutator).  Zero overhead when disabled."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        if _ENABLED:
            import jax
            items = out if isinstance(out, tuple) else (out,)
            for i, it in enumerate(items):
                if isinstance(it, BitMatrix) and not isinstance(
                        it.data, jax.core.Tracer):
                    tag = f"{name}[{i}]" if isinstance(out, tuple) else name
                    dd(tag, it)
        return out

    return wrapped
