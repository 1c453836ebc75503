"""BitMatrix: the dense GF(2) matrix container.

Reference analogue: ``mzd_t`` (mzd.h:68-99) — a bit-packed matrix with 64-bit
words, zero-copy windows and an excess-bit discipline (mzd.h:102-139: bits
beyond ``ncols`` in the last word are undefined there; here they are *always
zero*, which every op preserves and tests assert — the functional equivalent
of the reference's pattern-fixture discipline, tests/testing.c:3-37).

Design:
- ``data: uint32[nrows, width]`` with ``width = ceil(ncols/32)``; column ``c``
  lives in word ``c // 32`` at bit ``c % 32`` (LSB first, matching the
  reference's __M4RI_GET_BIT convention misc.h:226 with radix 32 instead
  of 64 — the widest unsigned word every JAX backend handles natively).
- No in-place mutation: all ops are functional, jit-friendly, static shapes.
- Windows (mzd_init_window, mzd.c:159-177) become static slices resolved at
  trace time: ``submatrix`` below supports arbitrary column offsets (the
  reference requires lowc % 64 == 0 for windows; the general copying
  ``mzd_submatrix`` allows any offset, which is what we implement).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.config import WORD_BITS

__all__ = [
    "BitMatrix", "width_for", "padding_mask", "zeros", "identity",
    "from_numpy", "to_numpy", "from_packed", "randomize",
    "randomize_reference", "add", "equal", "is_zero", "read_bit",
    "write_bit", "submatrix", "stack", "concat", "row_swap", "col_swap",
    "mask_padding", "density", "shift_columns_left",
]


def width_for(ncols: int) -> int:
    return (ncols + WORD_BITS - 1) // WORD_BITS


def padding_mask(ncols: int) -> np.ndarray:
    """uint32[width] mask with 1s at valid column positions."""
    w = width_for(ncols)
    mask = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    rem = ncols % WORD_BITS
    if rem:
        mask[-1] = np.uint32((1 << rem) - 1)
    return mask


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BitMatrix:
    data: jax.Array  # uint32[nrows, width]
    ncols: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nrows(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1]

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    def __repr__(self) -> str:  # pragma: no cover
        return f"BitMatrix({self.nrows}x{self.ncols})"


def zeros(nrows: int, ncols: int) -> BitMatrix:
    return BitMatrix(jnp.zeros((nrows, width_for(ncols)), jnp.uint32), ncols)


def identity(n: int) -> BitMatrix:
    rows = jnp.arange(n, dtype=jnp.uint32)
    words = jnp.arange(width_for(n), dtype=jnp.uint32)
    data = jnp.where(
        rows[:, None] // WORD_BITS == words[None, :],
        jnp.uint32(1) << (rows[:, None] % WORD_BITS),
        jnp.uint32(0),
    )
    return BitMatrix(data, n)


def from_numpy(a: np.ndarray) -> BitMatrix:
    """Dense 0/1 numpy array -> BitMatrix."""
    a = np.asarray(a).astype(np.uint8) & 1
    nrows, ncols = a.shape
    w = width_for(ncols)
    padded = np.zeros((nrows, w * WORD_BITS), dtype=np.uint8)
    padded[:, :ncols] = a
    # little bit order within each 32-bit word
    packed = np.packbits(padded.reshape(nrows, w, 4, 8), axis=-1,
                         bitorder="little")
    data = packed.reshape(nrows, w, 4).view(np.uint32).reshape(nrows, w)
    return BitMatrix(jnp.asarray(data), ncols)


def to_numpy(m: BitMatrix) -> np.ndarray:
    """BitMatrix -> dense uint8 0/1 numpy array."""
    data = np.ascontiguousarray(jax.device_get(m.data))
    bytes_ = data.view(np.uint8).reshape(m.nrows, m.width * 4)
    bits = np.unpackbits(bytes_, axis=1, bitorder="little")
    return bits[:, : m.ncols]


def from_packed(data, ncols: int) -> BitMatrix:
    data = jnp.asarray(data, dtype=jnp.uint32)
    assert data.ndim == 2 and data.shape[1] == width_for(ncols)
    return mask_padding(BitMatrix(data, ncols))


def mask_padding(m: BitMatrix) -> BitMatrix:
    """Force padding bits (columns >= ncols) to zero."""
    mask = jnp.asarray(padding_mask(m.ncols))
    return BitMatrix(m.data & mask[None, :], m.ncols)


def randomize(nrows: int, ncols: int, key: jax.Array) -> BitMatrix:
    bits = jax.random.bits(key, (nrows, width_for(ncols)), dtype=jnp.uint32)
    return mask_padding(BitMatrix(bits, ncols))


def randomize_reference(nrows: int, ncols: int, seed: int = 17,
                        rng=None) -> BitMatrix:
    """Fill exactly like mzd_randomize under srandom(seed) (mzd.c:1270)."""
    from ..utils.rng import reference_random_data
    return BitMatrix(jnp.asarray(reference_random_data(nrows, ncols, seed, rng)),
                     ncols)


def add(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """GF(2) addition == XOR (reference: mzd_add, mzd.c)."""
    assert a.shape == b.shape
    return BitMatrix(a.data ^ b.data, a.ncols)


def equal(a: BitMatrix, b: BitMatrix) -> jax.Array:
    if a.shape != b.shape:
        return jnp.asarray(False)
    return jnp.all(a.data == b.data)


def is_zero(a: BitMatrix) -> jax.Array:
    return jnp.all(a.data == 0)


def read_bit(m: BitMatrix, i, j) -> jax.Array:
    w = jnp.asarray(j) // WORD_BITS
    s = jnp.asarray(j) % WORD_BITS
    return (m.data[i, w] >> s.astype(jnp.uint32)) & 1


def write_bit(m: BitMatrix, i, j, value) -> BitMatrix:
    w = jnp.asarray(j) // WORD_BITS
    s = (jnp.asarray(j) % WORD_BITS).astype(jnp.uint32)
    old = m.data[i, w]
    new = (old & ~(jnp.uint32(1) << s)) | (jnp.uint32(value) << s)
    return BitMatrix(m.data.at[i, w].set(new), m.ncols)


def shift_columns_left(data: jax.Array, shift_bits: int,
                       out_width: int) -> jax.Array:
    """Shift every row's bitstring down by ``shift_bits`` (dropping the low
    columns), producing ``out_width`` words.  Static shift."""
    sw, sb = divmod(shift_bits, WORD_BITS)
    w = data.shape[1]
    pad = sw + out_width + 1 - w
    if pad > 0:
        data = jnp.pad(data, ((0, 0), (0, pad)))
    lo = data[:, sw : sw + out_width]
    if sb == 0:
        return lo
    hi = data[:, sw + 1 : sw + 1 + out_width]
    return (lo >> np.uint32(sb)) | (hi << np.uint32(WORD_BITS - sb))


def shift_columns_right(data: jax.Array, shift_bits: int,
                        out_width: int) -> jax.Array:
    """Shift every row's bitstring up by ``shift_bits`` (inserting zero low
    columns), producing ``out_width`` words.  Static shift."""
    sw, sb = divmod(shift_bits, WORD_BITS)
    nrows, w = data.shape
    out = jnp.zeros((nrows, out_width), jnp.uint32)
    n_copy = min(w, out_width - sw)
    if n_copy <= 0:
        return out
    if sb == 0:
        return out.at[:, sw : sw + n_copy].set(data[:, :n_copy])
    lo = data << jnp.uint32(sb)
    hi = data >> jnp.uint32(WORD_BITS - sb)
    out = out.at[:, sw : sw + n_copy].set(lo[:, :n_copy])
    n_hi = min(w, out_width - sw - 1)
    if n_hi > 0:
        out = out.at[:, sw + 1 : sw + 1 + n_hi].set(
            out[:, sw + 1 : sw + 1 + n_hi] ^ hi[:, :n_hi])
    return out


def submatrix(m: BitMatrix, r0: int, c0: int, r1: int, c1: int) -> BitMatrix:
    """Copy rows [r0,r1) x cols [c0,c1); arbitrary (static) offsets
    (reference: mzd_submatrix / mzd_init_window)."""
    assert 0 <= r0 <= r1 <= m.nrows and 0 <= c0 <= c1 <= m.ncols
    ncols = c1 - c0
    out_w = width_for(ncols)
    rows = m.data[r0:r1]
    out = shift_columns_left(rows, c0, out_w)
    return mask_padding(BitMatrix(out, ncols))


def stack(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Vertical concatenation [A; B] (reference: mzd_stack)."""
    assert a.ncols == b.ncols
    return BitMatrix(jnp.concatenate([a.data, b.data], axis=0), a.ncols)


def concat(a: BitMatrix, b: BitMatrix) -> BitMatrix:
    """Horizontal concatenation / augmentation [A | B] (reference: mzd_concat)."""
    assert a.nrows == b.nrows
    ncols = a.ncols + b.ncols
    out_w = width_for(ncols)
    out = jnp.zeros((a.nrows, out_w), jnp.uint32)
    out = out.at[:, : a.width].set(a.data)
    b_shifted = shift_columns_right(b.data, a.ncols, out_w)
    return BitMatrix(out ^ b_shifted, ncols)


def row_swap(m: BitMatrix, i, j) -> BitMatrix:
    ri, rj = m.data[i], m.data[j]
    return BitMatrix(m.data.at[i].set(rj).at[j].set(ri), m.ncols)


def col_swap(m: BitMatrix, a, b) -> BitMatrix:
    """Swap columns a and b (reference: mzd_col_swap, mzd.h:325-415).

    Vectorized over rows: pull both bits, XOR-difference, scatter back.
    Works with traced (dynamic) column indices.
    """
    a = jnp.asarray(a)
    b = jnp.asarray(b)
    wa, sa = a // WORD_BITS, (a % WORD_BITS).astype(jnp.uint32)
    wb, sb = b // WORD_BITS, (b % WORD_BITS).astype(jnp.uint32)
    bits_a = (m.data[:, wa] >> sa) & 1
    bits_b = (m.data[:, wb] >> sb) & 1
    diff = bits_a ^ bits_b
    data = m.data.at[:, wa].set(m.data[:, wa] ^ (diff << sa))
    data = data.at[:, wb].set(data[:, wb] ^ (diff << sb))
    return BitMatrix(data, m.ncols)


def density(m: BitMatrix) -> jax.Array:
    """Fraction of one-bits (reference: mzd_density, mzd.c:1792)."""
    per_row = jnp.sum(jax.lax.population_count(m.data), axis=1,
                      dtype=jnp.int32)
    ones = jnp.sum(per_row.astype(jnp.float32))
    return ones / (m.nrows * m.ncols)


def randomize_custom(nrows: int, ncols: int, callback) -> BitMatrix:
    """Fill from a user RNG callback returning 64-bit words, following the
    exact consumption order of mzd_randomize_custom (mzd.c:1287-1300):
    row-major, ceil(ncols/64) words per row, last word masked."""
    w64 = (ncols + 63) // 64
    mask_bits = (ncols - 1) % 64 + 1
    mask_end = (1 << mask_bits) - 1
    # one flat draw preserves the reference's row-major consumption order;
    # the callback itself is the only remaining per-word Python cost
    flat = [int(callback()) & 0xFFFFFFFFFFFFFFFF
            for _ in range(nrows * w64)]
    rows64 = np.array(flat, dtype=np.uint64).reshape(nrows, w64)
    rows64[:, w64 - 1] &= np.uint64(mask_end)
    lo = (rows64 & 0xFFFFFFFF).astype(np.uint32)
    hi = (rows64 >> np.uint64(32)).astype(np.uint32)
    out = np.empty((nrows, 2 * w64), dtype=np.uint32)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    return BitMatrix(jnp.asarray(np.ascontiguousarray(out[:, : width_for(ncols)])), ncols)
