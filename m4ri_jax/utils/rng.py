"""Random matrix generation.

Two generators:

1. ``GlibcRandom`` — a bit-exact reimplementation of glibc's ``random()``
   (TYPE_3 additive-feedback generator) so that ``randomize_reference`` can
   reproduce the exact bit streams the reference produces under
   ``srandom(seed)`` (reference contract: misc.c:58-71 ``m4ri_random_word`` =
   three 31-bit draws combined ``a0 ^ (a1<<24) ^ (a2<<48)``; mzd.c:1270-1280
   ``mzd_randomize`` fills row-major, one 64-bit word at a time, masking the
   final word of each row).  This is what makes cross-validation against the
   reference binary's outputs possible (tests/test_random.c fixes this
   contract with ``srandom(17)``).

2. ``randomize`` — fast on-device fill from ``jax.random`` (threefry).
"""

from __future__ import annotations

import numpy as np


class GlibcRandom:
    """glibc random() / srandom() (TYPE_3, degree 31, separation 3)."""

    def __init__(self, seed: int = 1):
        seed = seed & 0xFFFFFFFF
        if seed == 0:
            seed = 1
        r = np.zeros(344, dtype=np.int64)
        r[0] = seed
        for i in range(1, 31):
            # r[i] = (16807 * r[i-1]) % 2147483647 via Schrage to match the
            # overflow-free computation glibc performs.
            hi, lo = divmod(int(r[i - 1]), 127773)
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += 2147483647
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 3] + r[i - 31]) & 0xFFFFFFFF
        self._r = [int(x) for x in r]
        self._idx = 344  # first 310 outputs after init are discarded

    def random(self) -> int:
        """One 31-bit draw, identical to glibc random()."""
        r = self._r
        i = self._idx
        val = (r[i - 3] + r[i - 31]) & 0xFFFFFFFF
        r.append(val)
        self._idx += 1
        # Bound memory: compact the history occasionally.
        if self._idx > 1 << 16:
            self._r = r[-31:]
            self._idx = 31
        return val >> 1

    def random_word(self) -> int:
        """64-bit word exactly as m4ri_random_word (misc.c:58-71)."""
        a0 = self.random()
        a1 = self.random()
        a2 = self.random()
        return (a0 ^ (a1 << 24) ^ (a2 << 48)) & 0xFFFFFFFFFFFFFFFF

    def random_words(self, count: int) -> np.ndarray:
        return np.array([self.random_word() for _ in range(count)], dtype=np.uint64)


def reference_random_data(nrows: int, ncols: int, seed: int = 17,
                          rng: GlibcRandom | None = None) -> np.ndarray:
    """Packed uint32 data filled exactly like the reference under srandom(seed).

    Reference semantics (mzd.c:1270-1280): row-major; each row consumes
    ceil(ncols/64) 64-bit words; the last word of each row is masked to keep
    only the low ``(ncols-1)%64 + 1`` bits.  We then split each 64-bit word
    into two little-endian 32-bit words to obtain our packing.
    """
    if rng is None:
        rng = GlibcRandom(seed)
    w64 = (ncols + 63) // 64
    mask_bits = (ncols - 1) % 64 + 1
    mask_end = (1 << mask_bits) - 1
    rows64 = np.empty((nrows, w64), dtype=np.uint64)
    for i in range(nrows):
        for j in range(w64 - 1):
            rows64[i, j] = rng.random_word()
        rows64[i, w64 - 1] = rng.random_word() & mask_end
    # Split into 32-bit little-endian halves: word k bits [0,32) -> 2k,
    # bits [32,64) -> 2k+1.  This matches column c -> word c//32, bit c%32.
    lo = (rows64 & 0xFFFFFFFF).astype(np.uint32)
    hi = (rows64 >> np.uint64(32)).astype(np.uint32)
    out = np.empty((nrows, 2 * w64), dtype=np.uint32)
    out[:, 0::2] = lo
    out[:, 1::2] = hi
    width = (ncols + 31) // 32
    return np.ascontiguousarray(out[:, :width])
