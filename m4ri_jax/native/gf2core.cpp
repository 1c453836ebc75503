// gf2core — native host-side GF(2) kernels for m4ri_jax.
//
// Role (mirrors the reference's C layer in spirit, written from scratch):
//   * an independent oracle for cross-validating the device engine
//     (naive popcount multiply, Gauss elimination, transpose);
//   * fast host-side pack/unpack between dense bytes and uint32 words;
//   * a glibc-random()-compatible stream so reference-identical test
//     vectors can be generated at native speed (reference contract:
//     misc.c:58-71, mzd.c:1270-1280).
//
// Packing convention matches m4ri_jax.core.bitmatrix: column c lives in
// word c/32 at bit c%32 (LSB first).  Exposed with C linkage for ctypes.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------- pack / unpack ----------

void gf2_pack(const uint8_t *dense, uint32_t *packed, int64_t rows,
              int64_t cols) {
  const int64_t width = (cols + 31) / 32;
  std::memset(packed, 0, sizeof(uint32_t) * rows * width);
  for (int64_t i = 0; i < rows; ++i) {
    const uint8_t *src = dense + i * cols;
    uint32_t *dst = packed + i * width;
    for (int64_t c = 0; c < cols; ++c) {
      dst[c >> 5] |= (uint32_t)(src[c] & 1) << (c & 31);
    }
  }
}

void gf2_unpack(const uint32_t *packed, uint8_t *dense, int64_t rows,
                int64_t cols) {
  const int64_t width = (cols + 31) / 32;
  for (int64_t i = 0; i < rows; ++i) {
    const uint32_t *src = packed + i * width;
    uint8_t *dst = dense + i * cols;
    for (int64_t c = 0; c < cols; ++c) {
      dst[c] = (src[c >> 5] >> (c & 31)) & 1;
    }
  }
}

// ---------- naive multiply (popcount parity) ----------
// c[m x nw] = a[m x kw] * b[k x nw]; bt must be the bit-transpose of b
// (n rows x kw words) supplied by the caller.

void gf2_mul_naive(const uint32_t *a, const uint32_t *bt, uint32_t *c,
                   int64_t m, int64_t n, int64_t kw) {
  const int64_t nw = (n + 31) / 32;
  std::memset(c, 0, sizeof(uint32_t) * m * nw);
  for (int64_t i = 0; i < m; ++i) {
    const uint32_t *arow = a + i * kw;
    uint32_t *crow = c + i * nw;
    for (int64_t j = 0; j < n; ++j) {
      const uint32_t *brow = bt + j * kw;
      uint64_t acc = 0;
      for (int64_t w = 0; w < kw; ++w) {
        acc ^= (uint64_t)__builtin_popcount(arow[w] & brow[w]);
      }
      crow[j >> 5] |= (uint32_t)(acc & 1) << (j & 31);
    }
  }
}

// ---------- bit transpose ----------

void gf2_transpose(const uint32_t *a, uint32_t *t, int64_t rows,
                   int64_t cols) {
  const int64_t wa = (cols + 31) / 32;
  const int64_t wt = (rows + 31) / 32;
  std::memset(t, 0, sizeof(uint32_t) * cols * wt);
  for (int64_t i = 0; i < rows; ++i) {
    const uint32_t *src = a + i * wa;
    for (int64_t c = 0; c < cols; ++c) {
      if ((src[c >> 5] >> (c & 31)) & 1) {
        t[c * wt + (i >> 5)] |= (uint32_t)1 << (i & 31);
      }
    }
  }
}

// ---------- in-place row-reduction; returns rank; full -> RREF ----------

int64_t gf2_echelonize(uint32_t *a, int64_t m, int64_t n, int full) {
  const int64_t w = (n + 31) / 32;
  int64_t r = 0;
  for (int64_t c = 0; c < n && r < m; ++c) {
    const int64_t cw = c >> 5;
    const uint32_t cb = (uint32_t)1 << (c & 31);
    int64_t piv = -1;
    for (int64_t i = r; i < m; ++i) {
      if (a[i * w + cw] & cb) { piv = i; break; }
    }
    if (piv < 0) continue;
    if (piv != r) {
      for (int64_t j = 0; j < w; ++j) {
        uint32_t tmp = a[r * w + j];
        a[r * w + j] = a[piv * w + j];
        a[piv * w + j] = tmp;
      }
    }
    const int64_t lo = full ? 0 : r + 1;
    for (int64_t i = lo; i < m; ++i) {
      if (i != r && (a[i * w + cw] & cb)) {
        for (int64_t j = 0; j < w; ++j) a[i * w + j] ^= a[r * w + j];
      }
    }
    ++r;
  }
  return r;
}

// ---------- glibc random() compatible stream (TYPE_3) ----------

// Ring buffer of the trailing 31 values; r[i] = r[i-3] + r[i-31] (mod 2^32),
// output r[i] >> 1, with the first 310 post-init values discarded.
static uint32_t rng_buf[31];
static int rng_idx;  // slot holding r[i-31]

void gf2_srandom(uint32_t seed) {
  uint32_t r[344];
  if (seed == 0) seed = 1;
  int64_t s = seed;
  r[0] = (uint32_t)s;
  for (int i = 1; i < 31; ++i) {
    int64_t hi = s / 127773, lo = s % 127773;
    s = 16807 * lo - 2836 * hi;
    if (s < 0) s += 2147483647;
    r[i] = (uint32_t)s;
  }
  for (int i = 31; i < 34; ++i) r[i] = r[i - 31];
  for (int i = 34; i < 344; ++i) r[i] = r[i - 3] + r[i - 31];
  for (int i = 0; i < 31; ++i) rng_buf[i] = r[313 + i];
  rng_idx = 0;
}

static inline uint32_t glibc_random31(void) {
  const uint32_t v =
      rng_buf[(rng_idx + 28) % 31] + rng_buf[rng_idx];
  rng_buf[rng_idx] = v;
  rng_idx = (rng_idx + 1) % 31;
  return v >> 1;
}

uint64_t gf2_random_word(void) {
  uint64_t a0 = glibc_random31();
  uint64_t a1 = glibc_random31();
  uint64_t a2 = glibc_random31();
  return a0 ^ (a1 << 24) ^ (a2 << 48);
}

// Fill packed rows exactly like mzd_randomize under the current seed:
// row-major, ceil(n/64) 64-bit words per row, last word masked.
void gf2_randomize(uint32_t *packed, int64_t rows, int64_t cols) {
  const int64_t w64 = (cols + 63) / 64;
  const int64_t width = (cols + 31) / 32;
  const int maskbits = (int)((cols - 1) % 64 + 1);
  const uint64_t mask =
      maskbits == 64 ? ~0ULL : ((1ULL << maskbits) - 1);
  for (int64_t i = 0; i < rows; ++i) {
    uint32_t *dst = packed + i * width;
    for (int64_t j = 0; j < w64; ++j) {
      uint64_t v = gf2_random_word();
      if (j == w64 - 1) v &= mask;
      dst[2 * j] = (uint32_t)v;
      if (2 * j + 1 < width) dst[2 * j + 1] = (uint32_t)(v >> 32);
    }
  }
}

}  // extern "C"
