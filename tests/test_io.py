"""I/O tests (reference: tests/test_misc.c PNG round-trip, mzd_from_str
usage throughout test_ple.c/test_pluq.c)."""

import numpy as np

import m4ri_jax as m4
from m4ri_jax.utils import io

from conftest import random_dense


def test_from_to_str():
    A = io.from_str(2, 3, "101010")
    np.testing.assert_array_equal(m4.to_numpy(A),
                                  [[1, 0, 1], [0, 1, 0]])
    assert io.to_str(A) == "101010"


def test_jcf_roundtrip(rng, tmp_path):
    a = random_dense(rng, 17, 40, density=0.2)
    A = m4.from_numpy(a)
    path = str(tmp_path / "m.jcf")
    io.to_jcf(A, path)
    B = io.from_jcf(path)
    assert bool(m4.equal(A, B))


def test_png_roundtrip(rng, tmp_path):
    a = random_dense(rng, 33, 70)
    A = m4.from_numpy(a)
    path = str(tmp_path / "m.png")
    io.write_png(A, path)
    B = io.read_png(path)
    assert bool(m4.equal(A, B))


def test_info(rng):
    a = random_dense(rng, 10, 20)
    s = io.info(m4.from_numpy(a), compute_rank=True)
    assert "10 x 20" in s and "rank" in s


def test_to_text():
    A = io.from_str(1, 3, "101")
    assert io.to_text(A) == "[1 1]"


def test_hash_changes(rng):
    from m4ri_jax.utils.hashing import matrix_hash
    a = random_dense(rng, 8, 8)
    h1 = int(matrix_hash(m4.from_numpy(a)))
    b = a.copy()
    b[3, 3] ^= 1
    h2 = int(matrix_hash(m4.from_numpy(b)))
    assert h1 != h2
    # order-sensitive: swapped rows hash differently
    c = a[::-1].copy()
    if not np.array_equal(a, c):
        assert int(matrix_hash(m4.from_numpy(c))) != h1


def test_npz_roundtrip(rng, tmp_path):
    a = random_dense(rng, 33, 100)
    A = m4.from_numpy(a)
    p = str(tmp_path / "m.npz")
    io.save_npz(A, p)
    assert bool(m4.equal(io.load_npz(p), A))


def test_randomize_custom():
    from m4ri_jax.core.bitmatrix import randomize_custom
    from m4ri_jax.utils.rng import GlibcRandom
    g = GlibcRandom(17)
    A = randomize_custom(5, 100, g.random_word)
    B = m4.randomize_reference(5, 100, seed=17)
    assert bool(m4.equal(A, B))


def test_png_all_filters(tmp_path):
    """The reader must accept every PNG scanline filter (0/1/2/3/4) — the
    reference reads arbitrary libpng output (io.c:72-293), which may pick
    any filter per row."""
    import struct
    import zlib
    rng = np.random.default_rng(11)
    bits = (rng.random((10, 70)) < 0.5).astype(np.uint8)
    # hand-roll a PNG applying filter f on row f % 5 (bpp = 1 byte)
    h, w = bits.shape
    stride = (w + 7) // 8
    raws = []
    prev = np.zeros(stride, np.uint8)
    for i in range(h):
        body = np.packbits(1 - bits[i], axis=None)[:stride]
        f = i % 5
        if f == 0:
            enc = body
        elif f == 1:  # Sub
            enc = np.zeros_like(body)
            for j in range(stride):
                left = int(body[j - 1]) if j else 0
                enc[j] = (int(body[j]) - left) & 0xFF
        elif f == 2:  # Up
            enc = (body - prev).astype(np.uint8)
        elif f == 3:  # Average
            enc = np.zeros_like(body)
            for j in range(stride):
                left = int(body[j - 1]) if j else 0
                enc[j] = (int(body[j]) - ((left + int(prev[j])) >> 1)) & 0xFF
        else:  # Paeth
            enc = np.zeros_like(body)
            for j in range(stride):
                a = int(body[j - 1]) if j else 0
                b = int(prev[j])
                c = int(prev[j - 1]) if j else 0
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if (pa <= pb and pa <= pc) else \
                    (b if pb <= pc else c)
                enc[j] = (int(body[j]) - pred) & 0xFF
        prev = body
        raws.append(bytes([f]) + enc.tobytes())

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 1, 0, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(b"".join(raws)))
           + chunk(b"IEND", b""))
    path = tmp_path / "filters.png"
    path.write_bytes(png)
    from m4ri_jax.utils.io import read_png
    got = m4.to_numpy(read_png(str(path)))
    np.testing.assert_array_equal(got, bits)


def test_png_vectorized_012_filters(tmp_path):
    """The {None, Sub, Up} filter set takes the vectorized whole-image
    unfilter (io._png_unfilter_rows_012); adversarial row patterns: a
    leading Up run (no anchor), long Up runs, Sub rows anchoring Up runs."""
    import struct
    import zlib
    rng = np.random.default_rng(23)
    h, w = 37, 190
    bits = (rng.random((h, w)) < 0.5).astype(np.uint8)
    stride = (w + 7) // 8
    # row filters: rows 0-3 Up (leading run), then mixed
    filts = [2, 2, 2, 2] + [(0, 1, 2, 2, 2, 1, 2)[i % 7] for i in range(h - 4)]
    raws = []
    prev = np.zeros(stride, np.uint8)
    for i in range(h):
        body = np.packbits(1 - bits[i], axis=None)[:stride]
        f = filts[i]
        if f == 0:
            enc = body
        elif f == 1:  # Sub
            enc = np.diff(body, prepend=np.uint8(0)).astype(np.uint8)
        else:  # Up
            enc = (body - prev).astype(np.uint8)
        prev = body
        raws.append(bytes([f]) + enc.tobytes())

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload)))

    ihdr = struct.pack(">IIBBBBB", w, h, 1, 0, 0, 0, 0)
    png = (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
           + chunk(b"IDAT", zlib.compress(b"".join(raws)))
           + chunk(b"IEND", b""))
    path = tmp_path / "filters012.png"
    path.write_bytes(png)
    got = m4.to_numpy(io.read_png(str(path)))
    np.testing.assert_array_equal(got, bits)
