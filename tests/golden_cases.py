"""Golden vectors captured from the reference binary.

``tests/data/golden_reference.jsonl`` was captured by compiling the
reference M4RI library (gcc -O3 -march=native) and running
``tests/data/golden_capture.c``: for seeded inputs (srandom(17),
mzd_randomize draw order documented per case) it records the full P/Q
swap arrays of ``mzd_ple`` / ``mzd_pluq`` (tests/test_ple.c:6-43 pins the
same reconstruction contract), the RREF hash of ``mzd_echelonize``, and
``mzd_mul`` product hashes (tests/test_random.c:33-62 fixes the RNG
stream).  ``check_case`` rebuilds the identical input via the bit-exact
glibc stream mirror (m4ri_jax/utils/rng.py), runs the operation on the default
device, and raises AssertionError if the rank, the pivot order (swap
arrays), or any output bit diverges from the reference binary.  The test
suite (tests/test_golden.py) and the GPU smoke run (chip_smoke.py) share
it.

Hash: FNV-1a 64 over the dense bits row-major, one byte 0/1 per bit
(layout independent; identical code in golden_capture.c).
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

DATA = (pathlib.Path(__file__).resolve().parent / "data"
        / "golden_reference.jsonl")

_FNV_OFF = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def fnv1a_bits(dense: np.ndarray) -> str:
    """FNV-1a 64 over row-major bits, matching golden_capture.c."""
    h = _FNV_OFF
    with np.errstate(over="ignore"):
        for b in dense.reshape(-1).astype(np.uint64):
            h = (h ^ b) * _FNV_PRIME
    return f"{int(h):016x}"


def load_cases(op: str | None = None) -> list[dict]:
    recs = [json.loads(l) for l in DATA.read_text().splitlines()]
    return [r for r in recs if op is None or r["op"] == op]


def case_id(rec: dict) -> str:
    if rec["op"] == "mul":
        return f"{rec['m']}x{rec['k']}x{rec['n']}"
    return f"{rec['kind']}-{rec['m']}x{rec['n']}"


def build_input(rec: dict):
    """Rebuild the case input with the reference's exact draw order."""
    from m4ri_jax.core.bitmatrix import BitMatrix
    from m4ri_jax.ops.mul import mul
    from m4ri_jax.utils.rng import GlibcRandom, reference_random_data
    if rec["k"]:
        rng = GlibcRandom(17)
        b = reference_random_data(rec["m"], rec["k"], rng=rng)
        c = reference_random_data(rec["k"], rec["n"], rng=rng)
        return mul(BitMatrix(np.asarray(b), rec["k"]),
                   BitMatrix(np.asarray(c), rec["n"]))
    data = reference_random_data(rec["m"], rec["n"], seed=17)
    return BitMatrix(np.asarray(data), rec["n"])


def check_case(rec: dict) -> None:
    """Run one golden case; AssertionError on any divergence."""
    from m4ri_jax.core.bitmatrix import BitMatrix, to_numpy
    from m4ri_jax.models.echelon import echelonize
    from m4ri_jax.models.ple import ple, pluq
    from m4ri_jax.ops.mul import mul
    from m4ri_jax.utils.rng import GlibcRandom, reference_random_data
    op = rec["op"]
    if op == "mul":
        rng = GlibcRandom(17)
        a = reference_random_data(rec["m"], rec["k"], rng=rng)
        b = reference_random_data(rec["k"], rec["n"], rng=rng)
        A = BitMatrix(np.asarray(a), rec["k"])
        B = BitMatrix(np.asarray(b), rec["n"])
        assert fnv1a_bits(to_numpy(A)) == rec["a_hash"], "RNG stream (A)"
        assert fnv1a_bits(to_numpy(B)) == rec["b_hash"], "RNG stream (B)"
        assert fnv1a_bits(to_numpy(mul(A, B))) == rec["out_hash"], \
            "product bits"
        return
    A = build_input(rec)
    if op == "rref":
        E, r = echelonize(A, full=True)
        assert int(r) == rec["rank"], "rank"
        assert fnv1a_bits(to_numpy(E)) == rec["out_hash"], "RREF bits"
        return
    if op == "ple":
        assert fnv1a_bits(to_numpy(A)) == rec["in_hash"], \
            "RNG stream diverged"
    M, P, Q, r = (ple if op == "ple" else pluq)(A)
    assert int(r) == rec["rank"], "rank"
    np.testing.assert_array_equal(np.asarray(P), rec["P"],
                                  err_msg="P swap array (pivot rows)")
    np.testing.assert_array_equal(np.asarray(Q), rec["Q"],
                                  err_msg="Q swap array (pivot columns)")
    assert fnv1a_bits(to_numpy(M)) == rec["out_hash"], "in-place body"
