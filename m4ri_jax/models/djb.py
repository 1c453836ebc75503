"""DJB "optimizing linear maps mod 2" (reference analogue: djb.[ch], a port
of Bernstein's sort1.cpp — http://binary.cr.yp.to/linearmod2.html).

``djb_compile(A)`` turns a fixed m x n GF(2) matrix into a straight-line
XOR program with heuristically (m*n)/(log m - loglog m) operations;
``djb_apply`` evaluates y = A*x for a batch of inputs.

Algorithm (same as the reference, djb.c:110-140): keep the output rows in a
max-heap ordered by reverse-lexicographic row value; walk columns from the
highest down; when the largest row has a 1 in the current column, either
cancel it against the second-largest row (recording "target ^= target'"), or
clear the bit (recording "target ^= input[col]").  Replaying the record in
reverse evaluates the map.

Compilation is a host-side (numpy) step, exactly as the reference's is a CPU
step; on an accelerator the *application* of a fixed map at scale is better
served by the matrix product (ops/mul.py) — ``djb_apply`` exists for API parity and for
genuinely sparse/structured maps where the XOR count is tiny.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np

from ..core.bitmatrix import BitMatrix

SOURCE_INPUT = 0   # reference: source_source (reads the input vector)
SOURCE_OUTPUT = 1  # reference: source_target (reads another output row)


@dataclasses.dataclass
class DjbProgram:
    nrows: int
    ncols: int
    target: list
    source: list
    srctyp: list

    @property
    def length(self) -> int:
        return len(self.target)


def _revlex_ge(rows: np.ndarray, a: int, b: int) -> bool:
    """rows[a] >= rows[b] in reverse-lex word order (djb.c:20-28)."""
    ra, rb = rows[a], rows[b]
    for j in range(rows.shape[1] - 1, -1, -1):
        if ra[j] < rb[j]:
            return False
        if ra[j] > rb[j]:
            return True
    return True


class _LiveHeap:
    """Max-heap of row indices compared against the *current* row contents
    (the reference heap does the same: invariants are restored at push/pop
    after each mutation)."""

    def __init__(self, rows: np.ndarray):
        self.rows = rows
        self.data: list[int] = []

    def push(self, value: int) -> None:
        d = self.data
        d.append(value)
        i = len(d) - 1
        while i:
            parent = (i - 1) >> 1
            if _revlex_ge(self.rows, d[parent], value):
                break
            d[i] = d[parent]
            i = parent
        d[i] = value

    def front(self) -> int:
        return self.data[0]

    def pop(self) -> int:
        d = self.data
        top = d[0]
        temp = d.pop()
        if not d:
            return top
        i = 0
        while True:
            swap = 2 * i + 1
            if swap >= len(d):
                break
            other = swap + 1
            if other < len(d) and _revlex_ge(self.rows, d[other], d[swap]):
                swap = other
            if _revlex_ge(self.rows, temp, d[swap]):
                break
            d[i] = d[swap]
            i = swap
        d[i] = temp
        return top


def djb_compile(a: BitMatrix) -> DjbProgram:
    rows = np.ascontiguousarray(np.asarray(a.data)).copy()
    m, n = a.nrows, a.ncols
    prog = DjbProgram(m, n, [], [], [])
    heap = _LiveHeap(rows)
    for i in range(m):
        heap.push(i)

    def read_bit(i, c):
        return (rows[i, c >> 5] >> (c & 31)) & 1

    while n > 0:
        if read_bit(heap.front(), n - 1) == 0:
            n -= 1
            continue
        temp = heap.pop()
        if m >= 2 and heap.data and read_bit(heap.front(), n - 1):
            # cancel against the second-largest row:
            # row[temp] ^= row[front]  (mzd_row_add(A, front, temp))
            rows[temp] ^= rows[heap.front()]
            prog.target.append(temp)
            prog.source.append(heap.front())
            prog.srctyp.append(SOURCE_OUTPUT)
        else:
            rows[temp, (n - 1) >> 5] &= ~np.uint32(1 << ((n - 1) & 31))
            prog.target.append(temp)
            prog.source.append(n - 1)
            prog.srctyp.append(SOURCE_INPUT)
        heap.push(temp)
    return prog


def djb_apply(prog: DjbProgram, v: BitMatrix) -> BitMatrix:
    """W = A * V by replaying the program in reverse (djb.c:142-153).
    V has ncols(A) rows; W gets nrows(A) rows."""
    assert v.nrows == prog.ncols
    vd = np.asarray(v.data)
    w = np.zeros((prog.nrows, vd.shape[1]), np.uint32)
    tg = np.asarray(prog.target, np.int64)
    src = np.asarray(prog.source, np.int64)
    inp = np.asarray(prog.srctyp, np.int64) == SOURCE_INPUT
    # Batched replay: maximal runs whose heap sources are untouched by
    # in-batch targets execute as one gather + one scatter-XOR (order
    # within a batch is irrelevant for pure XOR accumulation) instead of
    # one numpy row op per instruction.
    i = prog.length - 1
    while i >= 0:
        touched = set()
        j = i
        while j >= 0:
            if not inp[j] and src[j] in touched:
                break
            touched.add(int(tg[j]))
            j -= 1
        sl = slice(j + 1, i + 1)
        s = src[sl]
        rows = np.where(inp[sl, None],
                        vd[np.clip(s, 0, vd.shape[0] - 1)],
                        w[np.clip(s, 0, w.shape[0] - 1)])
        np.bitwise_xor.at(w, tg[sl], rows)
        i = j
    return BitMatrix(jnp.asarray(w), v.ncols)
