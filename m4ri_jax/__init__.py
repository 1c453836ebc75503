"""m4ri_jax — a dense linear-algebra engine over GF(2) on JAX.

A from-scratch rebuild of the capabilities of M4RI (the reference C library)
for accelerators: bit-packed matrices as uint32 word arrays in device
memory, GF(2) products on the matrix units (small-integer multiply +
parity), blocked PLE/PLUQ/echelon factorizations whose Schur updates are
matrix products, GPU kernels (Pallas through Triton) for the packed Schur
product and the serial pivot loop, and SPMD scaling over a
jax.sharding.Mesh.
"""

from .core.bitmatrix import (  # noqa: F401
    BitMatrix, zeros, identity, from_numpy, to_numpy, from_packed,
    randomize, randomize_reference, add, equal, is_zero, read_bit,
    write_bit, submatrix, stack, concat, row_swap, col_swap, density,
)
from .core.transpose import transpose as _transpose
from .ops.mul import mul as _mul, addmul as _addmul, mul_naive as _mul_naive
from .utils.hashing import instrument as _dd_instrument

# the public matrix-producing surface is dd-instrumented: with
# utils.hashing.debug_dump(True) every call logs `name: hash`, the
# reference's engine-diffing stream (__M4RI_DD_MZD, debug_dump.h:29-61)
transpose = _dd_instrument("mzd_transpose", _transpose)
mul = _dd_instrument("mzd_mul", _mul)
addmul = _dd_instrument("mzd_addmul", _addmul)
mul_naive = _dd_instrument("mzd_mul_naive", _mul_naive)

__version__ = "0.1.0"

_DD_NAMES = {
    "ple": "mzd_ple", "pluq": "mzd_pluq",
    "echelonize": "mzd_echelonize", "echelonize_pluq": "mzd_echelonize_pluq",
    "top_echelonize": "mzd_top_echelonize_m4ri", "invert": "mzd_inv_m4ri",
    "invert_naive": "mzd_invert_naive",
    "echelonize_naive": "mzd_echelonize_naive",
    "gauss_delayed": "mzd_gauss_delayed",
    "trsm_lower_left": "mzd_trsm_lower_left",
    "trsm_upper_left": "mzd_trsm_upper_left",
    "trsm_lower_right": "mzd_trsm_lower_right",
    "trsm_upper_right": "mzd_trsm_upper_right",
    "trtri_upper": "mzd_trtri_upper", "trtri_lower": "mzd_trtri_lower",
    "solve_left": "mzd_solve_left", "kernel_left": "mzd_kernel_left_pluq",
    "pluq_solve_left": "mzd_pluq_solve_left",
    "mul_m4rm": "mzd_mul_m4rm", "addmul_m4rm": "mzd_addmul_m4rm",
}


def __getattr__(name):
    # Lazy imports for the higher layers to keep import time low.
    if name in ("ple", "pluq", "block_factor"):
        from .models import ple as _m
    elif name in ("echelonize", "echelonize_pluq", "top_echelonize", "rank",
                  "invert", "invert_naive", "echelonize_naive",
                  "gauss_delayed"):
        from .models import echelon as _m
    elif name in ("trsm_lower_left", "trsm_upper_left", "trsm_lower_right",
                  "trsm_upper_right", "trtri_upper", "trtri_lower"):
        from .models import triangular as _m
    elif name in ("solve_left", "kernel_left", "pluq_solve_left"):
        from .models import solve as _m
    elif name in ("mul_m4rm", "addmul_m4rm"):
        from .ops import m4rm as _m
    elif name in ("djb_compile", "djb_apply"):
        from .models import djb as _m
    elif name in ("read_bits", "xor_bits", "and_bits", "clear_bits",
                  "row_add", "row_add_offset", "extract_u", "extract_l",
                  "find_pivot", "set_ui"):
        from .core import bitops as _m
    else:
        raise AttributeError(name)
    fn = getattr(_m, name)
    if name in _DD_NAMES:
        fn = _dd_instrument(_DD_NAMES[name], fn)
    globals()[name] = fn  # cache: later accesses bypass __getattr__
    return fn
