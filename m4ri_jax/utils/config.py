"""Hardware-derived tuning configuration.

The reference library derives every algorithmic cutoff from CPU cache sizes
detected at configure time (reference: configure.ac:198-219 writes the
detected L1/L2/L3 into m4ri_config.h, and misc.h:569-599 / strassen.h:133-135
/ ple.h:40 turn them into cutoffs).  Here ``get_config()`` inspects the JAX
backend once — platform, device kind, device memory — and derives the
analogous knobs: block sizes bounding the unpacked/int32 intermediates of the
plain XLA product, panel/window sizes for the factorization, and the
Strassen crossover.  Every field can be overridden with an
``M4RI_JAX_<FIELD>`` environment variable (the reference analogue of
re-running configure with explicit cache sizes).

All sizes are in *bits* (matrix dimensions) unless noted.
"""

from __future__ import annotations

import dataclasses
import functools
import os

# Packed word width.  32-bit words are the widest unsigned integer every
# JAX backend handles natively without x64 mode; the golden vectors and
# the native oracle (native/gf2core.cpp) are laid out on this word size.
# The reference uses 64 (misc.h:87).
WORD_BITS = 32


@dataclasses.dataclass(frozen=True)
class Config:
    # Panel width for blocked PLE / echelonization (reference analogue:
    # kk = 6*k Gray-code round width, brilliantrussian.c:642-647).
    panel_width: int = 512
    # Block size for the product k-dimension when the operands are too
    # large to unpack at once (reference analogue: __M4RI_MUL_BLOCKSIZE,
    # mzd.h:59 — babystep/giantstep blocking to keep tables L2 resident).
    mul_block_k: int = 8192
    # Row-block size bounding the int32 product intermediate in memory.
    mul_block_m: int = 8192
    # Below this dimension, use one fused matmul with no blocking.
    mul_block_threshold: int = 8192
    # Strassen-Winograd crossover (reference: __M4RI_STRASSEN_MUL_CUTOFF =
    # MIN(sqrt(4*L3), 4096), strassen.h:133-135).
    strassen_cutoff: int = 8192
    # Density crossover at which M4RI echelonization switches to PLUQ
    # (reference: echelonform.h:37, threshold 0.15).
    echelon_density_crossover: float = 0.15
    # Strassen recursion depth cap (compile size grows 7^levels).
    strassen_max_levels: int = 2
    # A third Strassen level engages at min-dim >= this.
    strassen_depth3_min: int = 65536
    # Panels per aggregated block in the PLE sweep (reference analogue:
    # the PLE recursion updating only the trailing quadrant,
    # ple.c:122-127).  Per-panel Schur updates touch only the current
    # block's column slab; one deep aggregated update per block carries
    # the trailing columns.  1 = flat sweep (full-width per-panel
    # updates); the blocked path is bit-identical.
    ple_block_panels: int = 1
    # Row-window height for the panel factorization's sequential pivot loop
    # (models/ple.py).  The canonical pivot always lies in the first
    # `window` active rows unless the window goes rank-deficient, which is
    # detected exactly and falls back to a full-height panel sweep; a
    # margin of rows over the panel width (64 by default, 256 on the GPU,
    # where the pivot kernel pays for a power-of-two window anyway) keeps
    # the serial loop small while making the fallback vanishingly rare for
    # generic inputs — and exact when it does fire.
    panel_window: int = 576
    # Provenance of the derived values ("gpu:<kind>", "cpu", "default").
    derived_from: str = "default"


def _env_overrides(cfg: Config) -> Config:
    updates = {}
    for f in dataclasses.fields(Config):
        raw = os.environ.get(f"M4RI_JAX_{f.name.upper()}")
        if raw is None:
            continue
        if f.type in ("int", int):
            updates[f.name] = int(raw)
        elif f.type in ("bool", bool):
            updates[f.name] = raw.lower() in ("1", "true", "yes", "on")
        elif f.type in ("float", float):
            updates[f.name] = float(raw)
        else:
            updates[f.name] = raw
    return dataclasses.replace(cfg, **updates) if updates else cfg


def gpu_config(kind: str, bytes_limit: int) -> Config:
    """GPU derivation from the device's memory budget alone.

    The plain XLA product materializes an int32 product of bm x n words
    per row block plus the unpacked int8 operands; the block edge is the
    largest power of two (capped at 16384) whose bm x bm int32 block
    stays within 1/16 of the budget, which leaves room for Strassen's
    temporaries and the caller's operands.  Strassen recurses down to
    half a block, so each leaf product is one unblocked dot.

    The pivot-loop kernel (ops/gpu_panel.py) keeps its whole window in
    registers, padded to a power-of-two row count, and its per-column
    cost grows with the window: a 256-bit panel (2 x 8 words of panel
    and multiplier bits) on a 512-row window costs half as much per
    column as a 512-bit panel on a 576-row window (padded to 1024 rows),
    and wins end to end.  So the panel is 256 bits at every size, and
    the window takes all 512 rows the kernel pays for."""
    blk = 1024
    while blk < 16384 and (2 * blk) ** 2 * 4 * 16 <= bytes_limit:
        blk *= 2
    return Config(mul_block_k=blk, mul_block_m=blk, mul_block_threshold=blk,
                  strassen_cutoff=blk // 2, panel_width=256, panel_window=512,
                  derived_from=f"gpu:{kind}")


def _derive() -> Config:
    """Inspect the backend (reference analogue: configure-time cache
    detection) and pick block sizes so the plain XLA product's transient
    int32 block plus unpacked operands stay a small fraction of device
    memory."""
    try:
        import jax
        backend = jax.default_backend()
        dev = jax.devices()[0]
        kind = getattr(dev, "device_kind", backend) or backend
    except Exception:  # pragma: no cover - no backend at all
        return Config()
    if backend == "gpu":
        stats = dev.memory_stats() or {}
        return gpu_config(kind, int(stats["bytes_limit"]))
    # CPU (tests): smaller fused products
    return Config(mul_block_k=4096, mul_block_m=4096,
                  mul_block_threshold=4096, strassen_cutoff=4096,
                  derived_from="cpu")


@functools.lru_cache(maxsize=1)
def get_config() -> Config:
    return _env_overrides(_derive())
