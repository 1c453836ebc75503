"""Statistical benchmark harness (reference analogue: bench/benchmarking.c —
repeat until the mean lies within a +/-accuracy confidence interval at a
chosen confidence level, bounded by min/max counts and max time).

Every timed call must block until its work is done (``block_until_ready``
on the result): JAX returns before the device finishes.  The per-op
benches call ``start`` first, which keeps the compile cache in place and
refuses to measure without a GPU.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

# z-values for the reference's confidence menu (benchmarking.c:24-52)
_Z = {80: 1.282, 90: 1.645, 95: 1.960, 98: 2.326, 99: 2.576}


@dataclasses.dataclass
class Result:
    mean: float
    std: float
    ci: float
    samples: int

    def line(self, label: str, extra: str = "") -> str:
        return (f"{label}: mean {self.mean:.6f} s, sd {self.std:.6f}, "
                f"ci +/-{self.ci * 100:.1f}%, n={self.samples}{extra}")


_DEVICE = None


def start() -> dict:
    """Entry-point set-up for the per-op benches: compile cache in place,
    a GPU present (no CPU fallback), and the device recorded for every
    emitted line."""
    global _DEVICE
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    from m4ri_jax.utils import runtime
    import jax
    runtime.use_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU (JAX platform {dev.platform!r})")
    _DEVICE = {"platform": dev.platform, "kind": dev.device_kind,
               "count": len(jax.devices()), "card": runtime.card_info()}
    return _DEVICE


def run_timed(fn, *, min_samples: int = 3, max_samples: int = 30,
              accuracy: float = 0.05, confidence: int = 95,
              max_time: float = 120.0) -> Result:
    """Call fn() repeatedly; fn must block until its work is done and return
    nothing (or the value to discard)."""
    z = _Z[confidence]
    times = []
    t_start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        n = len(times)
        if n >= min_samples:
            m = float(np.mean(times))
            s = float(np.std(times, ddof=1)) if n > 1 else 0.0
            half = z * s / np.sqrt(n) / m if m > 0 else 0.0
            if half <= accuracy or n >= max_samples or \
                    time.perf_counter() - t_start > max_time:
                return Result(m, s, half, n)


def xla_counters(jitted_fn, *args, **kwargs):
    """Per-op hardware-counter analogue (reference: PAPI around each
    bench op, bench_multiplication.c:147-158, configure.ac:159-196):
    XLA's compiled cost analysis gives the program's model FLOPs and
    bytes accessed; dividing by the measured wall yields achieved
    bytes/s, emitted next to the Tbit-op/s."""
    try:
        ca = jitted_fn.lower(*args, **kwargs).compile().cost_analysis()
        if isinstance(ca, (list, tuple)):
            ca = ca[0] if ca else {}
        return {"flops": float(ca.get("flops", 0.0)),
                "bytes": float(ca.get("bytes accessed", 0.0))}
    except Exception:
        return {}


def emit(metric: str, value: float, unit: str, wall: float,
         vs_baseline: float | None = None,
         bitops: float | None = None,
         counters: dict | None = None,
         counter_scale: float = 1.0) -> None:
    """One JSON line per program.  ``bitops`` is the effective GF(2)
    bit-operation count of the measured op (2 per AND+XOR term, the
    reference's cc/n^x normalization, bench_multiplication.c:147-158);
    when given, the record reports the achieved Tbit-op/s.  ``counters``
    (from xla_counters, divided by ``counter_scale`` ops per program)
    adds achieved device-memory GB/s."""
    import json
    rec = {"metric": metric, "value": value, "unit": unit, "wall_s": wall,
           "device": _DEVICE}
    if vs_baseline is not None:
        rec["vs_baseline"] = vs_baseline
    if bitops is not None and wall > 0:
        rec["tbitops"] = bitops / wall / 1e12
    if counters and wall > 0:
        b = counters.get("bytes", 0.0) / max(counter_scale, 1e-12)
        if b:
            rec["gbytes_s"] = b / wall / 1e9
    print(json.dumps(rec))


def profiled(fn, trace_dir: str | None = None):
    """Wrap ``fn`` with a jax.profiler trace when a directory is given (or
    M4RI_JAX_PROFILE_DIR is set) — the analogue of the reference's PAPI
    counter hooks (bench/benchmarking.c)."""
    import os
    trace_dir = trace_dir or os.environ.get("M4RI_JAX_PROFILE_DIR")
    if not trace_dir:
        return fn

    def wrapped(*a, **kw):
        import jax
        with jax.profiler.trace(trace_dir):
            return fn(*a, **kw)

    return wrapped
