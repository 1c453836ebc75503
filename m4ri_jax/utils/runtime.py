"""Process-level helpers for the entry points (chip_smoke.py, bench.py,
benches/*).  The library itself changes no global JAX setting on import;
an entry point opts in here.

- ``use_compile_cache``: JAX's persistent compilation cache lives where
  ``JAX_COMPILATION_CACHE_DIR`` says when it is set (JAX reads the
  variable itself), otherwise in a fixed ``.jax_cache/`` inside the
  checkout (gitignored; a fixed path, because the path is part of the
  cache key).
- ``CompileClock``: backend compile seconds and cache hits/misses, read
  from JAX's monitoring events, so a run can report its compile time.
- ``card_info``: the card's name and power limit from ``nvidia-smi``, a
  subprocess that never touches JAX.
"""

from __future__ import annotations

import os
import subprocess

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def use_compile_cache() -> str:
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir",
                          os.path.join(ROOT, ".jax_cache"))
    return jax.config.jax_compilation_cache_dir


class CompileClock:
    """Accumulates backend compile time and persistent-cache hits/misses
    for the whole process (listeners cannot be removed, so one instance
    is registered once and phases read differences)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            import jax.monitoring as mon
            self = super().__new__(cls)
            self.compile_s = 0.0
            self.hits = 0
            self.misses = 0

            def on_duration(event, secs, **_):
                if event == "/jax/core/compile/backend_compile_duration":
                    self.compile_s += secs

            def on_event(event, **_):
                if event == "/jax/compilation_cache/cache_hits":
                    self.hits += 1
                elif event == "/jax/compilation_cache/cache_misses":
                    self.misses += 1

            mon.register_event_duration_secs_listener(on_duration)
            mon.register_event_listener(on_event)
            cls._instance = self
        return cls._instance

    def snapshot(self) -> tuple:
        return (self.compile_s, self.hits, self.misses)


def card_info() -> str:
    """'<name>, <power limit>' of GPU 0 per nvidia-smi, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        lines = out.stdout.strip().splitlines()
        if out.returncode or not lines:
            return f"nvidia-smi rc={out.returncode}"
        return lines[0].strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {type(e).__name__}"
