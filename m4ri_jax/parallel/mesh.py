"""Device mesh utilities.

The reference's only parallelism is OpenMP shared memory (mp.c 2x2 sections,
`omp parallel for` over rows — SURVEY §2 #19).  The replacement here is
SPMD over a jax.sharding.Mesh: matrices are sharded by row blocks and word
(column) blocks, and XLA collectives (NCCL on GPUs) move the panels.  The
cards of one host are joined all to all (NVLink), so every device pair
talks at the same rate and the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh", "make_multihost_mesh", "xor_allgather_reduce"]


def make_mesh(n_devices: int | None = None, axis_names=("x", "y")) -> Mesh:
    """A 2-D mesh as square as possible over the available devices."""
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    rx = int(math.sqrt(n))
    while n % rx:
        rx -= 1
    return Mesh(np.array(devices).reshape(rx, n // rx), axis_names)


def make_multihost_mesh(axis_names=("x", "y"),
                        coordinator: str | None = None,
                        num_processes: int | None = None,
                        process_id: int | None = None) -> Mesh:
    """Mesh spanning multiple hosts.

    Layout discipline: the host dimension becomes the *outer* rows of the
    "x" axis and each host's devices fill the inner "y" columns, so every
    "y"-axis collective stays inside a host (on its all-to-all links) by
    construction.  For dist_mul's SUMMA that means the A row-panel
    all-gather (the larger transfer: each device receives
    ~(ry-1)/ry * m*kw/rx words) stays inside the host, while the B
    column-panel gather along "x" crosses the slower inter-host network
    but moves the smaller volume (~(rx-1)/rx * k*nw/ry words with
    rx = n_hosts << ry).  The 1-D row-sharded factorizations
    (dist_ple/dist_echelon) gather fixed-width panels along the sharded
    axis, so their per-panel inter-host traffic is the panel slice only.
    Call once per process; when the JAX distributed runtime is already
    initialized (e.g. by the launcher) the arguments are ignored.
    Single-process fallback: identical to make_mesh().
    """
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(coordinator_address=coordinator,
                                   num_processes=num_processes,
                                   process_id=process_id)
    devices = jax.devices()
    n_hosts = max(1, getattr(jax, "process_count", lambda: 1)())
    per_host = len(devices) // n_hosts
    if n_hosts == 1:
        return make_mesh(axis_names=axis_names)
    # rows = hosts, columns = devices within a host
    grid = np.array(devices).reshape(n_hosts, per_host)
    return Mesh(grid, axis_names)


def xor_allgather_reduce(x, axis_name: str):
    """XOR all-reduce along a mesh axis.

    psum cannot be used directly (XOR != addition), so we all-gather the
    partial parities and fold locally — the partials are packed words, so
    the gather moves exactly the data a ring XOR-reduce would.
    """
    import jax.numpy as jnp
    gathered = jax.lax.all_gather(x, axis_name)  # (axis_size, ...)
    return jax.lax.reduce(gathered, jnp.uint32(0), jax.lax.bitwise_xor, (0,))
