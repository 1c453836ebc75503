"""Worker for the 2-process multi-host smoke test (VERDICT r4 #6).

Launched by tests/test_multihost.py (and benches/multihost_smoke.py) as
``python tests/multihost_worker.py <pid> <nproc> <coordinator>`` with
JAX_PLATFORMS=cpu and 4 virtual devices per process: exercises
jax.distributed.initialize + make_multihost_mesh's host-major layout and
runs mul_dist / mul_dist_ksplit / dist_ple over the real process
boundary, asserting bit-identity with the single-process engines.
"""

import os
import sys

pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=4").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402
from jax.experimental import multihost_utils  # noqa: E402

import m4ri_jax as m4  # noqa: E402
from m4ri_jax.parallel.mesh import make_multihost_mesh  # noqa: E402
from m4ri_jax.parallel.dist_mul import mul_dist, mul_dist_ksplit  # noqa: E402
from m4ri_jax.parallel.dist_ple import dist_ple  # noqa: E402
from m4ri_jax.models.ple import ple  # noqa: E402


def log(msg):
    print(f"[proc {pid}] {msg}", flush=True)


mesh = make_multihost_mesh(coordinator=coord, num_processes=nproc,
                           process_id=pid)
assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc
# host-major layout: outer "x" rows = hosts, inner "y" = local devices
assert dict(mesh.shape) == {"x": nproc, "y": 4}, dict(mesh.shape)
for h in range(nproc):
    assert all(d.process_index == h for d in mesh.devices[h]), \
        "mesh rows must be host-major"
log(f"mesh OK {dict(mesh.shape)}")


def replicated(local_bm):
    """Lift a process-local BitMatrix to a fully-replicated global one
    (every process holds the same full copy — how a real multi-host
    launcher feeds identical host data into the SPMD engines)."""
    x = np.asarray(local_bm.data)
    arr = jax.make_array_from_callback(
        x.shape, NamedSharding(mesh, P()), lambda idx: x[idx])
    return m4.BitMatrix(arr, local_bm.ncols)


def gathered(bm):
    """Full numpy copy of a (possibly sharded) global BitMatrix."""
    return np.asarray(
        multihost_utils.process_allgather(bm.data, tiled=True))


rng = np.random.default_rng(42)  # same seed on every process
a_np = (rng.random((192, 160)) < 0.5).astype(np.uint8)
b_np = (rng.random((160, 136)) < 0.5).astype(np.uint8)

A_loc, B_loc = m4.from_numpy(a_np), m4.from_numpy(b_np)
A, B = replicated(A_loc), replicated(B_loc)

want_mul = np.asarray(m4.from_numpy(
    (a_np.astype(np.int64) @ b_np.astype(np.int64) % 2).astype(np.uint8)).data)

C = mul_dist(A, B, mesh)
np.testing.assert_array_equal(gathered(C), want_mul, err_msg="mul_dist")
log("mul_dist bit-identical")

C2 = mul_dist_ksplit(A, B, mesh)
np.testing.assert_array_equal(gathered(C2), want_mul,
                              err_msg="mul_dist_ksplit")
log("mul_dist_ksplit bit-identical")

# dist_ple across the process boundary vs the single-chip engine run
# process-locally; canonical pivot order makes them bit-comparable.
p_np = (np.random.default_rng(7).random((180, 96)) < 0.5).astype(np.uint8)
p_np[:40] = 0  # push pivots past the first window (slow-branch coverage)
M_ref, P_ref, Q_ref, r_ref = ple(m4.from_numpy(p_np))

Md, Pd, Qd, rd = dist_ple(replicated(m4.from_numpy(p_np)), mesh)
assert int(rd) == int(r_ref), (int(rd), int(r_ref))
np.testing.assert_array_equal(
    multihost_utils.process_allgather(Pd, tiled=True), np.asarray(P_ref))
np.testing.assert_array_equal(
    multihost_utils.process_allgather(Qd, tiled=True), np.asarray(Q_ref))
np.testing.assert_array_equal(gathered(Md), np.asarray(M_ref.data),
                              err_msg="dist_ple body")
log("dist_ple bit-identical (rank, P, Q, body)")

print(f"MULTIHOST_OK proc={pid}", flush=True)
