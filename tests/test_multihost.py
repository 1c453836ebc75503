"""Multi-host (2-process) execution smoke test (VERDICT r4 #6).

The virtual 8-device mesh used everywhere else lives in ONE process; this
test runs the actual process-boundary code path — jax.distributed.initialize,
make_multihost_mesh's host-major layout, and cross-process collectives —
as a real 2-process CPU cluster on localhost (4 virtual devices per
process), asserting mul_dist / mul_dist_ksplit / dist_ple bit-identical to
the single-process engines.  Reference analogue: none (the reference's
multi-processor story is OpenMP-only, mp.c); SURVEY §5 distributed backend.
"""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cluster():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    env.pop("PYTEST_CURRENT_TEST", None)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(pid), "2", coord],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=REPO, env=env) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(
            o or "" for o in outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} rc={p.returncode}:\n{out}"
        assert f"MULTIHOST_OK proc={pid}" in out, f"proc {pid}:\n{out}"
