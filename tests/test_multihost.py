"""2-process x 4-virtual-device multihost distributed-BA test.

Spawns two real Python processes that ``jax.distributed.initialize``
against a local coordinator, build a global 8-device CPU mesh, and run the
point-sharded / camera-psum bundle adjustment; each worker asserts the
result matches the single-process solver (tests/multihost_worker.py).

This is the framework's multi-host path (SURVEY.md §5.8 / BASELINE
config 5) exercised without multi-host hardware.
"""

import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_ba():
    port = _free_port()
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "multihost_worker.py")

    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env["PPSFM_COORDINATOR"] = f"127.0.0.1:{port}"
        env["PPSFM_NUM_PROCESSES"] = "2"
        env["PPSFM_PROCESS_ID"] = str(pid)
        env.pop("XLA_FLAGS", None)
        procs.append(subprocess.Popen(
            [sys.executable, worker], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"process {pid} output:\n{out}"
