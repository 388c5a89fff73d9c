"""Multi-process ("multi-host") runtime test.

Spawns TWO python processes that join one JAX distributed runtime over
localhost (2 virtual CPU devices each -> a global 2x2 grid) and run the
distributed Cholesky with per-shard ``from_callback`` construction — the
single-machine analog of the reference's ``mpiexec -n N`` MPI testing
(``cmake/DLAF_AddTest.cmake:151-156``; multi-node is the reference's
raison d'etre, ``communication/init.h:20-35``).

Marked ``multihost`` (and slow): run explicitly with
``pytest -m multihost tests/test_multihost.py``; also included in the slow
lane. Skipped on the GPU lane (needs its own CPU-only subprocesses).
"""
import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.multihost
@pytest.mark.slow
def test_two_process_distributed_cholesky():
    port = _free_port()
    worker = os.path.join(os.path.dirname(__file__), "multihost_worker.py")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)  # the worker sets its own config
    procs = [
        subprocess.Popen(
            [sys.executable, worker, str(i), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=480)
            outs.append(out.decode())
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" +
                    "\n".join(o for o in outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"[proc {i}] OK" in out, out
