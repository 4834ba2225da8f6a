"""Multi-host execution: 2 processes x 4 virtual CPU devices, Gloo.

A multi-host cluster (BASELINE config 5 spread over several hosts) is
not available to the test suite; this is the software analog: two OS
processes, each owning 4 devices, joined by jax.distributed with Gloo
cross-process collectives.  All assertions live in multihost_worker.py;
this test only orchestrates the processes and checks they both succeed.
"""

import os
import pathlib
import socket
import subprocess
import sys

_WORKER = pathlib.Path(__file__).parent / "multihost_worker.py"


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh(tmp_path):
    port = _free_port()
    env = os.environ.copy()
    env.pop("JAX_PLATFORMS", None)  # workers force CPU via jax.config
    procs = [
        subprocess.Popen(
            [sys.executable, str(_WORKER), str(i), "2", str(port), str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env,
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=540)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and "MULTIHOST_OK" in out, (
            f"worker {i} failed (rc={p.returncode}):\n{out[-4000:]}"
        )
