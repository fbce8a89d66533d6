"""2-process multi-host smoke test (SURVEY.md §2.10 distributed-backend
row).

Spawns two OS processes joined through the jax.distributed coordinator,
each owning 4 virtual CPU devices, running the same SPMD sharded
Monte-Carlo sweep over one global 8-device ``dp`` axis — the program shape
of a sweep over several GPU hosts. The workers themselves assert the
global psum reductions; this test checks both exit cleanly.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_sharded_sweep():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.pop("XLA_FLAGS", None)  # worker sets its own device count
        env.update(CIMPC_COORDINATOR=f"127.0.0.1:{port}",
                   CIMPC_NUM_PROCESSES="2", CIMPC_PROCESS_ID=str(pid),
                   JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(
            [sys.executable, _WORKER], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=560)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"MULTIHOST_OK pid={pid}" in out, out
