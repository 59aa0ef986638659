"""Real multi-process validation: 2 jax.distributed processes, each with 4
virtual CPU devices, running the SHARDED Trainer end-to-end over a global
8-device mesh.

This is the analog of the reference's `mpirun -n 2` one-box
topology tests (SURVEY.md §4.5; MPI init ExecutionInfo.cpp:33-75, gradient
Iallreduce Optimizer.cpp:110-119): process boundaries are real (separate
interpreters + a coordinator), gradients psum across them over the
"learners" axis, and both processes must end with identical replicated
parameters.
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_mp_worker.py")


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_procs(n_proc: int, local_devices: int):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = \
        f"--xla_force_host_platform_device_count={local_devices}"
    # the conftest of THIS process forces 8 devices; workers get their own
    procs = [subprocess.Popen(
        [sys.executable, WORKER, coord, str(n_proc), str(pid)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for pid in range(n_proc)]
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
        assert p.returncode == 0, \
            f"worker {pid} failed:\n{out[-3000:]}"
    # every process converged to the SAME replicated parameters and sees
    # the same global replay counters
    results = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("RESULT"):
                _, pid, ck, n = line.split()
                results[int(pid)] = (ck, int(n))
    assert set(results) == set(range(n_proc)), f"missing results: {outs}"
    for pid in range(1, n_proc):
        assert results[0] == results[pid], \
            f"process-divergent state: {results}"


@pytest.mark.slow
def test_two_process_sharded_trainer():
    _run_procs(2, 4)


@pytest.mark.slow
def test_four_process_sharded_trainer():
    """4 jax.distributed processes x 2 devices = the same global 8-device
    mesh: catches coordinator/addressability bugs a 2-process split
    cannot (per-process device locality differs; r2 VERDICT #10)."""
    _run_procs(4, 2)
