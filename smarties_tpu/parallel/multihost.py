"""Multi-host initialization helpers.

The reference scales past one node with MPI ranks (ExecutionInfo MPI_Init +
topology solver); the JAX equivalent is jax.distributed: every host runs
the same program, jax.devices() becomes the GLOBAL device list, and the
same "learners" mesh axis (parallel/mesh.py) spans hosts — XLA inserts the
gradient psums as collectives over the interconnect.

Tests emulate several processes on one box with
XLA_FLAGS=--xla_force_host_platform_device_count=N (SURVEY.md section 4,
tests/test_multiprocess.py).

Usage on several hosts (the topology is passed explicitly, e.g. from the
SLURM script of bin/smarties_tpu_submit.py):

    from smarties_tpu.parallel.multihost import init_multihost
    init_multihost("host0:12346", num_processes=2, process_id=rank)
    mesh = make_mesh()            # global mesh over all hosts' devices
    tr = Trainer(..., mesh=mesh, n_envs=per_host_envs * n_hosts, ...)

Each host steps ONLY its own env lanes (shard_map places each shard's
rollout on its local devices); the Trainer host loop runs identically on
every host (same RNG seeds => same pacing decisions; the only host-varying
data, episode logs, is written per-host).
"""
from __future__ import annotations

import jax


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None):
    """jax.distributed.initialize with an explicit topology, or with the
    cluster environment JAX itself detects when none is given. Call before
    any other jax API."""
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes,
                      process_id=process_id)
    jax.distributed.initialize(**kwargs)
    return jax.process_index(), jax.process_count()


def is_coordinator() -> bool:
    return jax.process_index() == 0
