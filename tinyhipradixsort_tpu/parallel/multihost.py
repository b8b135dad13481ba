"""Multi-host bootstrap helpers.

The reference has no distributed anything (SURVEY.md §2); across hosts the
process group is JAX's own. These helpers wrap the standard flow so the
distributed sort can run across hosts with one call per process:

    from tinyhipradixsort_tpu.parallel import multihost
    multihost.initialize("host0:1234", num_processes=2, process_id=rank)
    mesh = multihost.global_sort_mesh()
    out = thrs.psort_keys(keys, mesh=mesh)

All collectives in :mod:`.psort` are ordinary XLA collectives under
``shard_map`` (NCCL on GPUs), so they run within a host and across hosts
with no code changes — the mesh device order determines the ring. One
process that drives all devices of a single host needs no initialize.
"""

from __future__ import annotations

import jax

# NOTE: no eager `.psort` import here — psort builds module-level device
# constants, which initializes the XLA backend, and
# ``jax.distributed.initialize`` refuses to run once the backend exists.
# This module must stay importable before process-group bootstrap
# (tests/test_multihost.py exercises the real two-process flow).


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """``jax.distributed.initialize`` with env-driven defaults.

    Pass the coordinator address, process count and process id unless the
    cluster environment provides them. Must be called once per process,
    before any other JAX call (including importing modules that build
    device constants, e.g. :mod:`.psort`).
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_sort_mesh():
    """1-D mesh over every chip in the job (all hosts)."""
    from .psort import make_sort_mesh
    return make_sort_mesh(jax.devices())


def local_sort_mesh():
    """1-D mesh over this host's chips only (single-host runs/tests)."""
    from .psort import make_sort_mesh
    return make_sort_mesh(jax.local_devices())
