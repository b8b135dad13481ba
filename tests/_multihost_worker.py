"""Worker process for the two-process jax.distributed smoke test.

Run as: python tests/_multihost_worker.py <coord_addr> <num_procs> <pid> <n>

Each process initializes the real process group (`multihost.initialize` —
the same bootstrap it performs across GPU hosts), builds the global mesh
spanning both processes' devices, runs `psort_keys` on a globally-sharded
array, and verifies its local output shards bit-exactly against the numpy
oracle. Exits non-zero on any failure.
"""

import os
import sys

# force CPU with two devices before any JAX call
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=2")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402

from tinyhipradixsort_tpu.utils import profiling  # noqa: E402

profiling.enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)

# safe pre-bootstrap: the package defers every device-touching constant
# (a module-level jnp scalar would initialize the XLA backend and make
# jax.distributed.initialize refuse to run)
from tinyhipradixsort_tpu.parallel import multihost  # noqa: E402


def main():
    coord, nprocs, pid, n = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                             int(sys.argv[4]))
    multihost.initialize(coordinator_address=coord, num_processes=nprocs,
                         process_id=pid)
    assert jax.process_count() == nprocs, jax.process_count()

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec

    from tinyhipradixsort_tpu import psort_keys
    from tinyhipradixsort_tpu.parallel import psort

    mesh = multihost.global_sort_mesh()
    P_ = mesh.shape[psort.AXIS]
    assert P_ == nprocs * jax.local_device_count()

    rng = np.random.default_rng(7)
    host_keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    sharding = NamedSharding(mesh, PartitionSpec(psort.AXIS))
    keys = jax.make_array_from_callback(
        (n,), sharding, lambda idx: host_keys[idx])

    out = psort_keys(keys, mesh=mesh)
    expect = np.sort(host_keys, kind="stable")

    # each process checks the shards it addresses locally
    nchecked = 0
    for shard in out.addressable_shards:
        (sl,) = shard.index
        np.testing.assert_array_equal(np.asarray(shard.data), expect[sl])
        nchecked += 1
    assert nchecked > 0
    print(f"proc {pid}: ok ({nchecked} local shards, P={P_}, n={n})")


if __name__ == "__main__":
    main()
