"""Batched and segmented sorting examples (extensions).

The reference library sorts one flat array per call; common production
workloads sort many independent arrays (top-k per query, per-page term
lists). Two native forms here:

* 2-D keys: every row sorts independently.
* ``segment_ids``: stable order by ``(segment_id, key)`` — the
  cub::DeviceSegmentedRadixSort analogue, with ``segment_ids_from_offsets``
  accepting CUB-style offset arrays.
"""

import os
import sys

import numpy as np
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tinyhipradixsort_tpu as thrs  # noqa: E402
from tinyhipradixsort_tpu.utils import profiling  # noqa: E402


def main():
    profiling.enable_compile_cache()
    rng = np.random.default_rng(0)

    # --- batched: 8 independent rows of 1024 keys -------------------------
    rows = rng.integers(0, 1000, size=(8, 1024), dtype=np.uint32)
    sorted_rows = thrs.sort_keys(jnp.asarray(rows))
    assert (np.asarray(sorted_rows) == np.sort(rows, axis=1)).all()
    print("batched: 8x1024 rows sorted independently")

    # batched pairs: payloads share the (B, n) leading axes
    payload = np.broadcast_to(np.arange(1024, dtype=np.uint32), (8, 1024))
    k, v = thrs.sort_pairs(jnp.asarray(rows), jnp.asarray(payload.copy()))
    print("batched pairs: payload rows permuted with their keys")

    # --- segmented: CUB-style offsets ------------------------------------
    n = 10000
    keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    offsets = np.array([0, 1000, 3500, 9000, n], np.int32)
    ids = thrs.segment_ids_from_offsets(jnp.asarray(offsets), n)
    out = thrs.sort_keys(jnp.asarray(keys), segment_ids=ids)
    out = np.asarray(out)
    for a, b in zip(offsets[:-1], offsets[1:]):
        assert (out[a:b] == np.sort(keys[a:b])).all()
    print(f"segmented: {len(offsets)-1} segments each sorted in place")


if __name__ == "__main__":
    main()
