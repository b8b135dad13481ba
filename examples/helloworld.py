"""Canonical 32-key usage example — parity with the reference's helloworld
(reference: helloworld.cpp:9-73: init -> Config -> RadixSort -> sortKeys ->
print). The 'init/compile' steps are just jit tracing."""

import numpy as np
import jax.numpy as jnp

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tinyhipradixsort_tpu as thrs  # noqa: E402
from tinyhipradixsort_tpu.utils import profiling  # noqa: E402


def main():
    profiling.enable_compile_cache()
    rng = np.random.default_rng(42)
    keys = jnp.asarray(rng.integers(0, 2**32, size=32, dtype=np.uint32))

    # functional API (dtype-driven)
    sorted_keys = thrs.sort_keys(keys)

    # class API (reference Config/RadixSort parity)
    rs = thrs.RadixSort(thrs.Config.for_keys(np.uint32))
    sorted_again = rs.sort_keys(keys)

    for i, (a, b) in enumerate(zip(np.asarray(sorted_keys), np.asarray(sorted_again))):
        assert a == b
        print(f"{i:2d}: {a:#010x}")


if __name__ == "__main__":
    main()
