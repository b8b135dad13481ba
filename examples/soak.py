"""Infinite benchmark/soak loop — parity with the reference's `main`
(reference: main.cpp:60-209): every iteration regenerates random keys (and
optionally payloads), times the sort, and fully verifies against a CPU
oracle. Ctrl-C to stop.

Usage: python examples/soak.py [--n N] [--pairs] [--dtype u32|u64|f32]
"""

import argparse
import os
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import tinyhipradixsort_tpu as thrs  # noqa: E402
from tinyhipradixsort_tpu.utils import profiling  # noqa: E402

DTYPES = {"u32": np.uint32, "u64": np.uint64, "f32": np.float32,
          "i32": np.int32}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 24)
    ap.add_argument("--pairs", action="store_true")
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="u32")
    ap.add_argument("--iters", type=int, default=0, help="0 = run forever")
    args = ap.parse_args()
    dtype = np.dtype(DTYPES[args.dtype])

    profiling.enable_compile_cache()
    rng = np.random.default_rng()
    it = 0
    while True:
        it += 1
        if dtype.kind == "f":
            keys = rng.standard_normal(args.n).astype(dtype)
        else:
            info = np.iinfo(dtype)
            keys = rng.integers(info.min, info.max, size=args.n, dtype=dtype,
                                endpoint=True)
        kd = jax.device_put(jnp.asarray(keys))
        t0 = time.perf_counter()
        if args.pairs:
            vals = np.arange(args.n, dtype=np.uint32)
            sk, sv = thrs.sort_pairs(kd, jnp.asarray(vals))
            got_k, got_v = np.asarray(sk), np.asarray(sv)
        else:
            got_k = np.asarray(thrs.sort_keys(kd))
        dt = time.perf_counter() - t0
        print(f"iter {it}: {dt*1e3:8.2f} ms ({args.n/dt/1e6:8.1f} Mkeys/s incl transfers)")

        # full oracle verification every iteration (main.cpp:174-202)
        perm = np.argsort(thrs.np_key_bits(keys), kind="stable")
        view = np.uint32 if dtype.itemsize == 4 else np.uint64
        assert np.array_equal(got_k.view(view), keys[perm].view(view)), "keys mismatch"
        if args.pairs:
            assert np.array_equal(got_v, vals[perm]), "payload mismatch"
        if args.iters and it >= args.iters:
            break


if __name__ == "__main__":
    main()
