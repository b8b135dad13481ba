#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: u32 keys/s of a full-width keys-only ``sort_keys`` (``method=
"auto"``) at 2**28 keys on one GPU, timed with the protocol of the
reference's event-timed soak loop (main.cpp:128-167, unittest.cpp:490-572):
an untimed warm-up (compilation), then ``--reps`` runs, each timed up to
``block_until_ready``. The rate is keys over the median; the quartiles
give the spread. The output is verified in full against the native C++
oracle once per run. Exits non-zero where JAX finds no GPU.

Run: python bench.py [--n N] [--reps R] [--quick] [--verify full|none]
"""

import argparse
import json
import os
import sys

import jax
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import tinyhipradixsort_tpu as thrs  # noqa: E402
from tinyhipradixsort_tpu.utils import native_oracle, profiling  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 28)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--quick", action="store_true", help="16M keys, 5 reps")
    ap.add_argument("--verify", choices=("full", "none"), default="full",
                    help="full: whole output vs the native C++ oracle; "
                         "none: timing only")
    args = ap.parse_args()
    n = (1 << 24) if args.quick else args.n
    reps = 5 if args.quick else args.reps

    profiling.enable_compile_cache()
    rep = profiling.device_report()
    if rep["platform"] != "gpu":
        print(f"bench: needs a GPU; JAX found {rep['platform']}",
              file=sys.stderr)
        sys.exit(2)

    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    xd = jax.device_put(x)
    sort = jax.jit(lambda a: thrs.sort_keys(a, method="auto"))
    q1, med, q3 = profiling.quartiles(profiling.time_fn(sort, xd, reps=reps))

    if args.verify == "full":
        # u32 ascending: key_bits is the identity, so the oracle is a plain
        # stable radix sort of the raw keys
        if not np.array_equal(np.asarray(sort(xd)),
                              native_oracle.native_sort_bits(x)):
            print("bench: output != oracle sort", file=sys.stderr)
            sys.exit(1)

    print(json.dumps({
        "metric": "sort_keys_u32_keys_per_s",
        "value": n / med,
        "unit": "keys/s",
        "n": n,
        "method": "auto",
        "reps": reps,
        "median_s": med,
        "q1_s": q1,
        "q3_s": q3,
        "verified": args.verify,
        "platform": rep["platform"],
        "device_kind": rep["device_kind"],
        "device_count": rep["count"],
        "gpu_name": rep["gpu_name"],
        "power_limit": rep["power_limit"],
    }))


if __name__ == "__main__":
    main()
