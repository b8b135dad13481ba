#!/usr/bin/env python
"""Weak-scaling harness for the distributed sort (BASELINE.json scale axis).

Measures psort_keys throughput at fixed per-chip load while growing the mesh
(1 -> P devices), reporting weak-scaling efficiency
rate(P)/(P * rate(1)). Across hosts run this under
`jax.distributed.initialize`; ``--cpu-mesh N`` runs it on N virtual CPU
devices instead — CPU numbers are only indicative of collective overheads,
never device rates.

Usage: python benchmarks/scaling.py [--per-chip 1M] [--zipf] [--devices 1,2,4,8]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-chip", default="1M")
    ap.add_argument("--zipf", action="store_true")
    ap.add_argument("--devices", default=None)
    ap.add_argument("--cpu-mesh", type=int, default=0,
                    help="force a virtual CPU mesh of this many devices")
    args = ap.parse_args()

    if args.cpu_mesh:
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                                   f" --xla_force_host_platform_device_count={args.cpu_mesh}")
    import jax
    if args.cpu_mesh:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    import tinyhipradixsort_tpu as thrs
    from tinyhipradixsort_tpu.parallel import make_sort_mesh
    from tinyhipradixsort_tpu.parallel.psort import AXIS
    from tinyhipradixsort_tpu.utils import profiling

    profiling.enable_compile_cache()

    sizes = {"256K": 1 << 18, "1M": 1 << 20, "4M": 1 << 22, "16M": 1 << 24,
             "64M": 1 << 26}
    per_chip = sizes[args.per_chip]
    all_devices = jax.devices()
    plist = ([int(p) for p in args.devices.split(",")] if args.devices
             else sorted({1, 2, len(all_devices) // 2, len(all_devices)} - {0}))

    rng = np.random.default_rng(0)
    rows = []
    base_rate = None
    for p in plist:
        if p > len(all_devices):
            continue
        mesh = make_sort_mesh(all_devices[:p])
        n = per_chip * p
        if args.zipf:
            keys = np.minimum(rng.zipf(1.3, size=n), 2**31).astype(np.uint32)
        else:
            keys = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        kd = jax.device_put(jnp.asarray(keys),
                            NamedSharding(mesh, P(AXIS)))
        fn = lambda a: thrs.psort_keys(a, mesh=mesh)
        _, t, _ = profiling.quartiles(profiling.time_fn(fn, kd, reps=3))
        rate = n / t
        if base_rate is None:
            base_rate = rate / p  # per-chip rate at smallest mesh
        eff = rate / (p * base_rate)
        rows.append({"devices": p, "n": n, "median_s": t,
                     "keys_per_s": rate, "weak_scaling_efficiency": eff})
        print(f"P={p:3d} n={n:>12,} {t*1e3:9.1f} ms  {rate/1e6:9.1f} Mkeys/s"
              f"  eff={eff:.2f}", flush=True)

    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "scaling_results.json")
    with open(out, "w") as f:
        json.dump({"per_chip": per_chip, "zipf": args.zipf,
                   "platform": jax.devices()[0].platform,
                   "device_kind": jax.devices()[0].device_kind,
                   "rows": rows}, f, indent=1)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
