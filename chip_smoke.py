#!/usr/bin/env python
"""Smoke run of the sort engine on NVIDIA GPUs, through the public API.

    python chip_smoke.py                # one card: every phase but psort
    python chip_smoke.py --four-cards   # psort on four cards, nothing else

Phases on one card (each prints its line; any failure exits non-zero):

* devices   - platform, device kind and count as JAX reports them, and the
              card's name and power limit as nvidia-smi reports them.
* semantics - sort_keys / sort_pairs / sort_indices over u32, i32, u64,
              i64, f32 and f64 keys in both orders, float specials (NaN
              payloads of both signs, +-inf, -0.0, denormals), stability,
              u128 payloads, bit windows, batched rows and segments, all
              bit-exact against the numpy oracle.
* 16-bit    - f16, bf16, u16 and i16 keys and 16-bit payloads, NaN payloads
              and denormals included.
* main      - the reference's soak workload (160M u32 keys, keys-only and
              u32+u32 pairs, main.cpp:105/158), 2**28 u32 keys and 2**28
              u64 keys + u64 payload, each checked in full against the
              native C++ oracle, with the sort XLA emitted for it and an
              informational rate (not a benchmark number).
* lowering  - which sort XLA emits (CUB radix sort or its own sort kernel)
              for the other public paths.

With --four-cards: the four ``__graft_entry__.dryrun_multichip`` scenarios
on a 1-D mesh of four cards, then psort_keys / psort_pairs on 2**28 zipf
u32 keys (BASELINE.json configs[4] scaled to four cards), checked against
the oracle.

The last line of stdout is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Where JAX finds no GPU the script prints no result and exits 2.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
import traceback

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np

import tinyhipradixsort_tpu as thrs
from tinyhipradixsort_tpu.utils import native_oracle, profiling

KEY_DTYPES = ("uint32", "int32", "uint64", "int64", "float32", "float64")
DTYPES_16 = ("float16", "bfloat16", "uint16", "int16")
ORDERS = ("ascending", "descending")
SEMANTIC_SIZES = (1, 2, 1000, 100003)
SOAK_N = 160_000_000  # reference main.cpp:105
BIG_N = 1 << 28
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


class Checks:
    """Collects bit-exact comparisons; :meth:`done` raises if any failed."""

    def __init__(self):
        self.passed = 0
        self.failed = []

    def equal(self, name, got, want):
        g, w = np.asarray(got), np.asarray(want)
        if (g.shape == w.shape and g.dtype == w.dtype
                and np.array_equal(_bits(g), _bits(w))):
            self.passed += 1
        else:
            self.failed.append(name)

    def raises(self, name, exc, fn):
        try:
            fn()
        except exc:
            self.passed += 1
        else:
            self.failed.append(name)

    def done(self, phase: str) -> str:
        if self.failed:
            raise AssertionError(f"{phase}: {len(self.failed)} of "
                                 f"{len(self.failed) + self.passed} checks "
                                 f"failed: {', '.join(self.failed[:30])}")
        return f"{self.passed} checks bit-exact"


def _bits(a: np.ndarray) -> np.ndarray:
    """Raw bit view: NaN payloads and -0.0 compare exactly."""
    if a.dtype.kind in "ui" or a.dtype == np.bool_:
        return a
    return a.view(f"u{a.dtype.itemsize}")


def _dtype(name: str) -> np.dtype:
    return np.dtype(ml_dtypes.bfloat16 if name == "bfloat16" else name)


def oracle_perm(x, descending=False, start_bit=0, end_bit=None, axis=-1):
    """Stable numpy permutation by the transformed, windowed key bits."""
    bits = thrs.np_key_bits(x, descending=descending)
    nb = np.dtype(x.dtype).itemsize * 8
    end_bit = nb if end_bit is None else end_bit
    if (start_bit, end_bit) != (0, nb):
        u = bits.dtype.type
        bits = (bits >> u(start_bit)) & u((1 << (end_bit - start_bit)) - 1)
    return np.argsort(bits, axis=axis, kind="stable")


def random_keys(rng, dtype, n):
    """Uniform keys; float keys get every special spliced in: NaNs with
    random payloads of both signs, +-inf, both zeros and denormals."""
    dtype = np.dtype(dtype)
    if dtype.kind in "ui":
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, size=n, dtype=dtype,
                            endpoint=True)
    x = (rng.standard_normal(n) * 100).astype(dtype)
    u = x.view(f"u{dtype.itemsize}")
    ut = u.dtype.type
    nbits = dtype.itemsize * 8
    mant = 23 if nbits == 32 else 52
    expo = ut(((1 << (nbits - 1 - mant)) - 1) << mant)
    sign = ut(1 << (nbits - 1))
    payload = rng.integers(1, 1 << mant, size=n, dtype=np.uint64).astype(ut)
    signs = np.where(rng.random(n) < 0.5, sign, ut(0)).astype(ut)
    pick = rng.random(n)
    nan, inf = pick < 0.03, (pick >= 0.03) & (pick < 0.05)
    u[nan] = (expo | payload | signs)[nan]  # NaN payloads, both signs
    u[inf] = (expo | signs)[inf]
    u[(pick >= 0.05) & (pick < 0.08)] = sign  # -0.0
    u[(pick >= 0.08) & (pick < 0.10)] = 0
    den = (pick >= 0.10) & (pick < 0.13)
    u[den] = (payload | signs)[den]  # denormals, both signs
    return x


# ---------------------------------------------------------------------------
# semantics
# ---------------------------------------------------------------------------


def case_keys(chk, rng, dtype, order, sizes=SEMANTIC_SIZES):
    desc = order == "descending"
    for n in sizes:
        x = random_keys(rng, dtype, n)
        want = x[oracle_perm(x, desc)]
        chk.equal(f"keys {dtype} {order} n={n}",
                  thrs.sort_keys(jnp.asarray(x), order=order), want)
        if np.dtype(dtype).kind == "f":
            # zeros_exact=False keeps the documented exact result here
            chk.equal(f"keys {dtype} {order} n={n} zeros_exact=False",
                      thrs.sort_keys(jnp.asarray(x), order=order,
                                     zeros_exact=False), want)


SPECIAL_BITS = {  # NaNs with payloads of both signs, +-inf, +-0, denormals
    4: [0x7F800001, 0x7FC12345, 0xFFC01234, 0xFF800003, 0x7F800000,
        0xFF800000, 0x00000000, 0x80000000, 0x00000001, 0x807FFFFF,
        0x7F7FFFFF, 0x40600000, 0xC0600000],
    8: [0x7FF0000000000001, 0x7FF8000012345678, 0xFFF8000000001234,
        0xFFF0000000000003, 0x7FF0000000000000, 0xFFF0000000000000, 0,
        0x8000000000000000, 1, 0x800FFFFFFFFFFFFF, 0x7FEFFFFFFFFFFFFF,
        0x400C000000000000, 0xC00C000000000000],
}


def case_float_specials(chk, dtype):
    dt = np.dtype(dtype)
    x = np.tile(np.array(SPECIAL_BITS[dt.itemsize], f"u{dt.itemsize}"),
                30).view(dt)
    v = np.arange(x.size, dtype=np.uint32)
    for order in ORDERS:
        p = oracle_perm(x, order == "descending")
        chk.equal(f"specials {dt} {order}",
                  thrs.sort_keys(jnp.asarray(x), order=order), x[p])
        k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v), order=order)
        chk.equal(f"specials pairs keys {dt} {order}", k, x[p])
        chk.equal(f"specials pairs stability {dt} {order}", vv, v[p])


def case_pairs_stability(chk, rng, n=200001):
    v = np.arange(n, dtype=np.uint32)
    for kdt, mod in (("uint32", 512), ("uint64", 97), ("float32", None),
                     ("int64", 33)):
        x = random_keys(rng, kdt, n)
        if mod is not None:
            x = (x % np.dtype(kdt).type(mod)).astype(kdt)
        for order in ORDERS:
            p = oracle_perm(x, order == "descending")
            k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                                    order=order)
            chk.equal(f"pairs keys {kdt} {order}", k, x[p])
            chk.equal(f"pairs stability {kdt} {order}", vv, v[p])
            # stable=False may reorder ties; here it stays stable
            _, vu = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                                    order=order, stable=False)
            chk.equal(f"pairs stable=False {kdt} {order}", vu, v[p])


def case_u128_payload(chk, rng, n=30000):
    x = random_keys(rng, "uint64", n)
    v = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    pay = {"u128": v, "f64": random_keys(rng, "float64", n),
           "u8": rng.integers(0, 256, size=n, dtype=np.uint8)}
    k, vv = thrs.sort_pairs(jnp.asarray(x),
                            {kk: jnp.asarray(a) for kk, a in pay.items()})
    p = oracle_perm(x)
    chk.equal("u128 payload keys", k, x[p])
    for kk, a in pay.items():
        chk.equal(f"payload {kk}", vv[kk], a[p])


def case_windows(chk, rng, n=50000):
    x64 = random_keys(rng, "uint64", n)
    x32 = random_keys(rng, "uint32", n)
    v = np.arange(n, dtype=np.uint32)
    for x, windows in ((x64, ((0, 8), (8, 16), (24, 32), (56, 64), (3, 17),
                              (20, 61))),
                       (x32, ((0, 8), (24, 32), (4, 17)))):
        for sb, eb in windows:
            for order in ORDERS:
                desc = order == "descending"
                p = oracle_perm(x, desc, sb, eb)
                k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                                        order=order, start_bit=sb,
                                        end_bit=eb)
                name = f"window {x.dtype} [{sb},{eb}) {order}"
                chk.equal(name + " keys", k, x[p])
                chk.equal(name + " payload", vv, v[p])
        chk.equal(f"window {x.dtype} keys-only [8,16)",
                  thrs.sort_keys(jnp.asarray(x), start_bit=8, end_bit=16),
                  x[oracle_perm(x, False, 8, 16)])


def case_indices(chk, rng, n=65537):
    x = (random_keys(rng, "uint32", n) % np.uint32(100)).astype(np.uint32)
    chk.equal("indices u32", thrs.sort_indices(jnp.asarray(x)),
              oracle_perm(x).astype(np.int32))
    f = random_keys(rng, "float32", n)
    chk.equal("indices f32 descending",
              thrs.sort_indices(jnp.asarray(f), order="descending"),
              oracle_perm(f, True).astype(np.int32))
    z = np.zeros(n, np.uint32)
    z[7], z[n - 3] = 0xFFFFFFFF, 1  # reference extreme case
    chk.equal("extreme keys", thrs.sort_keys(jnp.asarray(z)), np.sort(z))


def case_batched(chk, rng, rows=64, lengths=(4096, 5000)):
    for m in lengths:
        x = random_keys(rng, "uint32", rows * m).reshape(rows, m)
        chk.equal(f"batched keys {rows}x{m}", thrs.sort_keys(jnp.asarray(x)),
                  np.sort(x, axis=1))
        xd = (x % np.uint32(11)).astype(np.uint32)
        v = np.broadcast_to(np.arange(m, dtype=np.uint32), (rows, m)).copy()
        _, vv = thrs.sort_pairs(jnp.asarray(xd), jnp.asarray(v))
        p = np.argsort(xd, axis=1, kind="stable")
        chk.equal(f"batched pairs stability {rows}x{m}", vv,
                  np.take_along_axis(v, p, 1))
        f = random_keys(rng, "float32", rows * m).reshape(rows, m)
        chk.equal(f"batched f32 descending {rows}x{m}",
                  thrs.sort_keys(jnp.asarray(f), order="descending"),
                  np.take_along_axis(f, oracle_perm(f, True, axis=1), 1))
        chk.equal(f"batched indices {rows}x{m}",
                  thrs.sort_indices(jnp.asarray(xd)), p.astype(np.int32))


def case_segmented(chk, rng, n=100000, nseg=37):
    x = random_keys(rng, "uint32", n)
    seg = np.sort(rng.integers(0, nseg, size=n).astype(np.int32))
    p = np.lexsort((x, seg))
    chk.equal("segmented keys",
              thrs.sort_keys(jnp.asarray(x), segment_ids=jnp.asarray(seg)),
              x[p])
    xd = (x % np.uint32(5)).astype(np.uint32)
    v = np.arange(n, dtype=np.uint32)
    pd = np.lexsort((xd, seg))
    _, vv = thrs.sort_pairs(jnp.asarray(xd), jnp.asarray(v),
                            segment_ids=jnp.asarray(seg))
    chk.equal("segmented pairs stability", vv, v[pd])
    chk.equal("segmented indices",
              thrs.sort_indices(jnp.asarray(xd), segment_ids=jnp.asarray(seg)),
              pd.astype(np.int32))


def case_errors(chk):
    z = jnp.zeros(4, jnp.uint32)
    chk.raises("method=pallas raises", ValueError,
               lambda: thrs.sort_keys(z, method="pallas"))
    chk.raises("3-D keys raise", ValueError,
               lambda: thrs.sort_keys(jnp.zeros((2, 3, 4), jnp.uint32)))
    chk.raises("bad window raises", ValueError,
               lambda: thrs.sort_keys(z, start_bit=9, end_bit=3))


def phase_semantics(seed=0, sizes=SEMANTIC_SIZES) -> str:
    rng = np.random.default_rng(seed)
    chk = Checks()
    for dt in KEY_DTYPES:
        for order in ORDERS:
            case_keys(chk, rng, dt, order, sizes)
    for dt in ("float32", "float64"):
        case_float_specials(chk, dt)
    big = max(sizes)
    case_pairs_stability(chk, rng, 2 * big)
    case_u128_payload(chk, rng, big)
    case_windows(chk, rng, big)
    case_indices(chk, rng, big)
    case_batched(chk, rng)
    case_segmented(chk, rng, big)
    case_errors(chk)
    return chk.done("semantics")


# ---------------------------------------------------------------------------
# 16-bit keys and payloads
# ---------------------------------------------------------------------------


def case_16bit(chk, rng, name, n=100000):
    dt = _dtype(name)
    # uniform raw patterns: every NaN payload, denormal, inf and both zeros
    x = rng.integers(0, 2**16, size=n, dtype=np.uint16).view(dt)
    v = np.arange(n, dtype=np.uint32)
    for order in ORDERS:
        p = oracle_perm(x, order == "descending")
        chk.equal(f"{name} keys {order}",
                  thrs.sort_keys(jnp.asarray(x), order=order), x[p])
        k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v), order=order)
        chk.equal(f"{name} pairs keys {order}", k, x[p])
        chk.equal(f"{name} pairs stability {order}", vv, v[p])
    chk.equal(f"{name} indices", thrs.sort_indices(jnp.asarray(x)),
              oracle_perm(x).astype(np.int32))
    xb = x[: 64 * 1000].reshape(64, 1000)
    chk.equal(f"{name} batched", thrs.sort_keys(jnp.asarray(xb)),
              np.take_along_axis(xb, oracle_perm(xb, axis=1), 1))
    # the same patterns as a payload behind u32 keys
    keys = random_keys(rng, "uint32", n)
    _, pv = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(x))
    chk.equal(f"{name} payload", pv, x[np.argsort(keys, kind="stable")])
    if dt.kind in "ui":
        k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v), start_bit=4,
                                end_bit=12)
        p = oracle_perm(x, False, 4, 12)
        chk.equal(f"{name} window [4,12)", k, x[p])


def phase_16bit(seed=0, n=100000) -> str:
    rng = np.random.default_rng(seed + 16)
    chk = Checks()
    for name in DTYPES_16:
        case_16bit(chk, rng, name, n)
    return chk.done("16-bit")


# ---------------------------------------------------------------------------
# main path at the reference's sizes
# ---------------------------------------------------------------------------


def sort_lowering(fn, *args) -> str:
    """Which sort the optimised HLO of ``jax.jit(fn)(*args)`` runs: the
    number of CUB radix-sort custom calls and of XLA's own sort ops."""
    text = jax.jit(fn).lower(*args).compile().as_text()
    cub = len(re.findall(r"custom_call_target=\"[^\"]*DeviceRadixSort", text))
    own = len(re.findall(r"(?<![\w.%-])sort\(", text))
    return f"cub_radix_sort={cub} xla_sort={own}"


def _oracle_perm_native(bits):
    _, perm = native_oracle.native_sort_bits(bits, with_perm=True)
    return perm.astype(np.int64)


def _rate(fn, args, n, reps=5):
    q1, med, q3 = profiling.quartiles(profiling.time_fn(fn, *args, reps=reps))
    return (f"median {med * 1e3:.3f} ms (q1 {q1 * 1e3:.3f}, q3 "
            f"{q3 * 1e3:.3f}), {n / med / 1e9:.3f} Gkeys/s"), med


def main_keys_u32(rng, n, card="", bound_passes=None) -> str:
    chk = Checks()
    x = rng.integers(0, 2**32, size=n, dtype=np.uint32)
    xd = jax.device_put(x)
    fn = jax.jit(lambda a: thrs.sort_keys(a))
    chk.equal(f"u32 keys n={n}", fn(xd), native_oracle.native_sort_bits(x))
    rate, med = _rate(fn, (xd,), n)
    line = (f"u32 keys n={n}: {chk.done('main')}; {sort_lowering(fn, xd)}; "
            f"{rate}")
    if bound_passes:
        bound = bound_passes * 4 * n / HBM_BYTES_PER_S
        line += (f"; bandwidth bound ({bound_passes} passes x 4 B/key at "
                 f"3.35 TB/s) {bound * 1e3:.3f} ms = "
                 f"{bound / med:.3f} of the time")
    return line + card


def main_pairs(rng, n, kdt, vdt, card="") -> str:
    chk = Checks()
    kinfo, vinfo = np.iinfo(kdt), np.iinfo(vdt)
    k = rng.integers(0, kinfo.max, size=n, dtype=kdt, endpoint=True)
    v = (np.arange(n, dtype=vdt) if vdt == np.uint32 else
         rng.integers(0, vinfo.max, size=n, dtype=vdt, endpoint=True))
    kd, vd = jax.device_put(k), jax.device_put(v)
    fn = jax.jit(lambda a, b: thrs.sort_pairs(a, b))
    sk, sv = fn(kd, vd)
    p = _oracle_perm_native(k)
    chk.equal(f"pairs keys n={n}", sk, k[p])
    chk.equal(f"pairs payload n={n}", sv, v[p])
    del sk, sv
    rate, _ = _rate(fn, (kd, vd), n)
    name = f"{np.dtype(kdt).name}+{np.dtype(vdt).name} pairs n={n}"
    return (f"{name}: {chk.done('main')}; {sort_lowering(fn, kd, vd)}; "
            f"{rate}{card}")


def phase_main(seed=0, soak_n=SOAK_N, big_n=BIG_N, card=""):
    """Yields one line per workload; raises on the first mismatch."""
    rng = np.random.default_rng(seed + 28)
    oracle = "native C++" if native_oracle.available() else "numpy"
    yield f"oracle: {oracle}"
    yield main_keys_u32(rng, soak_n, card)
    yield main_pairs(rng, soak_n, np.uint32, np.uint32, card)
    yield main_keys_u32(rng, big_n, card, bound_passes=9)
    yield main_pairs(rng, big_n, np.uint64, np.uint64, card)


def phase_lowering(n=1 << 24, rows=256) -> str:
    """The sort XLA emits for each remaining public path (compile only)."""
    S = jax.ShapeDtypeStruct
    u32, u64, f32 = (S((n,), jnp.uint32), S((n,), jnp.uint64),
                     S((n,), jnp.float32))
    seg = S((n,), jnp.int32)
    rows2d = S((rows, n // rows), jnp.uint32)
    cases = {
        "sort_keys f32": (lambda a: thrs.sort_keys(a), f32),
        "sort_keys u64": (lambda a: thrs.sort_keys(a), u64),
        "sort_indices u32": (lambda a: thrs.sort_indices(a), u32),
        "sort_pairs u32 window [8,16)": (
            lambda a, b: thrs.sort_pairs(a, b, start_bit=8, end_bit=16),
            u32, u32),
        f"sort_keys batched {rows}x{n // rows}": (
            lambda a: thrs.sort_keys(a), rows2d),
        "sort_keys segmented": (
            lambda a, s: thrs.sort_keys(a, segment_ids=s), u32, seg),
        "psort local lexsort (2 words + carry)": (
            lambda a, b, c: c[jnp.lexsort((b, a))], u32, u32, u32),
    }
    return "; ".join(f"{name}: {sort_lowering(fn, *args)}"
                     for name, (fn, *args) in cases.items())


# ---------------------------------------------------------------------------
# four cards: psort
# ---------------------------------------------------------------------------


def phase_four_cards(seed=0, n_dryrun=1 << 20, n_zipf=BIG_N, ncards=4):
    """Yields one line per scenario; raises on the first mismatch."""
    from jax.sharding import NamedSharding, PartitionSpec

    import __graft_entry__
    from tinyhipradixsort_tpu.parallel import make_sort_mesh, psort

    devices = jax.devices()[:ncards]
    if len(devices) != ncards:
        raise RuntimeError(f"need {ncards} devices, JAX has {len(devices)}")
    __graft_entry__.dryrun_multichip(ncards, n=n_dryrun)
    yield f"dryrun_multichip: 4 scenarios ok (n={n_dryrun}, P={ncards})"

    mesh = make_sort_mesh(devices)
    shard = NamedSharding(mesh, PartitionSpec(psort.AXIS))
    rng = np.random.default_rng(seed + 4)
    k = np.minimum(rng.zipf(1.3, size=n_zipf), 2**31).astype(np.uint32)
    v = np.arange(n_zipf, dtype=np.uint32)
    kd, vd = jax.device_put(k, shard), jax.device_put(v, shard)
    p = _oracle_perm_native(k)

    chk = Checks()
    keys_fn = jax.jit(lambda a: thrs.psort_keys(a, mesh=mesh, check=True))
    got, ovf = keys_fn(kd)
    chk.equal("psort_keys overflow flag", ovf, np.bool_(False))
    chk.equal(f"psort_keys zipf n={n_zipf}", got, k[p])
    del got
    rate, _ = _rate(keys_fn, (kd,), n_zipf, reps=3)
    yield f"psort_keys zipf n={n_zipf} P={ncards}: {chk.done('psort')}; {rate}"

    chk = Checks()
    pairs_fn = jax.jit(lambda a, b: thrs.psort_pairs(a, b, mesh=mesh,
                                                     check=True))
    sk, sv, ovf = pairs_fn(kd, vd)
    chk.equal("psort_pairs overflow flag", ovf, np.bool_(False))
    chk.equal(f"psort_pairs keys zipf n={n_zipf}", sk, k[p])
    chk.equal(f"psort_pairs payload zipf n={n_zipf}", sv, v[p])
    del sk, sv
    rate, _ = _rate(pairs_fn, (kd, vd), n_zipf, reps=3)
    yield (f"psort_pairs zipf n={n_zipf} P={ncards}: {chk.done('psort')}; "
           f"{rate}")


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def result_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run psort on four cards and no other phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    profiling.enable_compile_cache()
    try:
        rep = profiling.device_report()
    except RuntimeError as e:  # no backend JAX can initialise
        print(f"chip_smoke: no accelerator: {e}", file=sys.stderr)
        return 2
    if rep["platform"] != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {rep['platform']}",
              file=sys.stderr)
        return 2
    count = 4 if args.four_cards else rep["count"]
    if count > rep["count"]:
        print(f"chip_smoke: --four-cards needs 4 GPUs, JAX found "
              f"{rep['count']}", file=sys.stderr)
        return 2
    card = f" [on {rep['gpu_name']}, power limit {rep['power_limit']}]"
    print(f"devices: platform={rep['platform']} kind={rep['device_kind']} "
          f"count={rep['count']}", flush=True)
    print(f"nvidia-smi: {rep['nvidia_smi']}", flush=True)

    if args.four_cards:
        phases = [("four-cards", lambda: phase_four_cards(args.seed))]
    else:
        phases = [
            ("semantics", lambda: [phase_semantics(args.seed)]),
            ("16-bit", lambda: [phase_16bit(args.seed)]),
            ("main", lambda: phase_main(args.seed, card=card)),
            ("lowering", lambda: [phase_lowering()]),
        ]
    failed = []
    for name, run in phases:
        t0 = time.perf_counter()
        try:
            for line in run():
                print(f"{name}: {line}", flush=True)
            print(f"{name}: done in {time.perf_counter() - t0:.1f} s",
                  flush=True)
        except Exception as e:  # report every phase, then exit non-zero
            traceback.print_exc()
            print(f"{name}: FAILED: {type(e).__name__}: {e}", flush=True)
            failed.append(name)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(result_line(rep["platform"], rep["device_kind"], count))
    return 0


if __name__ == "__main__":
    sys.exit(main())
