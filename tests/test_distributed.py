"""Distributed sort tests on the virtual 8-device CPU mesh (SURVEY.md §4:
multi-host strategy tested via --xla_force_host_platform_device_count)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tinyhipradixsort_tpu as thrs
from tinyhipradixsort_tpu.parallel import (
    make_sort_mesh, psort_indices, psort_keys, psort_pairs)
import oracles

RNG = np.random.default_rng(0xD157)


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return make_sort_mesh()


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32, np.uint64])
@pytest.mark.parametrize("n", [8, 1000, 65536, 100001])
def test_psort_keys(mesh, dtype, n):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = RNG.standard_normal(n).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = RNG.integers(info.min, info.max, size=n, dtype=dtype, endpoint=True)
    got, overflow = psort_keys(jnp.asarray(x), mesh=mesh, check=True)
    assert not bool(overflow)
    want = oracles.oracle_sort_keys(x)
    vd = np.uint32 if dtype.itemsize == 4 else np.uint64
    np.testing.assert_array_equal(np.asarray(got).view(vd), want.view(vd))


def test_psort_keys_descending(mesh):
    x = RNG.integers(0, 2**32, size=20000, dtype=np.uint32)
    got = np.asarray(psort_keys(jnp.asarray(x), mesh=mesh, order="descending"))
    np.testing.assert_array_equal(got, np.sort(x)[::-1])


@pytest.mark.parametrize("skew", ["constant", "zipf", "two-values"])
def test_psort_skewed(mesh, skew):
    n = 50000
    if skew == "constant":
        x = np.full(n, 42, dtype=np.uint32)
    elif skew == "zipf":
        x = np.minimum(RNG.zipf(1.3, size=n), 2**31).astype(np.uint32)
    else:
        x = np.where(RNG.random(n) < 0.95, 7, 123456789).astype(np.uint32)
    vals = np.arange(n, dtype=np.uint32)
    k, v, overflow = psort_pairs(jnp.asarray(x), jnp.asarray(vals),
                                 mesh=mesh, check=True)
    assert not bool(overflow), f"splitter overflow on {skew}"
    ok, ov = oracles.oracle_sort_pairs(x, vals)
    np.testing.assert_array_equal(np.asarray(k), ok)
    np.testing.assert_array_equal(np.asarray(v), ov)  # stability probe


def test_psort_pairs_stability_and_payloads(mesh):
    n = 30000
    x = (RNG.integers(0, 64, size=n)).astype(np.uint32)
    payload = {
        "idx": np.arange(n, dtype=np.uint32),
        "wide": RNG.integers(0, 2**64, size=n, dtype=np.uint64),
    }
    k, v = psort_pairs(jnp.asarray(x), jax.tree.map(jnp.asarray, payload),
                       mesh=mesh)
    order = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), x[order])
    np.testing.assert_array_equal(np.asarray(v["idx"]), payload["idx"][order])
    np.testing.assert_array_equal(np.asarray(v["wide"]), payload["wide"][order])


def test_psort_indices(mesh):
    n = 12345
    x = RNG.integers(0, 100, size=n, dtype=np.uint32)
    perm = np.asarray(psort_indices(jnp.asarray(x), mesh=mesh))
    np.testing.assert_array_equal(perm, np.argsort(x, kind="stable"))


def test_psort_matches_single_chip_float_bits(mesh):
    # float keys incl. -0.0/+0.0: bit-exact vs numpy stable oracle
    n = 9999
    x = RNG.standard_normal(n).astype(np.float32)
    x[RNG.random(n) < 0.1] = 0.0
    x[RNG.random(n) < 0.1] = -0.0
    got = np.asarray(psort_keys(jnp.asarray(x), mesh=mesh))
    want = oracles.oracle_sort_keys(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_psort_wide_index_keys_pairs(mesh):
    # the two-u32-word (u64) global-rank tie-break used for n >= 2**32
    # (BASELINE 16B-key config), forced on at test size: output must be
    # bit-identical to the narrow path incl. stability
    n = 30000
    x = (RNG.integers(0, 256, size=n)).astype(np.uint32)  # heavy duplicates
    v = np.arange(n, dtype=np.uint32)
    k, vv = psort_pairs(jnp.asarray(x), jnp.asarray(v), mesh=mesh,
                        _force_wide=True)
    p = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), x[p])
    np.testing.assert_array_equal(np.asarray(vv), v[p])


def test_psort_wide_index_indices(mesh):
    n = 8192
    x = RNG.integers(0, 50, size=n, dtype=np.uint32)
    perm = np.asarray(psort_indices(jnp.asarray(x), mesh=mesh,
                                    _force_wide=True))
    assert perm.dtype == np.int64
    np.testing.assert_array_equal(perm, np.argsort(x, kind="stable"))
    got = np.asarray(psort_keys(jnp.asarray(x), mesh=mesh, _force_wide=True))
    np.testing.assert_array_equal(got, np.sort(x))


def test_psort_traces_beyond_2_32(mesh):
    # BASELINE configs[4] is 16B u32 keys — far beyond this host's RAM, so
    # the executable evidence is: the wide-index program at n > 2**32
    # lowers AND compiles for the 8-device mesh (static shapes, collective
    # layouts, i64 rank arithmetic all validated by XLA), while the
    # _force_wide tests above prove the same code path's output exactly at
    # executable sizes.
    n = (1 << 32) + (1 << 16)
    fn = jax.jit(lambda k: psort_keys(k, mesh=mesh, check=True),
                 static_argnums=())
    lowered = fn.lower(jax.ShapeDtypeStruct((n,), jnp.uint32))
    text = lowered.as_text()
    assert "all-to-all" in text or "all_to_all" in text
    lowered.compile()  # full XLA compile; no buffers are allocated


def test_psort_overflow_surfaces(mesh):
    # a capacity violation must never return silently-truncated data
    # with check=True the flag is
    # returned; with check=False (default) it raises at runtime. _unsafe_cap
    # bypasses the analytic capacity floor to force the condition.
    n = 16384
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    got, overflow = psort_keys(jnp.asarray(x), mesh=mesh, check=True,
                               _unsafe_cap=64)
    assert bool(overflow), "tiny cap must overflow"
    with pytest.raises(RuntimeError, match="overflow"):
        psort_keys(jnp.asarray(x), mesh=mesh, _unsafe_cap=64)


def test_psort_capacity_floor_large_mesh(mesh):
    # at P=8 with hostile slack/oversample the analytic floor must keep the
    # exchange overflow-free (the advisor's P > slack*oversample/4 regime)
    n = 20000
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    got, overflow = psort_keys(jnp.asarray(x), mesh=mesh, check=True,
                               slack=0.1, oversample=4)
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(got), np.sort(x))


@pytest.mark.parametrize("ndev", [3, 5, 6, 7])
def test_psort_non_pow2_mesh(ndev):
    # regression: B must divide by P for the stride pre-exchange
    m = make_sort_mesh(jax.devices()[:ndev])
    for n in (1, 49, 5000):
        x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
        got = np.asarray(psort_keys(jnp.asarray(x), mesh=m))
        np.testing.assert_array_equal(got, np.sort(x))


def test_psort_keys_only_sheds_index_wire(mesh):
    """Keys-only sorts must not ship the global-index word(s): the index is synthesized in-shard after the deterministic stride
    pre-exchange and dropped before the ring exchange. Structural check on
    the lowered HLO: psort_keys runs one collective-permute per ring round
    per *bits* word only, while psort_indices (which must output the index)
    runs one per bits+index word — at P=8, R=4 the difference is at least
    (P-1) ring + 2R rebalance permutes, and one fewer pre-exchange
    all_to_all."""
    n = 1 << 15
    P = 8

    def count(fn):
        text = jax.jit(lambda k: fn(k, mesh=mesh, check=True)).lower(
            jax.ShapeDtypeStruct((n,), jnp.uint32)).as_text()
        return (text.count("collective-permute") + text.count(
            "collective_permute"), text.count("all-to-all") + text.count(
            "all_to_all"))

    cp_keys, a2a_keys = count(psort_keys)
    cp_idx, a2a_idx = count(psort_indices)
    assert cp_idx - cp_keys >= (P - 1) + 2 * min(P - 1, 4), (cp_keys, cp_idx)
    assert a2a_idx > a2a_keys, (a2a_keys, a2a_idx)


def test_psort_keys_only_sentinel_collision(mesh):
    # With the index word dropped from the exchange, real keys whose bits
    # equal the sentinel (0xFFFFFFFF ascending / 0 descending) intermix
    # with buffer padding during merges — harmless because the words are
    # identical, but this is the exact case that would corrupt if any
    # downstream count were sentinel-scanned. Heavy max-keys + entry pads
    # (n not a multiple of the pad quantum), both index widths.
    n = 100001
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    x[RNG.random(n) < 0.05] = 0xFFFFFFFF
    for wide in (False, True):
        got = np.asarray(psort_keys(jnp.asarray(x), mesh=mesh,
                                    _force_wide=wide))
        np.testing.assert_array_equal(got, np.sort(x))
    x[RNG.random(n) < 0.05] = 0  # descending: 0 complements to all-ones
    got = np.asarray(psort_keys(jnp.asarray(x), mesh=mesh,
                                order="descending"))
    np.testing.assert_array_equal(got, np.sort(x)[::-1])


def test_psort_keys_only_constant_no_overflow(mesh):
    # the synthesized index tie-break is load-bearing: without it a
    # constant-key input puts the whole array in one splitter segment
    x = np.full(65536, 0xDEAD, dtype=np.uint32)
    got, overflow = psort_keys(jnp.asarray(x), mesh=mesh, check=True)
    assert not bool(overflow)
    np.testing.assert_array_equal(np.asarray(got), x)


@pytest.mark.parametrize("descending", [False, True])
def test_psort_bit_window_keys_pairs(mesh, descending):
    """Distributed start_bit/end_bit mirror of test_startbits.py (reference
    unittest.cpp:248-355 / hpp:845-852): random byte window over u64 keys,
    both orders, keys-only + pairs, stability via sequential payload.
    Window sorts can't rebuild keys from cmp bits, so the keys ride as
    carry words and the index word stays on the wire."""
    order = "descending" if descending else "ascending"
    rng = np.random.default_rng(77 + descending)
    for start in (0, 24, 56):
        end = start + 8
        n = 20000
        keys = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        values = np.arange(n, dtype=np.uint32)
        ks, vs = psort_pairs(jnp.asarray(keys), jnp.asarray(values),
                             mesh=mesh, order=order,
                             start_bit=start, end_bit=end)
        p = oracles.oracle_perm(keys, descending=descending,
                                start_bit=start, end_bit=end)
        np.testing.assert_array_equal(np.asarray(ks), keys[p],
                                      err_msg=f"window [{start},{end})")
        np.testing.assert_array_equal(np.asarray(vs), values[p])
        ko = psort_keys(jnp.asarray(keys), mesh=mesh, order=order,
                        start_bit=start, end_bit=end)
        np.testing.assert_array_equal(np.asarray(ko), keys[p])


def test_psort_bit_window_non_byte_aligned(mesh):
    # beyond-reference: any window (the reference asserts %8==0)
    keys = RNG.integers(0, 2**32, size=15000, dtype=np.uint32)
    got = np.asarray(psort_keys(jnp.asarray(keys), mesh=mesh,
                                start_bit=3, end_bit=17))
    np.testing.assert_array_equal(got, oracles.oracle_sort_keys(
        keys, start_bit=3, end_bit=17))


def test_psort_pairs_zeros_exact(mesh):
    # psort_pairs zeros_exact: False rebuilds keys from bits (-0.0 -> +0.0,
    # one less carry word on the wire); True returns keys bit-exactly.
    # Payload stability must hold either way.
    n = 12000
    x = RNG.standard_normal(n).astype(np.float32)
    x[RNG.random(n) < 0.1] = 0.0
    x[RNG.random(n) < 0.1] = -0.0
    v = np.arange(n, dtype=np.uint32)
    p = np.argsort(x, kind="stable")
    k1, v1 = psort_pairs(jnp.asarray(x), jnp.asarray(v), mesh=mesh,
                         zeros_exact=True)
    np.testing.assert_array_equal(np.asarray(k1).view(np.uint32),
                                  x[p].view(np.uint32))
    np.testing.assert_array_equal(np.asarray(v1), v[p])
    k0, v0 = psort_pairs(jnp.asarray(x), jnp.asarray(v), mesh=mesh,
                         zeros_exact=False)
    norm = x[p].copy()
    norm[norm == 0.0] = 0.0  # -0.0 normalized to +0.0
    np.testing.assert_array_equal(np.asarray(k0).view(np.uint32),
                                  norm.view(np.uint32))
    np.testing.assert_array_equal(np.asarray(v0), v[p])


def test_psort_donate(mesh):
    # donate=True reuses the caller's sharded buffers (reference
    # result-replaces-input, hpp:936-943); output must be unchanged
    n = 30000
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    v = np.arange(n, dtype=np.uint32)
    kd = psort_keys(jnp.asarray(x), mesh=mesh, donate=True)
    np.testing.assert_array_equal(np.asarray(kd), np.sort(x))
    p = np.argsort(x, kind="stable")
    k2, v2 = psort_pairs(jnp.asarray(x), jnp.asarray(v), mesh=mesh,
                         donate=True)
    np.testing.assert_array_equal(np.asarray(k2), x[p])
    np.testing.assert_array_equal(np.asarray(v2), v[p])
    perm = psort_indices(jnp.asarray(x), mesh=mesh, donate=True)
    np.testing.assert_array_equal(np.asarray(perm), p)


def test_psort_refinement_structured_inputs(mesh):
    """Exact-rank splitter refinement (DESIGN.md §3b) regression set: the
    inputs that broke intermediate designs. Two-values (95% duplicates at
    partial density — stride-granularity segment excess, fixed by the
    mod-P interleaved pre-exchange AND the monotone bracket update),
    presorted/reversed (position-contiguous masses), keys-only variants
    of each. All must complete without tripping the tightened
    ~1.06*B/P capacity."""
    n = 50000
    rng = np.random.default_rng(99)
    two = np.where(rng.random(n) < 0.95, 7, 123456789).astype(np.uint32)
    asc = np.arange(n, dtype=np.uint32)
    for label, x in (("two-values", two), ("presorted", asc),
                     ("reversed", asc[::-1].copy())):
        got, ovf = psort_keys(jnp.asarray(x), mesh=mesh, check=True)
        assert not bool(ovf), f"overflow on {label}"
        np.testing.assert_array_equal(np.asarray(got), np.sort(x),
                                      err_msg=label)


def test_psort_refine_off_matches(mesh):
    # the legacy sampling-bound path (refine=False) must stay available
    # and bit-exact (it is the pre-round-4 behavior: slack 1.5, budget cap)
    n = 30000
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    v = np.arange(n, dtype=np.uint32)
    got, ovf = psort_keys(jnp.asarray(x), mesh=mesh, check=True,
                          refine=False)
    assert not bool(ovf)
    np.testing.assert_array_equal(np.asarray(got), np.sort(x))
    k2, v2 = psort_pairs(jnp.asarray(x), jnp.asarray(v), mesh=mesh,
                         refine=False)
    p = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(np.asarray(k2), x[p])
    np.testing.assert_array_equal(np.asarray(v2), v[p])


def test_refine_plan_properties():
    from tinyhipradixsort_tpu.parallel.psort import refine_plan
    # W_f converges to O(P) at every scale, rounds stay bounded, and the
    # P > 128 budget cliff is gone: W_f at P=256 is ~P, not ~B/64
    for B, P in ((8192, 8), (62_500_000, 256), (250_000_000, 64)):
        rounds, W_f = refine_plan(B, P, min(B, 32 * P))
        assert rounds <= 16
        assert W_f <= 2 * P + 18, (B, P, W_f)


@pytest.mark.full
def test_psort_large_n_executes(mesh):
    """Execution (not just compile) evidence for the big-n distributed
    path (reference bar unittest.cpp:688-717 u32Large,
    n = 2**31+100) on the CPU tier: n = 2**26 u32 through the full psort
    pipeline on the 8-device CPU mesh."""
    n = 1 << 26
    x = np.random.default_rng(26).integers(0, 2**32, size=n, dtype=np.uint32)
    got, ovf = psort_keys(jnp.asarray(x), mesh=mesh, method="lexsort",
                          check=True)
    assert not bool(ovf)
    np.testing.assert_array_equal(np.asarray(got), np.sort(x))
