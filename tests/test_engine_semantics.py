"""Semantics of the public entry points on the default engine
(``method="auto"``, XLA's stable sort).

Mirrors the reference's oracle-based randomized strategy
(reference: unittest.cpp:127-487) against numpy stable oracles.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import tinyhipradixsort_tpu as thrs
import oracles

RNG = np.random.default_rng(0xB170)
SIZES = [1, 2, 3, 127, 128, 1000, 1024, 4097]


def _rand(dtype, n):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = RNG.standard_normal(n).astype(dtype)
        x[RNG.random(n) < 0.05] = 0.0
        x[RNG.random(n) < 0.05] = -0.0
        return x
    info = np.iinfo(dtype)
    return RNG.integers(info.min, info.max, size=n, dtype=dtype, endpoint=True)


@pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32, np.uint64, np.int64])
@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_sort_keys_semantics(dtype, order):
    for n in (1, 129, 2000):
        x = _rand(dtype, n)
        got = np.asarray(thrs.sort_keys(jnp.asarray(x), order=order))
        want = oracles.oracle_sort_keys(x, descending=(order == "descending"))
        np.testing.assert_array_equal(
            got.view(np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64),
            want.view(np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64))


@pytest.mark.parametrize("dtype", [np.uint32, np.float32, np.uint64])
def test_sort_pairs_stability(dtype):
    n = 3000
    x = (_rand(dtype, n) if np.dtype(dtype).kind == "f"
         else (_rand(dtype, n) % 8).astype(dtype))  # heavy duplicates
    vals = np.arange(n, dtype=np.uint32)
    k, v = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(vals))
    ok, ov = oracles.oracle_sort_pairs(x, vals)
    np.testing.assert_array_equal(np.asarray(v), ov)
    np.testing.assert_array_equal(
        np.asarray(k).view(ok.dtype if ok.dtype.kind != "f" else np.uint32),
        ok.view(ok.dtype if ok.dtype.kind != "f" else np.uint32))


def test_sort_pairs_payload_kinds():
    n = 1500
    x = _rand(np.uint32, n)
    values = {
        "u64": RNG.integers(0, 2**64, size=n, dtype=np.uint64),
        "u128": RNG.integers(0, 2**32, size=(n, 4), dtype=np.uint32),
        "f32": RNG.standard_normal(n).astype(np.float32),
        "u8": RNG.integers(0, 255, size=n, dtype=np.uint8),
    }
    k, v = thrs.sort_pairs(jnp.asarray(x), {kk: jnp.asarray(vv) for kk, vv in values.items()})
    order = np.argsort(thrs.np_key_bits(x), kind="stable")
    np.testing.assert_array_equal(np.asarray(k), x[order])
    for kk, vv in values.items():
        np.testing.assert_array_equal(np.asarray(v[kk]), vv[order])


def test_sort_indices_stable():
    n = 2500
    x = (_rand(np.uint32, n) % 16).astype(np.uint32)
    perm = np.asarray(thrs.sort_indices(jnp.asarray(x)))
    np.testing.assert_array_equal(perm, np.argsort(x, kind="stable"))


@pytest.mark.parametrize("start,end", [(8, 16), (0, 8), (24, 32), (4, 17)])
def test_window_pairs(start, end):
    n = 2000
    x = _rand(np.uint32, n)
    vals = np.arange(n, dtype=np.uint32)
    k, v = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(vals),
                           start_bit=start, end_bit=end)
    mask = ((1 << (end - start)) - 1)
    digit = (x >> start) & mask
    order = np.argsort(digit, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), x[order])
    np.testing.assert_array_equal(np.asarray(v), vals[order])


def test_extreme_case_keys():
    # all-zero with two sentinels (reference: unittest.cpp:191-225)
    n = 4096
    x = np.zeros(n, dtype=np.uint32)
    x[100] = 0xFFFFFFFF
    x[3000] = 1
    got = np.asarray(thrs.sort_keys(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))


def test_float_zero_run_bit_exact():
    # mixed -0.0/+0.0 must keep input order bit-exactly
    x = np.array([1.0, -0.0, 0.0, -0.0, 0.0, -1.0, 0.0, -0.0] * 64, dtype=np.float32)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x)))
    order = np.argsort(thrs.np_key_bits(x), kind="stable")
    np.testing.assert_array_equal(got.view(np.uint32), x[order].view(np.uint32))


@pytest.mark.parametrize("n", [0, 1, 2, 1023, 1024, 1025])
def test_edge_sizes(n):
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x))
    v = np.arange(n, dtype=np.uint32)
    k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v))
    p = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(np.asarray(vv), v[p])


def test_float_specials_keys():
    x = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40,
                  -1e-40, 3.5, -3.5] * 30, dtype=np.float32)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x)))
    want = oracles.oracle_sort_keys(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_zeros_exact_fast_path():
    # the single-device sort carries the original keys, so
    # zeros_exact=False keeps -0.0 (and every NaN payload) bit-exact too
    x = np.array([3.5, -0.0, 0.0, -1.25, np.inf, -np.inf, np.nan] * 100,
                 dtype=np.float32)
    want = oracles.oracle_sort_keys(x).view(np.uint32)
    for exact in (False, True):
        got = np.asarray(thrs.sort_keys(jnp.asarray(x), zeros_exact=exact))
        np.testing.assert_array_equal(got.view(np.uint32), want)
