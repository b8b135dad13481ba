"""Reference-density randomized tier (``pytest --full``; nightly).

Mirrors the reference's density, not just its strategy: unittest.cpp runs
``TEST_ITERATION 128`` random sizes in ``[1, TEST_MAX_ARRAY_SIZE=100000)``
per case (unittest.cpp:20-21, 127-168) and a 1e8-sample FPKeys order
property (unittest.cpp:81-94). Here: >= 64 random sizes per
(dtype x order x engine) keys case, a pairs matrix with sequential payloads
(stability probes, unittest.cpp:426-487), random digit windows
(unittest.cpp:248-355), and a 1e8-sample FPKeys sweep per float dtype
(the reference's exact density).

Sizes are drawn from per-case *deterministic* seeds so the persistent
compile cache makes every nightly after the first cheap (each distinct n is
one XLA trace — the analogue of the reference compiling once and looping
sizes).
"""

import zlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tinyhipradixsort_tpu as thrs
from tinyhipradixsort_tpu import keybits
import oracles

pytestmark = pytest.mark.full

ITER = 64
MAX_N = 100_000  # reference TEST_MAX_ARRAY_SIZE


@pytest.fixture(autouse=True)
def _clear_per_test():
    # this tier compiles ~64 executables per test: stay under the XLA-CPU
    # loaded-executable crash threshold (see conftest) by dropping them
    # per *function*, not per module
    yield
    jax.clear_caches()


ENGINES = ("argsort", "counting")


def _rand_keys(rng, dtype, n):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = rng.standard_normal(n).astype(dtype) * dtype.type(100)
        x[rng.random(n) < 0.05] = dtype.type(0.0)
        x[rng.random(n) < 0.05] = dtype.type(-0.0)
        return x
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, dtype=dtype,
                        endpoint=True)


def _view(dtype):
    return np.dtype(f"u{np.dtype(dtype).itemsize}")


KEY_DTYPES = (np.uint32, np.int32, np.float32, np.uint64, np.int64,
              np.float64)


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("dtype", KEY_DTYPES)
@pytest.mark.parametrize("engine", ENGINES)
def test_full_sort_keys_random_sizes(dtype, order, engine):
    seed = zlib.crc32(f"{np.dtype(dtype).name}/{order}/{engine}".encode())
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, MAX_N, size=ITER)
    for n in sizes:
        x = _rand_keys(rng, dtype, int(n))
        got = np.asarray(thrs.sort_keys(jnp.asarray(x), order=order,
                                        method=engine))
        want = oracles.oracle_sort_keys(x, descending=(order == "descending"))
        np.testing.assert_array_equal(got.view(_view(dtype)),
                                      want.view(_view(dtype)), err_msg=f"n={n}")


@pytest.mark.parametrize("kdt,vdt", [
    (np.uint32, np.uint32), (np.float32, np.uint32), (np.uint64, np.uint32),
    (np.uint32, np.uint64), (np.uint64, np.uint64),
])
@pytest.mark.parametrize("engine", ENGINES)
def test_full_sort_pairs_random_sizes(kdt, vdt, engine):
    # sequential payload makes any stability violation observable
    # (reference SortPairs matrix, unittest.cpp:426-487)
    seed = zlib.crc32(
        f"{np.dtype(kdt).name}/{np.dtype(vdt).name}/{engine}".encode())
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, MAX_N, size=ITER // 2)
    for n in sizes:
        n = int(n)
        x = _rand_keys(rng, kdt, n)
        # heavy duplicates half the time: ties are the stability stress
        if rng.random() < 0.5 and np.dtype(kdt).kind != "f":
            x = (x % np.dtype(kdt).type(97)).astype(kdt)
        v = np.arange(n, dtype=vdt)
        gk, gv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                                 method=engine)
        wk, wv = oracles.oracle_sort_pairs(x, v)
        np.testing.assert_array_equal(np.asarray(gk).view(_view(kdt)),
                                      wk.view(_view(kdt)), err_msg=f"n={n}")
        np.testing.assert_array_equal(np.asarray(gv), wv, err_msg=f"n={n}")


@pytest.mark.parametrize("engine", ENGINES)
def test_full_random_bit_windows_u64(engine):
    # the stability-contract density test (reference StartBits.u64,
    # unittest.cpp:248-355): random byte-aligned-and-not windows, both
    # orders, pairs payload observes tie order of full keys
    rng = np.random.default_rng(0x57A47)
    for _ in range(ITER // 2):
        n = int(rng.integers(1, MAX_N))
        start = int(rng.integers(0, 63))
        width = int(rng.integers(1, 65 - start))
        order = "descending" if rng.random() < 0.5 else "ascending"
        x = rng.integers(0, 2**64, size=n, dtype=np.uint64)
        v = np.arange(n, dtype=np.uint32)
        gk, gv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v), order=order,
                                 start_bit=start, end_bit=start + width,
                                 method=engine)
        wk, wv = oracles.oracle_sort_pairs(
            x, v, descending=(order == "descending"),
            start_bit=start, end_bit=start + width)
        msg = f"n={n} window=[{start},{start + width})"
        np.testing.assert_array_equal(np.asarray(gk), wk, err_msg=msg)
        np.testing.assert_array_equal(np.asarray(gv), wv, err_msg=msg)


@pytest.mark.parametrize("order", ["ascending", "descending"])
@pytest.mark.parametrize("dtype", [np.float64, np.float16, "bfloat16"])
def test_full_host_adapter_contract(dtype, order):
    """Reference-density tier for the host adapters (reference bar
    unittest.cpp:170-245 f32/f64 cases): ``np_key_bits -> device sort of
    the integer bits -> np_key_bits_inverse`` must be bit-exact INCLUDING
    NaN payloads and -0.0. >= 32 random sizes per (dtype x order), keys
    and pairs, NaN/Inf/-0.0 spliced in; the device only ever sees u32/u64
    bits."""
    import jax.numpy as jnpp
    dtype = jnpp.bfloat16 if dtype == "bfloat16" else np.dtype(dtype)
    np_dt = np.dtype(dtype)
    desc = order == "descending"
    seed = zlib.crc32(f"adapter/{np_dt.name}/{order}".encode())
    rng = np.random.default_rng(seed)
    width = np_dt.itemsize * 8
    for i in range(ITER // 2):
        n = int(rng.integers(1, MAX_N))
        raw = rng.integers(0, 2 ** width, size=n, dtype=np.uint64)
        x = raw.astype(_view(np_dt)).view(np_dt)  # all bit patterns:
        # NaN payloads, +-Inf, denormals, -0.0 — the full contract
        bits = keybits.np_key_bits(x, descending=desc)
        sbits = np.asarray(thrs.sort_keys(jnp.asarray(bits)))
        got = keybits.np_key_bits_inverse(sbits, np_dt, descending=desc)
        p = np.argsort(bits, kind="stable")
        np.testing.assert_array_equal(sbits, bits[p],
                                      err_msg=f"device bits n={n}")
        want = x[p].copy()
        want[want == np_dt.type(0)] = np_dt.type(0.0)  # the documented
        # -0.0 -> +0.0 normalization of the forward transform
        np.testing.assert_array_equal(got.view(_view(np_dt)),
                                      want.view(_view(np_dt)),
                                      err_msg=f"keys n={n}")
        if i % 4 == 0:  # pairs at quarter density (adapter + payload)
            v = np.arange(n, dtype=np.uint32)
            sb, sv = thrs.sort_pairs(jnp.asarray(bits), jnp.asarray(v))
            gk = keybits.np_key_bits_inverse(np.asarray(sb), np_dt,
                                             descending=desc)
            np.testing.assert_array_equal(gk.view(_view(np_dt)),
                                          want.view(_view(np_dt)),
                                          err_msg=f"pair keys n={n}")
            np.testing.assert_array_equal(np.asarray(sv), v[p],
                                          err_msg=f"pair vals n={n}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_full_fpkeys_order_property(dtype):
    # a < b  <=>  key_bits(a) < key_bits(b), 1e8 random samples per dtype —
    # the reference's exact density (FPKeys.float, unittest.cpp:81-94;
    # pure numpy — no device involved, ~2 min/dtype on this host)
    rng = np.random.default_rng(0xF19A75)
    n = 100_000_000
    raw = rng.integers(0, 2 ** (np.dtype(dtype).itemsize * 8), size=n,
                       dtype=np.uint64)
    x = raw.astype(_view(dtype)).view(dtype)
    finite = np.isfinite(x)
    x = x[finite]  # NaN order is covered by dedicated tests; here: totality
    bits = keybits.np_key_bits(x)
    order = np.argsort(x, kind="stable")
    xs, bs = x[order], bits[order]
    # equal values (incl. -0.0 == +0.0) must map to equal-ordered bits
    lt = xs[:-1] < xs[1:]
    assert np.all(bs[:-1][lt] < bs[1:][lt])
    eq = xs[:-1] == xs[1:]
    # -0.0 and +0.0 compare equal but have distinct bit patterns; the
    # transform normalizes both to the +0.0 key (kernel.cu:56-57 parity)
    assert np.all(bs[:-1][eq] == bs[1:][eq])
    # edge pairs the reference checks explicitly
    fmax = np.finfo(dtype).max
    inf = np.array(np.inf, dtype)
    assert keybits.np_key_bits(np.array([fmax], dtype))[0] < \
        keybits.np_key_bits(np.array([inf], dtype))[0]
    assert keybits.np_key_bits(np.array([-0.0], dtype))[0] == \
        keybits.np_key_bits(np.array([0.0], dtype))[0]
