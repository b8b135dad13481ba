"""Key-value sort + stability probes (reference: unittest.cpp:426-487
SortPairs.K*V*; sequential payload makes any stability violation observable)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tinyhipradixsort_tpu as thrs
from tinyhipradixsort_tpu.utils.prng import random_keys
from oracles import oracle_perm, oracle_sort_pairs

METHODS = ["argsort", "lsd_argsort", "counting"]


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize(
    "key_dtype,value_dtype",
    [
        (np.uint32, np.uint32),   # K32V32
        (np.float32, np.uint32),  # KF32V32
        (np.uint64, np.uint32),   # K64V32
        (np.float64, np.uint32),  # KF64V32
        (np.uint32, np.uint64),   # K32V64
        (np.uint64, np.uint64),   # K64V64
    ],
)
def test_pairs_stability(method, key_dtype, value_dtype):
    # values[i] = i: output payload must equal the stable oracle permutation.
    for n in (1, 777, 12_345):
        keys = random_keys(key_dtype, n, seed=n)
        # Duplicate-heavy keys to actually exercise stability.
        if np.dtype(key_dtype).kind == "u":
            keys = keys % np.dtype(key_dtype).type(64)
        values = np.arange(n, dtype=value_dtype)
        ks, vs = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values), method=method)
        want_k, want_v = oracle_sort_pairs(keys, values)
        np.testing.assert_array_equal(np.asarray(ks).view(np.uint32 if np.dtype(key_dtype).itemsize == 4 else np.uint64),
                                      want_k.view(np.uint32 if np.dtype(key_dtype).itemsize == 4 else np.uint64))
        np.testing.assert_array_equal(np.asarray(vs), want_v)


@pytest.mark.parametrize("method", METHODS)
def test_pairs_u128_payload(method):
    # K64V128 (reference: unittest.cpp:471-487): 16-byte payload as (n, 4) u32.
    n = 9_999
    keys = random_keys(np.uint64, n, seed=3) % np.uint64(1000)
    values = np.arange(4 * n, dtype=np.uint32).reshape(n, 4)
    ks, vs = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values), method=method)
    p = oracle_perm(keys)
    np.testing.assert_array_equal(np.asarray(ks), keys[p])
    np.testing.assert_array_equal(np.asarray(vs), values[p])


@pytest.mark.parametrize("method", METHODS)
def test_pairs_pytree_payload(method):
    # Extension: arbitrary pytree payloads ride the permutation.
    n = 4_321
    keys = random_keys(np.uint32, n, seed=8) % np.uint32(16)
    values = {"idx": np.arange(n, dtype=np.int32), "w": np.linspace(0, 1, n, dtype=np.float32)}
    ks, vs = thrs.sort_pairs(jnp.asarray(keys), jax.tree.map(jnp.asarray, values), method=method)
    p = oracle_perm(keys)
    np.testing.assert_array_equal(np.asarray(vs["idx"]), values["idx"][p])
    np.testing.assert_array_equal(np.asarray(vs["w"]), values["w"][p])


@pytest.mark.parametrize("method", METHODS)
def test_pairs_descending_stability(method):
    n = 10_000
    keys = (random_keys(np.uint32, n, seed=4) % np.uint32(8)).astype(np.uint32)
    values = np.arange(n, dtype=np.uint32)
    ks, vs = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values), order="descending", method=method)
    want_k, want_v = oracle_sort_pairs(keys, values, descending=True)
    np.testing.assert_array_equal(np.asarray(ks), want_k)
    np.testing.assert_array_equal(np.asarray(vs), want_v)


def test_sort_indices_matches_oracle_perm():
    n = 8_192
    keys = random_keys(np.float32, n, seed=5)
    keys[::7] = 1.5  # duplicates
    perm = np.asarray(thrs.sort_indices(jnp.asarray(keys), method="counting"))
    np.testing.assert_array_equal(perm, oracle_perm(keys))


# ---------------------------------------------------------------------------
# stable=False: permits any order among ties; the sort stays stable
# ---------------------------------------------------------------------------

def _check_unstable(keys, values, got_k, got_v, descending=False):
    """Keys sorted + (key, value) multiset preserved (order among ties free)."""
    bits = thrs.np_key_bits(keys, descending=descending)
    got_bits = thrs.np_key_bits(got_k, descending=descending)
    assert np.all(got_bits[1:] >= got_bits[:-1]), "keys not sorted"
    a = np.stack([bits.astype(np.uint64), np.asarray(values, np.uint64)], 1)
    b = np.stack([got_bits.astype(np.uint64),
                  np.asarray(got_v, np.uint64)], 1)
    a = a[np.lexsort(a.T[::-1])]
    b = b[np.lexsort(b.T[::-1])]
    np.testing.assert_array_equal(a, b, "pair multiset not preserved")


def test_pairs_unstable_all_equal_keys_permutation():
    """All-ones keys everywhere: every comparison is a tie; the payloads
    must still come back as a permutation."""
    n = 2048
    keys = np.full(n, 0xFFFFFFFF, np.uint32)
    values = np.arange(n, dtype=np.uint32)
    k, v = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                           stable=False)
    np.testing.assert_array_equal(np.asarray(k), keys)
    np.testing.assert_array_equal(np.sort(np.asarray(v)), values)


def test_pairs_unstable_u64_payload():
    n = 1024
    keys = (random_keys(np.uint64, n, seed=7) % np.uint64(8))
    values = random_keys(np.uint64, n, seed=8)
    k, v = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                           stable=False)
    _check_unstable(keys, values, np.asarray(k), np.asarray(v))


def test_pairs_unstable_batched():
    B, nr = 5, 512
    keys = (random_keys(np.uint32, B * nr, seed=3) % np.uint32(4)).reshape(B, nr)
    values = np.broadcast_to(np.arange(nr, dtype=np.uint32), (B, nr)).copy()
    k, v = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                           stable=False)
    for r in range(B):
        _check_unstable(keys[r], values[r], np.asarray(k)[r], np.asarray(v)[r])


def test_pairs_unstable_nonpow2_stays_stable():
    """stable=False stays stable: output is bit-exactly the stable
    result."""
    n = 3000
    keys = (random_keys(np.uint32, n, seed=5) % np.uint32(8))
    values = np.arange(n, dtype=np.uint32)
    k, v = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                           stable=False)
    want_k, want_v = oracle_sort_pairs(keys, values)
    np.testing.assert_array_equal(np.asarray(k), want_k)
    np.testing.assert_array_equal(np.asarray(v), want_v)


def test_pairs_unstable_f32_zeros_exact_false():
    """Float pairs with stable=False and zeros_exact=False: keys come back
    sorted and the pair multiset is preserved (the single-device sort
    keeps -0.0 bit-exactly)."""
    n = 2048
    keys = np.random.default_rng(11).standard_normal(n).astype(np.float32)
    keys[:64] = -0.0
    keys[64:128] = 0.0
    values = np.arange(n, dtype=np.uint32)
    k, v = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                           stable=False, zeros_exact=False)
    k = np.asarray(k)
    _check_unstable(keys, values, k, np.asarray(v))
    p = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(k.view(np.uint32), keys[p].view(np.uint32))
