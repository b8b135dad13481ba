"""Segmented sort tests (cub::DeviceSegmentedRadixSort analogue).

Contract: elements order by ``(segment_id, key)``, stable; with
non-decreasing ids each segment sorts in place. Oracle: numpy stable lexsort.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import tinyhipradixsort_tpu as thrs

RNG = np.random.default_rng(0x5E9)


def _oracle(seg, keys, descending=False):
    bits = thrs.np_key_bits(keys, descending=descending)
    # np.lexsort: last key is primary; stable
    return np.lexsort((bits, seg))


def _rand_segments(n, nseg):
    seg = np.sort(RNG.integers(0, nseg, size=n).astype(np.int32))
    return seg


@pytest.mark.parametrize("method", ["argsort", "counting"])
def test_segmented_keys_u32(method):
    n = 2000
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    seg = _rand_segments(n, 17)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x), segment_ids=jnp.asarray(seg),
                                    method=method))
    np.testing.assert_array_equal(got, x[_oracle(seg, x)])


@pytest.mark.parametrize("dtype", [np.float32, np.uint64])
@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_segmented_keys_dtypes(dtype, order):
    n = 1200
    if np.dtype(dtype).kind == "f":
        x = RNG.standard_normal(n).astype(dtype)
        x[RNG.random(n) < 0.1] = -0.0
        x[RNG.random(n) < 0.1] = 0.0
    else:
        x = RNG.integers(0, 2**64, size=n, dtype=dtype)
    seg = _rand_segments(n, 9)
    desc = order == "descending"
    got = np.asarray(thrs.sort_keys(jnp.asarray(x), order=order,
                                    segment_ids=jnp.asarray(seg)))
    want = x[_oracle(seg, x, descending=desc)]
    u = np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64
    np.testing.assert_array_equal(got.view(u), want.view(u))


@pytest.mark.parametrize("method", ["argsort"])
def test_segmented_pairs_stability(method):
    n = 1500
    x = (RNG.integers(0, 5, size=n)).astype(np.uint32)  # heavy duplicates
    seg = _rand_segments(n, 6)
    v = np.arange(n, dtype=np.uint32)
    k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                            segment_ids=jnp.asarray(seg), method=method)
    p = _oracle(seg, x)
    np.testing.assert_array_equal(np.asarray(k), x[p])
    np.testing.assert_array_equal(np.asarray(vv), v[p])


def test_segmented_indices():
    n = 900
    x = (RNG.integers(0, 9, size=n)).astype(np.uint32)
    seg = _rand_segments(n, 5)
    perm = np.asarray(thrs.sort_indices(jnp.asarray(x),
                                        segment_ids=jnp.asarray(seg)))
    np.testing.assert_array_equal(perm, _oracle(seg, x))


def test_segmented_unsorted_ids_groups():
    # ids need not be pre-grouped: output orders by (id, key)
    n = 800
    x = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    seg = RNG.integers(-3, 4, size=n).astype(np.int32)  # signed, ungrouped
    got = np.asarray(thrs.sort_keys(jnp.asarray(x),
                                    segment_ids=jnp.asarray(seg)))
    np.testing.assert_array_equal(got, x[_oracle(seg, x)])


def test_segmented_batched_rows():
    # segments within batched rows compose
    B, n = 3, 400
    x = RNG.integers(0, 2**32, size=(B, n), dtype=np.uint32)
    seg = np.sort(RNG.integers(0, 5, size=(B, n)).astype(np.int32), axis=1)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x),
                                    segment_ids=jnp.asarray(seg)))
    for b in range(B):
        np.testing.assert_array_equal(got[b], x[b][_oracle(seg[b], x[b])])


def test_segment_ids_from_offsets():
    n = 10
    for offs in ([0, 3, 7], [3, 7], [0, 0, 3, 7, 10]):
        ids = np.asarray(thrs.segment_ids_from_offsets(
            jnp.asarray(np.array(offs, np.int32)), n))
        # exact ids for [0,3) [3,7) [7,10): leading-0 conventions normalize
        # so element 0 is always in segment 0
        want = [0] * 3 + [1] * 4 + [2] * 3
        assert ids.tolist() == want, (offs, ids)


def test_segmented_validation():
    x = jnp.zeros(8, jnp.uint32)
    with pytest.raises(ValueError):
        thrs.sort_keys(x, segment_ids=jnp.zeros(9, jnp.int32))
    with pytest.raises(TypeError):
        thrs.sort_keys(x, segment_ids=jnp.zeros(8, jnp.float32))
    # narrow int ids upcast fine
    out = thrs.sort_keys(x, segment_ids=jnp.zeros(8, jnp.uint8))
    np.testing.assert_array_equal(np.asarray(out), np.zeros(8, np.uint32))
