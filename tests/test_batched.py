"""Batched (2-D row-wise) sort tests — extension.

Each row of a (B, n) key array sorts independently (the engines vmap the
row sort). Oracles: numpy axis-1 sorts.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import tinyhipradixsort_tpu as thrs

RNG = np.random.default_rng(0xBA7C)


def _rand(dtype, shape):
    dtype = np.dtype(dtype)
    if dtype.kind == "f":
        x = RNG.standard_normal(shape).astype(dtype)
        x[RNG.random(shape) < 0.05] = 0.0
        x[RNG.random(shape) < 0.05] = -0.0
        return x
    info = np.iinfo(dtype)
    return RNG.integers(info.min, info.max, size=shape, dtype=dtype,
                        endpoint=True)


def _oracle_rows(x, descending=False):
    bits = thrs.np_key_bits(x, descending=descending)
    perm = np.argsort(bits, axis=1, kind="stable")
    return np.take_along_axis(x, perm, 1), perm


@pytest.mark.parametrize("method", ["argsort"])
@pytest.mark.parametrize("shape", [(4, 256), (6, 500), (1, 700), (37, 33)])
def test_batched_sort_keys_u32(method, shape):
    x = _rand(np.uint32, shape)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x), method=method))
    np.testing.assert_array_equal(got, np.sort(x, axis=1))


@pytest.mark.parametrize("dtype", [np.float32, np.uint64, np.int32])
@pytest.mark.parametrize("order", ["ascending", "descending"])
def test_batched_sort_keys_dtypes(dtype, order):
    x = _rand(dtype, (5, 300))
    got = np.asarray(thrs.sort_keys(jnp.asarray(x), order=order))
    want, _ = _oracle_rows(x, descending=(order == "descending"))
    u = np.uint32 if np.dtype(dtype).itemsize == 4 else np.uint64
    np.testing.assert_array_equal(got.view(u), want.view(u))


@pytest.mark.parametrize("method", ["argsort"])
def test_batched_sort_pairs_stability(method):
    B, n = 6, 400
    x = (_rand(np.uint32, (B, n)) % 7).astype(np.uint32)  # heavy duplicates
    v = np.broadcast_to(np.arange(n, dtype=np.uint32), (B, n)).copy()
    k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v), method=method)
    want, perm = _oracle_rows(x)
    np.testing.assert_array_equal(np.asarray(k), want)
    np.testing.assert_array_equal(np.asarray(vv), np.take_along_axis(v, perm, 1))


def test_batched_sort_indices():
    B, n = 4, 513
    x = (_rand(np.uint32, (B, n)) % 16).astype(np.uint32)
    perm = np.asarray(thrs.sort_indices(jnp.asarray(x)))
    np.testing.assert_array_equal(perm, np.argsort(x, axis=1, kind="stable"))


def test_batched_float_neg_zero_bit_exact():
    row = np.array([1.0, -0.0, 0.0, -0.0, 0.0, -1.0, 0.0, -0.0] * 16,
                   dtype=np.float32)
    x = np.stack([row, row[::-1], np.roll(row, 3)])
    got = np.asarray(thrs.sort_keys(jnp.asarray(x)))
    want, _ = _oracle_rows(x)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_batched_window():
    B, n = 3, 333
    x = _rand(np.uint32, (B, n))
    v = np.broadcast_to(np.arange(n, dtype=np.uint32), (B, n)).copy()
    k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                            start_bit=8, end_bit=16)
    digit = (x >> 8) & 0xFF
    perm = np.argsort(digit, axis=1, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), np.take_along_axis(x, perm, 1))
    np.testing.assert_array_equal(np.asarray(vv), np.take_along_axis(v, perm, 1))


@pytest.mark.parametrize("shape", [(3, 0), (3, 1), (0, 5), (1, 1)])
def test_batched_degenerate(shape):
    x = _rand(np.uint32, shape)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x)))
    np.testing.assert_array_equal(got, np.sort(x, axis=1))


def test_batched_value_shape_mismatch():
    x = _rand(np.uint32, (3, 8))
    with pytest.raises(ValueError):
        thrs.sort_pairs(jnp.asarray(x), jnp.zeros((3, 9), jnp.uint32))


def test_3d_keys_rejected():
    with pytest.raises(ValueError):
        thrs.sort_keys(jnp.zeros((2, 3, 4), jnp.uint32))


def test_batched_nonpow2_batch_pairs_public_api():
    """A non-power-of-two batch of short rows, with payload stability
    across heavy duplicates."""
    B, n = 136, 33
    x = (_rand(np.uint32, (B, n)) % 5).astype(np.uint32)
    v = np.broadcast_to(np.arange(n, dtype=np.uint32), (B, n)).copy()
    k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v))
    want, perm = _oracle_rows(x)
    np.testing.assert_array_equal(np.asarray(k), want)
    np.testing.assert_array_equal(np.asarray(vv), np.take_along_axis(v, perm, 1))
