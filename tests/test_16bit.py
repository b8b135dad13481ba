"""16-bit key dtypes (u16/i16/f16/bf16) — extension.

No reference analogue (the reference sorts 32/64-bit keys only). Bits ride
in one u32 word. Bit-exactness here
is the hard part: XLA:CPU canonicalizes bf16/f16 NaN payload bits and
flushes denormals in several float ops, so key rebuilds stay in the integer
domain until a single final bitcast (see keybits.key_bits_inverse_raw).
"""

import numpy as np
import jax.numpy as jnp
import ml_dtypes
import pytest

import tinyhipradixsort_tpu as thrs
from tinyhipradixsort_tpu import keybits

RNG = np.random.default_rng(0x16B)
DTYPES = [np.dtype(np.uint16), np.dtype(np.int16), np.dtype(np.float16),
          np.dtype(ml_dtypes.bfloat16)]


def _rand_raw(n):
    # uniform raw u16 patterns: exercises NaNs (all payloads), denormals,
    # infs, and both zeros for the float views
    return RNG.integers(0, 2**16, size=n, dtype=np.uint16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("descending", [False, True])
def test_keybits_16_roundtrip_and_device_match(dtype, descending):
    x = _rand_raw(3000).view(dtype)
    nb = keybits.np_key_bits(x, descending=descending)
    jb = np.asarray(keybits.key_bits(jnp.asarray(x), descending=descending))
    np.testing.assert_array_equal(nb, jb)
    assert nb.dtype == np.uint32 and (nb <= 0xFFFF).all()
    inv = keybits.np_key_bits_inverse(nb, dtype, descending=descending)
    want = x.view(np.uint16).copy()
    if keybits.dtype_kind(dtype) == "f":
        want[want == 0x8000] = 0  # forward transform normalizes -0.0
    np.testing.assert_array_equal(inv.view(np.uint16), want)
    jinv = np.asarray(keybits.key_bits_inverse(
        jnp.asarray(nb), dtype, descending=descending))
    np.testing.assert_array_equal(jinv.view(np.uint16), inv.view(np.uint16))


def test_keybits_16_order_property():
    # a < b  <=>  bits(a) < bits(b) over finite values (reference
    # FPKeys.float property, unittest.cpp:81-94, at half width)
    for dtype in (np.dtype(np.float16), np.dtype(ml_dtypes.bfloat16)):
        x = _rand_raw(300).view(dtype)
        xf = x.astype(np.float32)
        fin = np.isfinite(xf)
        xf, b = xf[fin][:80], keybits.np_key_bits(x)[fin][:80]
        a1, a2 = np.meshgrid(xf, xf)
        b1, b2 = np.meshgrid(b, b)
        np.testing.assert_array_equal(a1 < a2, b1 < b2)


@pytest.mark.parametrize("method", ["argsort", "counting"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_keys_16_bit_exact(method, dtype):
    # raw-uniform data: NaN payloads and denormals must survive bit-exactly
    x = _rand_raw(4000).view(dtype)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x), method=method))
    p = np.argsort(keybits.np_key_bits(x), kind="stable")
    np.testing.assert_array_equal(got.view(np.uint16), x[p].view(np.uint16))


@pytest.mark.parametrize("method", ["argsort"])
def test_sort_keys_16_descending(method):
    x = _rand_raw(2000).view(np.float16)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x), order="descending",
                                    method=method))
    p = np.argsort(keybits.np_key_bits(x, descending=True), kind="stable")
    np.testing.assert_array_equal(got.view(np.uint16), x[p].view(np.uint16))


@pytest.mark.parametrize("method", ["argsort"])
def test_sort_pairs_16_keys_stability(method):
    x = (_rand_raw(2500) % 7).astype(np.uint16)
    v = np.arange(2500, dtype=np.uint32)
    k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v), method=method)
    p = np.argsort(x, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), x[p])
    np.testing.assert_array_equal(np.asarray(vv), v[p])


def test_sort_pairs_bf16_keys_with_payload():
    x = _rand_raw(1500).view(ml_dtypes.bfloat16)
    v = np.arange(1500, dtype=np.uint32)
    k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v))
    p = np.argsort(keybits.np_key_bits(x), kind="stable")
    np.testing.assert_array_equal(np.asarray(k).view(np.uint16),
                                  x[p].view(np.uint16))
    np.testing.assert_array_equal(np.asarray(vv), v[p])


def test_bf16_payload_bit_exact():
    # 16-bit float payloads ride through the gather bit-exactly: NaN
    # payload bits survive
    keys = RNG.integers(0, 2**32, size=1200, dtype=np.uint32)
    vraw = _rand_raw(1200)
    k, vv = thrs.sort_pairs(jnp.asarray(keys),
                            jnp.asarray(vraw.view(ml_dtypes.bfloat16)))
    p = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(vv).view(np.uint16), vraw[p])


def test_batched_16bit():
    x = _rand_raw(6 * 300).reshape(6, 300).view(np.float16)
    got = np.asarray(thrs.sort_keys(jnp.asarray(x)))
    bits = keybits.np_key_bits(x)
    p = np.argsort(bits, axis=1, kind="stable")
    want = np.take_along_axis(x, p, 1)
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))


def test_window_16bit():
    x = _rand_raw(1000).astype(np.uint16)
    v = np.arange(1000, dtype=np.uint32)
    k, vv = thrs.sort_pairs(jnp.asarray(x), jnp.asarray(v),
                            start_bit=4, end_bit=12)
    digit = (x.astype(np.uint32) >> 4) & 0xFF
    p = np.argsort(digit, kind="stable")
    np.testing.assert_array_equal(np.asarray(k), x[p])
    np.testing.assert_array_equal(np.asarray(vv), v[p])


def test_psort_16bit_cpu_mesh():
    from tinyhipradixsort_tpu.parallel import make_sort_mesh, psort_keys
    mesh = make_sort_mesh()
    x = _rand_raw(5000).view(ml_dtypes.bfloat16)
    got = np.asarray(psort_keys(jnp.asarray(x), mesh=mesh))
    p = np.argsort(keybits.np_key_bits(x), kind="stable")
    np.testing.assert_array_equal(got.view(np.uint16), x[p].view(np.uint16))
