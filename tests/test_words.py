"""u32 word codecs of the distributed sort (ops/words.py) and psort's
word-tuple search."""

import numpy as np
import jax.numpy as jnp
import pytest

from tinyhipradixsort_tpu.ops import words
from tinyhipradixsort_tpu.parallel import psort

RNG = np.random.default_rng(0x1E57)


@pytest.mark.parametrize("dtype,shape", [
    (np.uint32, (100,)), (np.float32, (100,)), (np.int32, (100,)),
    (np.uint64, (100,)), (np.int64, (100,)), (np.float64, (100,)),
    (np.uint8, (100,)), (np.uint16, (100,)), (np.uint32, (100, 4)),
])
def test_word_codec_roundtrip(dtype, shape):
    dt = np.dtype(dtype)
    if dt.kind == "f":
        a = RNG.standard_normal(shape).astype(dt)
    else:
        a = RNG.integers(0, np.iinfo(dt).max, size=shape, dtype=dt,
                         endpoint=True)
    ws, recipe = words.array_to_words(jnp.asarray(a))
    recipe["nwords"] = len(ws)
    back = np.asarray(words.words_to_array(ws, recipe))
    view = {4: np.uint32, 8: np.uint64, 1: np.uint8, 2: np.uint16}[dt.itemsize]
    np.testing.assert_array_equal(back.view(view), a.view(view))


@pytest.mark.parametrize("dtype", [np.float64, np.float16])
def test_word_codec_float_specials_bit_exact(dtype):
    # NaN payloads of both signs, -0.0 and denormals survive the codec
    dt = np.dtype(dtype)
    raw = RNG.integers(0, 2 ** (dt.itemsize * 8), size=4096, dtype=np.uint64)
    a = raw.astype(f"u{dt.itemsize}").view(dt)
    ws, recipe = words.array_to_words(jnp.asarray(a))
    back = np.asarray(words.words_to_array(ws, recipe))
    np.testing.assert_array_equal(back.view(f"u{dt.itemsize}"),
                                  a.view(f"u{dt.itemsize}"))


def test_split_join_u64_roundtrip():
    x = RNG.integers(0, 2**64, size=1000, dtype=np.uint64)
    hi, lo = words.split_u64(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(hi), (x >> 32).astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(lo), x.astype(np.uint32))
    np.testing.assert_array_equal(np.asarray(words.join_u64(hi, lo)), x)


@pytest.mark.parametrize("start,end,nwords", [
    (0, 64, 2), (8, 40, 1), (20, 61, 2), (0, 32, 1)])
def test_bits_to_cmp_words_orders_like_window(start, end, nwords):
    # the word tuple (hi first) orders exactly like the windowed bits
    bits = RNG.integers(0, 2**64, size=3000, dtype=np.uint64)
    if end <= 32:
        bits = bits.astype(np.uint32)
    ws = [np.asarray(w) for w in words.bits_to_cmp_words(
        jnp.asarray(bits), start, end)]
    assert len(ws) == nwords and all(w.dtype == np.uint32 for w in ws)
    width = end - start
    u = bits.dtype.type
    window = (bits >> u(start)) & u((1 << width) - 1)
    np.testing.assert_array_equal(np.lexsort(tuple(reversed(ws))),
                                  np.argsort(window, kind="stable"))


def test_searchsorted_words_matches_numpy():
    n, q = 5000, 257
    hi = RNG.integers(0, 8, size=n, dtype=np.uint32)  # many ties in hi word
    lo = RNG.integers(0, 2**32, size=n, dtype=np.uint32)
    order = np.lexsort((lo, hi))
    hi, lo = hi[order], lo[order]
    qh = RNG.integers(0, 8, size=q, dtype=np.uint32)
    ql = RNG.integers(0, 2**32, size=q, dtype=np.uint32)
    got = np.asarray(psort._searchsorted_words(
        [jnp.asarray(hi), jnp.asarray(lo)], [jnp.asarray(qh), jnp.asarray(ql)]))
    packed = (hi.astype(np.uint64) << 32) | lo
    qpacked = (qh.astype(np.uint64) << 32) | ql
    want = np.searchsorted(packed, qpacked, side="left")
    np.testing.assert_array_equal(got, want)
