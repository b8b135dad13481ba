"""u32 word codecs for the distributed sort.

:mod:`..parallel.psort` moves every array through its exchange as a list of
uint32 words: compare words (window key bits, then the global index
tie-break) and carry words (original keys, payload leaves). These helpers
split arrays into words and rebuild them bit-exactly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from . import common

# Pad fill of compare words: sorts after every real tuple. A host-side
# scalar (not jnp): a module-level device constant would initialize the XLA
# backend at import and break jax.distributed.initialize.
SENTINEL = np.uint32(0xFFFFFFFF)


def split_u64(x):
    """u64 array -> (hi, lo) u32 words."""
    lo = (x & jnp.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    hi = (x >> jnp.uint64(32)).astype(jnp.uint32)
    return hi, lo


def join_u64(hi, lo):
    return (hi.astype(jnp.uint64) << jnp.uint64(32)) | lo.astype(jnp.uint64)


def array_to_words(a) -> tuple[list, dict]:
    """Decompose an array (leading axis n) into uint32 words + recipe."""
    dtype = np.dtype(a.dtype)
    if a.ndim == 1:
        if dtype.itemsize == 8:
            u = a if dtype.kind == "u" else jax.lax.bitcast_convert_type(
                a, jnp.uint64)
            hi, lo = split_u64(u)
            return [hi, lo], {"kind": "64", "dtype": dtype}
        if dtype.itemsize == 4:
            return [_bitcast_u32(a)], {"kind": "32", "dtype": dtype}
        if dtype.itemsize == 2:
            # bit-exact widen: bitcast to u16 then zero-extend (preserves
            # NaN payload bits of f16/bf16, unlike a value cast)
            u = jax.lax.bitcast_convert_type(a, jnp.uint16).astype(jnp.uint32)
            return [u], {"kind": "narrow16", "dtype": dtype}
        if dtype.itemsize == 1:
            u = a.astype(jnp.uint32 if dtype.kind in "ui" else jnp.float32)
            return [_bitcast_u32(u)], {"kind": "narrow", "dtype": dtype}
        raise TypeError(f"unsupported payload dtype {dtype}")
    if a.ndim == 2 and dtype.itemsize == 4:
        return [_bitcast_u32(a[:, i]) for i in range(a.shape[1])], {
            "kind": "2d32", "dtype": dtype, "cols": a.shape[1]}
    raise TypeError(f"unsupported payload array: shape {a.shape} dtype {dtype}")


def _bitcast_u32(a):
    if np.dtype(a.dtype) == np.uint32:
        return a
    return jax.lax.bitcast_convert_type(a, jnp.uint32)


def words_to_array(words: list, recipe: dict):
    dtype = recipe["dtype"]
    kind = recipe["kind"]
    if kind == "64":
        u = join_u64(words[0], words[1])
        return u if dtype.kind == "u" else jax.lax.bitcast_convert_type(
            u, dtype)
    if kind == "32":
        return _bitcast_from_u32(words[0], dtype)
    if kind == "narrow16":
        return jax.lax.bitcast_convert_type(
            words[0].astype(jnp.uint16), dtype)
    if kind == "narrow":
        wide = _bitcast_from_u32(words[0], np.dtype(np.uint32) if dtype.kind in "ui" else np.dtype(np.float32))
        return wide.astype(dtype)
    if kind == "2d32":
        return jnp.stack([_bitcast_from_u32(w, dtype) for w in words], axis=1)
    raise AssertionError(kind)


def _bitcast_from_u32(w, dtype):
    dtype = np.dtype(dtype)
    if dtype == np.uint32:
        return w
    return jax.lax.bitcast_convert_type(w, dtype)


def bits_to_cmp_words(bits, start_bit: int, end_bit: int) -> list:
    """Window-extracted key bits -> list of u32 compare words (hi first)."""
    window = common.window_values(bits, start_bit, end_bit)
    width = end_bit - start_bit
    if np.dtype(window.dtype) == np.uint32:
        return [window]
    if width <= 32:
        return [window.astype(jnp.uint32)]
    hi, lo = split_u64(window)
    return [hi, lo]
