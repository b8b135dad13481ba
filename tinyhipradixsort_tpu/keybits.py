"""Order-preserving key-bit transforms.

Maps sort keys of any supported dtype to unsigned integer bits whose *unsigned*
ascending order equals the desired key order. This is the analogue of the
reference's ``getKeyBits`` overloads (reference: kernel.cu:46-69, fpKey.hpp:15-38):

* u32/u64: identity (XOR all-ones for descending).
* f32/f64: IEEE-754 total-order bit flip — positive floats get the sign bit set,
  negative floats are bitwise inverted, so unsigned integer comparison of the
  result matches float comparison. ``-0.0`` is normalized to ``+0.0`` first so
  both zeros map to the same bits (reference: kernel.cu:56-57). NaNs follow
  their raw bit pattern: a positive-sign NaN sorts above +inf, a negative-sign
  NaN sorts below -inf (same semantics as the reference transform).
* i32/i64 (extension; the reference supports only unsigned ints): XOR the sign
  bit, the classic two's-complement to biased mapping.

Descending order is the post-flip bitwise complement (reference: kernel.cu:18-24
``ORDER_MASK``), which preserves stability with respect to input order.

The engines sort by these bits but always *carry the original key values*
through the permutation (the reference reorders the raw keys too), so ``-0.0``
and NaN payload bits are preserved in the output.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "key_bits",
    "key_bits_inverse",
    "bit_width",
    "dtype_kind",
    "supported_key_dtypes",
    "np_key_bits",
    "np_key_bits_inverse",
]


def dtype_kind(dtype) -> str:
    """numpy kind with ml_dtypes awareness (bfloat16 reports kind 'V')."""
    dtype = np.dtype(dtype)
    if dtype == np.dtype(jnp.bfloat16):
        return "f"
    return dtype.kind

def supported_key_dtypes() -> tuple[np.dtype, ...]:
    return (
        np.dtype(np.uint32),
        np.dtype(np.uint64),
        np.dtype(np.int32),
        np.dtype(np.int64),
        np.dtype(np.float32),
        np.dtype(np.float64),
        # 16-bit extension (no reference analogue). Bits ride in a u32 word.
        np.dtype(np.uint16),
        np.dtype(np.int16),
        np.dtype(np.float16),
        np.dtype(jnp.bfloat16),
    )


def bit_width(dtype) -> int:
    """Number of key bits for a supported key dtype (16, 32 or 64)."""
    dtype = np.dtype(dtype)
    if dtype not in supported_key_dtypes():
        raise TypeError(f"unsupported key dtype: {dtype}")
    return dtype.itemsize * 8


def _uint_dtype(nbits: int):
    # 16-bit keys carry their bits in a u32 word
    return jnp.uint64 if nbits == 64 else jnp.uint32


def key_bits(keys: jax.Array, *, descending: bool = False) -> jax.Array:
    """Transform keys to order-preserving unsigned bits (see module docstring)."""
    dtype = np.dtype(keys.dtype)
    nbits = bit_width(dtype)
    udt = _uint_dtype(nbits)
    ones = udt((1 << nbits) - 1)  # width mask (16-bit keys ride in u32)
    sign_bit = udt(1) << udt(nbits - 1)
    kind = dtype_kind(dtype)
    if kind == "u":
        bits = keys.astype(udt)
    elif kind == "i":
        if nbits == 16:
            u = jax.lax.bitcast_convert_type(keys, jnp.uint16).astype(udt)
        else:
            u = jax.lax.bitcast_convert_type(keys, udt)
        bits = u ^ sign_bit
    elif kind == "f":
        if nbits == 16:
            u = jax.lax.bitcast_convert_type(keys, jnp.uint16).astype(udt)
        else:
            u = jax.lax.bitcast_convert_type(keys, udt)
        # Normalize -0.0 -> +0.0. Done in the integer domain ((u << 1) == 0
        # under the width mask ignores the sign bit) so backends that flush
        # denormals in float comparisons (XLA:CPU) still match IEEE
        # semantics exactly.
        u = jnp.where(((u << udt(1)) & ones) == udt(0), udt(0), u)
        # Negative keys flip all bits; non-negative keys flip only the sign bit.
        negative = (u >> udt(nbits - 1)) != udt(0)
        bits = u ^ jnp.where(negative, ones, sign_bit)
    else:
        raise TypeError(f"unsupported key dtype: {dtype}")
    if descending:
        bits = bits ^ ones
    return bits


def key_bits_inverse_raw(bits: jax.Array, dtype, *,
                         descending: bool = False) -> jax.Array:
    """Invert :func:`key_bits` down to the key's *raw bit pattern* (an
    unsigned array; u32 for <=32-bit keys, u64 for 64-bit). Pure integer
    ops — composes with further integer patches (e.g. restoring ``-0.0``
    sign bits) without ever materializing a float array, which matters
    because XLA:CPU canonicalizes bf16/f16 NaN payloads and flushes
    denormals in several float ops."""
    dtype = np.dtype(dtype)
    nbits = bit_width(dtype)
    udt = _uint_dtype(nbits)
    ones = udt((1 << nbits) - 1)
    kind = dtype_kind(dtype)
    if descending:
        bits = bits ^ ones
    if kind == "u":
        return bits
    if kind == "i":
        return bits ^ (udt(1) << udt(nbits - 1))
    if kind == "f":
        sign_bit = udt(1) << udt(nbits - 1)
        was_negative = (bits & sign_bit) == udt(0)
        return jnp.where(was_negative, bits ^ ones, bits ^ sign_bit)
    raise TypeError(f"unsupported key dtype: {dtype}")


def raw_to_keys(raw: jax.Array, dtype) -> jax.Array:
    """Bitcast a raw-bit-pattern array (from :func:`key_bits_inverse_raw`)
    to the key dtype. The single float-producing op of the rebuild path."""
    dtype = np.dtype(dtype)
    nbits = bit_width(dtype)
    kind = dtype_kind(dtype)
    if kind == "u":
        return raw.astype(dtype)
    if nbits == 16:
        raw = raw.astype(jnp.uint16)
    return jax.lax.bitcast_convert_type(raw, dtype)


def key_bits_inverse(bits: jax.Array, dtype, *, descending: bool = False) -> jax.Array:
    """Invert :func:`key_bits` on device (jnp mirror of
    :func:`np_key_bits_inverse`). Exact for integer dtypes; for floats, any
    ``-0.0`` in the original keys comes back as ``+0.0`` (the forward
    transform normalizes zeros) — engines patch the sign back in the raw
    domain (:func:`key_bits_inverse_raw`) when bit-exact zeros are needed."""
    return raw_to_keys(
        key_bits_inverse_raw(bits, dtype, descending=descending), dtype)


def neg_zero_flag(keys: jax.Array) -> jax.Array:
    """uint32 1 where the float key is bitwise ``-0.0``, else 0."""
    dtype = np.dtype(keys.dtype)
    if dtype.itemsize == 2:
        u = jax.lax.bitcast_convert_type(keys, jnp.uint16)
        return (u == jnp.uint16(0x8000)).astype(jnp.uint32)
    udt = _uint_dtype(dtype.itemsize * 8)
    u = jax.lax.bitcast_convert_type(keys, udt)
    return (u == udt(1) << udt(dtype.itemsize * 8 - 1)).astype(jnp.uint32)


def np_key_bits_inverse(bits: np.ndarray, dtype, *, descending: bool = False) -> np.ndarray:
    """Invert :func:`np_key_bits`: recover keys from transformed bits.

    Lossless except that ``-0.0`` came out of the forward transform normalized
    to ``+0.0`` (by design). Host-side adapter: sort ``np_key_bits(keys)`` on
    the device as plain unsigned integers and rebuild the keys here.
    """
    dtype = np.dtype(dtype)
    nbits = bit_width(dtype)
    udt = np.uint64 if nbits == 64 else np.uint32
    narrow = np.uint16 if nbits == 16 else udt
    ones = udt((1 << nbits) - 1)
    kind = dtype_kind(dtype)
    bits = bits.astype(udt, copy=False)
    if descending:
        bits = bits ^ ones
    if kind == "u":
        return bits.astype(dtype, copy=False)
    if kind == "i":
        return (bits ^ udt(1 << (nbits - 1))).astype(narrow).view(dtype)
    if kind == "f":
        sign_bit = udt(1 << (nbits - 1))
        was_negative = (bits & sign_bit) == 0
        u = np.where(was_negative, bits ^ ones, bits ^ sign_bit)
        return u.astype(narrow).view(dtype)
    raise TypeError(f"unsupported key dtype: {dtype}")


def np_key_bits(keys: np.ndarray, *, descending: bool = False) -> np.ndarray:
    """Pure-numpy mirror of :func:`key_bits` (the CPU oracle; cf. fpKey.hpp)."""
    dtype = np.dtype(keys.dtype)
    nbits = bit_width(dtype)
    udt = np.uint64 if nbits == 64 else np.uint32
    narrow = np.uint16 if nbits == 16 else udt
    ones = udt((1 << nbits) - 1)
    kind = dtype_kind(dtype)
    if kind == "u":
        bits = keys.astype(udt)
    elif kind == "i":
        bits = keys.view(narrow).astype(udt) ^ udt(1 << (nbits - 1))
    elif kind == "f":
        u = keys.view(narrow).astype(udt)
        u = np.where(((u << udt(1)) & ones) == udt(0), udt(0), u)
        negative = (u >> udt(nbits - 1)) != 0
        bits = u ^ np.where(negative, ones, udt(1 << (nbits - 1)))
    else:
        raise TypeError(f"unsupported key dtype: {dtype}")
    if descending:
        bits = bits ^ ones
    return bits
