"""Sort configuration types.

Analogue of the reference's ``thrs::RadixSort::Config`` type system
(reference: tinyhipradixsort.hpp:638-749). Where the reference RTC-compiles one
GPU module per (key type, value type, order, alignment) combination, here each
distinct configuration is simply a distinct ``jax.jit`` cache entry — the
specialization mechanism is the XLA trace cache.

The functional API (:func:`tinyhipradixsort_tpu.sort_keys` etc.) usually infers
everything from array dtypes; ``Config``/``RadixSort`` exist for explicit
configuration and reference-API parity.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
from jax.numpy import bfloat16 as _jnp_bfloat16

__all__ = ["KeyType", "ValueType", "SortOrder", "Config", "temporary_buffer_bytes"]


class KeyType(enum.Enum):
    """Key dtypes (reference: hpp:638-644; I32/I64 and the 16-bit entries
    are extensions)."""

    U32 = np.dtype(np.uint32)
    U64 = np.dtype(np.uint64)
    F32 = np.dtype(np.float32)
    F64 = np.dtype(np.float64)
    I32 = np.dtype(np.int32)
    I64 = np.dtype(np.int64)
    U16 = np.dtype(np.uint16)
    I16 = np.dtype(np.int16)
    F16 = np.dtype(np.float16)
    BF16 = np.dtype(_jnp_bfloat16)

    @classmethod
    def from_dtype(cls, dtype) -> "KeyType":
        dtype = np.dtype(dtype)
        for kt in cls:
            if kt.value == dtype:
                return kt
        raise TypeError(f"unsupported key dtype: {dtype}")

    @property
    def dtype(self) -> np.dtype:
        return self.value

    @property
    def bits(self) -> int:
        return self.value.itemsize * 8


class ValueType(enum.Enum):
    """Payload width classes (reference: hpp:645-650).

    This build is more general: any array (any dtype / trailing shape) whose
    leading axis matches the keys can ride along as the payload. These enum
    members only classify byte width for reference parity / scratch estimates.
    U128 is represented as shape ``(n, 4)`` uint32 (the reference lowers u128 to
    ``uint4``, hpp:779).
    """

    U32 = 4
    U64 = 8
    U128 = 16

    @property
    def bytes(self) -> int:
        return self.value


class SortOrder(enum.Enum):
    """Ascending/descending (reference: hpp:679-683)."""

    ASCENDING = "ascending"
    DESCENDING = "descending"

    @classmethod
    def parse(cls, order) -> "SortOrder":
        if isinstance(order, SortOrder):
            return order
        if isinstance(order, str):
            low = order.lower()
            for member in cls:
                if member.value == low:
                    return member
        raise ValueError(f"unknown sort order: {order!r} (use 'ascending' or 'descending')")

    @property
    def descending(self) -> bool:
        return self is SortOrder.DESCENDING


@dataclasses.dataclass(frozen=True)
class Config:
    """Sort configuration (reference: hpp:697-749 ``RadixSort::Config``).

    ``key_is_16byte_aligned`` was a GPU vectorized-load hint (hpp:700); it is
    accepted for parity but has no effect (XLA manages layout).
    """

    key_type: KeyType = KeyType.U32
    value_type: ValueType | None = None
    order: SortOrder = SortOrder.ASCENDING
    key_is_16byte_aligned: bool = True

    @classmethod
    def for_keys(cls, key_dtype, order=SortOrder.ASCENDING) -> "Config":
        """Analogue of ``configureWithKey<K>()`` (hpp:707-725)."""
        return cls(key_type=KeyType.from_dtype(key_dtype), order=SortOrder.parse(order))

    @classmethod
    def for_key_pairs(cls, key_dtype, value_bytes: int, order=SortOrder.ASCENDING) -> "Config":
        """Analogue of ``configureWithKeyPair<K, V>()`` (hpp:727-748)."""
        return cls(
            key_type=KeyType.from_dtype(key_dtype),
            value_type=ValueType(value_bytes),
            order=SortOrder.parse(order),
        )


# Tile size of the scratch estimate below: elements per histogram/reorder
# tile (analogue of RADIX_SORT_BLOCK_SIZE=2048, reference: hpp:19).
DEFAULT_TILE = 32768
RADIX_BITS = 8
NUM_BUCKETS = 1 << RADIX_BITS


def temporary_buffer_bytes(n: int, config: Config | None = None, tile: int = DEFAULT_TILE) -> int:
    """Scratch estimate for an ``n``-element sort (parity with
    ``getTemporaryBufferBytes``, reference: hpp:806-843).

    JAX manages buffers functionally, so nothing needs to be pre-allocated by
    the caller; this documents the transient device footprint of one digit pass:
    the ping-pong key (and value) buffer plus the ``[256, num_tiles]`` count
    matrix.
    """
    config = config or Config()
    num_tiles = -(-max(n, 1) // tile)
    psum = 4 * NUM_BUCKETS * num_tiles
    key_out = config.key_type.dtype.itemsize * n
    value_out = (config.value_type.bytes if config.value_type else 0) * n

    def align16(x: int) -> int:
        return (x + 15) // 16 * 16

    return align16(psum) + align16(key_out) + align16(value_out)
