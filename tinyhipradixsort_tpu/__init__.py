"""tinyhipradixsort_tpu — a stable radix-semantics sort engine in JAX.

A from-scratch JAX/XLA re-design of the capability set of
``Ushio/tinyhipradixsort`` (single-header GPU LSD radix sort): stable LSD radix
sort of 32/64-bit integer and float keys (order-preserving bit-flip transform
for floats), keys-only and key-value sorting with arbitrary payloads,
ascending/descending order, and partial bit windows — scaled out to multi-device
meshes via shard_map collectives (``tinyhipradixsort_tpu.parallel``).

This package requires 64-bit JAX types for u64/f64 keys and therefore enables
``jax_enable_x64`` at import.
"""

import jax as _jax

_jax.config.update("jax_enable_x64", True)

from .config import Config, KeyType, SortOrder, ValueType, temporary_buffer_bytes
from .keybits import key_bits, key_bits_inverse, np_key_bits, np_key_bits_inverse
from .sort import (RadixSort, segment_ids_from_offsets, sort_indices,
                   sort_keys, sort_pairs)
from .parallel import make_sort_mesh, psort_indices, psort_keys, psort_pairs

__version__ = "0.1.0"

__all__ = [
    "Config",
    "KeyType",
    "RadixSort",
    "SortOrder",
    "ValueType",
    "key_bits",
    "key_bits_inverse",
    "make_sort_mesh",
    "np_key_bits",
    "np_key_bits_inverse",
    "psort_indices",
    "psort_keys",
    "psort_pairs",
    "segment_ids_from_offsets",
    "sort_indices",
    "sort_keys",
    "sort_pairs",
    "temporary_buffer_bytes",
    "__version__",
]
