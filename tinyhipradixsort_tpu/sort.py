"""Public sort API.

Functional, dtype-driven equivalents of the reference host API
(reference: tinyhipradixsort.hpp:845-852 ``sortKeys``/``sortPairs``):

* :func:`sort_keys`    — stable radix sort of a key array.
* :func:`sort_pairs`   — stable key-value sort; values may be any array (or
  pytree of arrays) whose leading axis matches the keys (superset of the
  reference's 4/8/16-byte payloads).
* :func:`sort_indices` — the stable sorting permutation (argsort by key bits).
* :class:`RadixSort`   — thin config-holding wrapper for reference-API parity.

All functions are jit-compatible and also pre-jitted for eager use; each
distinct (dtypes, order, bit window, method) combination is one XLA trace —
the analogue of the reference's per-config RTC compile (hpp:751-804).

The sort itself is XLA's stable sort (:mod:`.ops.argsort_engine`). On an
NVIDIA GPU, XLA can lower a single-key sort to CUB's device radix sort —
the reference's own yardstick (cudaEnv.cu:85-117).

Semantics contract (identical to the reference):

* Stable: equal keys (equal *window* bits) preserve input order.
* Sorts by the key-bit transform of :mod:`..keybits`; original key values
  (including ``-0.0`` and NaN payloads) are carried through unchanged.
* ``start_bit``/``end_bit`` restrict sorting to the bit window
  ``[start_bit, end_bit)`` of the transformed key bits. The reference requires
  the window to be byte-aligned (hpp:856); here any window is allowed.
* Descending order is the bitwise complement of the transform — still stable.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import keybits
from .config import Config, SortOrder
from .ops import argsort_engine, common, counting_engine

__all__ = ["sort_keys", "sort_pairs", "sort_indices", "RadixSort",
           "segment_ids_from_offsets"]


def segment_ids_from_offsets(offsets, n: int):
    """CUB-style segment description -> ``segment_ids`` array.

    ``offsets``: non-decreasing segment start offsets (any 1-D int array,
    with or without the leading 0 / trailing ``n``). Returns an int32 array
    of length ``n`` where element ``i`` holds the index of the segment
    containing ``i``, with empty *leading* segments collapsed to index 0
    (the labeling is monotone and groups exactly like
    cub::DeviceSegmentedRadixSort's ``d_begin_offsets``; only the grouping
    matters to :func:`sort_keys`' ``segment_ids=``).
    """
    offsets = jnp.asarray(offsets)
    if offsets.ndim != 1:
        raise ValueError(f"offsets must be 1-D, got shape {offsets.shape}")
    ids = jnp.searchsorted(
        offsets, jnp.arange(n, dtype=offsets.dtype), side="right")
    # normalize away boundaries at/before position 0 (e.g. an explicit
    # leading 0) so element 0 always gets id 0 — static-shape equivalent of
    # stripping the leading zeros
    ids = ids - jnp.searchsorted(offsets, offsets.dtype.type(0), side="right")
    return ids.astype(jnp.int32)

# "counting" and "lsd_argsort" mirror the reference's per-digit pass
# structure; they are cross-checks for the tests, not speed paths.
_ENGINES = ("auto", "argsort", "counting", "lsd_argsort")


def _resolve_method(method: str) -> str:
    if method not in _ENGINES:
        raise ValueError(f"unknown method {method!r}; expected one of {_ENGINES}")
    return "argsort" if method == "auto" else method


def _sort_arrays(bits, arrays, start_bit, end_bit, method):
    if method == "argsort":
        return argsort_engine.sort_arrays_argsort(bits, arrays, start_bit, end_bit)
    if method == "lsd_argsort":
        return argsort_engine.sort_arrays_lsd_argsort(bits, arrays, start_bit, end_bit)
    if method == "counting":
        return counting_engine.sort_arrays_counting(bits, arrays, start_bit, end_bit)
    raise ValueError(f"unknown method {method!r}")


_STATIC = ("descending", "start_bit", "end_bit", "method", "want")


@functools.partial(jax.jit, static_argnames=_STATIC)
def _sort_entry(keys, values, *, descending, start_bit, end_bit, method, want,
                segment_ids=None):
    """want: subset of {'keys','values','indices'} controlling outputs."""
    n = keys.shape[0]
    leaves, treedef = [], None
    if "values" in want:
        leaves, treedef = jax.tree.flatten(values)
        for leaf in leaves:
            if leaf.shape[: keys.ndim] != keys.shape:
                raise ValueError(
                    f"value leading axes {leaf.shape[: keys.ndim]} != "
                    f"keys shape {keys.shape}"
                )
    seg_bits = (None if segment_ids is None
                else keybits.key_bits(segment_ids))

    bits = keybits.key_bits(keys, descending=descending)
    # 16-bit float keys: carry the (integer) bits + a -0.0 flag instead of
    # the float array and rebuild after the sort. XLA:CPU canonicalizes
    # bf16/f16 NaN payload bits and flushes denormals in several float ops
    # (pad fills, scatters, selects) — and rewrites bitcast-wrapped chains
    # back into the float domain, so the only robust form is to never
    # materialize a 16-bit float array between the first and last bitcast.
    dt = np.dtype(keys.dtype)
    f16_keys = ("keys" in want and dt.itemsize == 2
                and keybits.dtype_kind(dt) == "f")
    arrays = []
    if "keys" in want:
        if f16_keys:
            arrays.append(bits)
            arrays.append(keybits.neg_zero_flag(keys))
        else:
            arrays.append(keys)
    arrays.extend(leaves)
    if "indices" in want:
        idx_dt = jnp.int32 if keys.shape[-1] < 2**31 else jnp.int64
        arrays.append(jnp.broadcast_to(
            jnp.arange(keys.shape[-1], dtype=idx_dt), keys.shape))

    seg_width = (0 if seg_bits is None
                 else np.dtype(seg_bits.dtype).itemsize * 8)

    def row_sort(b, sb, *arrs):
        arrs = list(arrs)
        if sb is None:
            return tuple(_sort_arrays(b, arrs, start_bit, end_bit, method))
        # segmented: two stable passes (LSD composition) — by key bits,
        # then by segment bits
        out1 = _sort_arrays(b, arrs + [sb], start_bit, end_bit, method)
        return tuple(_sort_arrays(out1[-1], out1[:-1], 0, seg_width, method))

    if keys.ndim == 2:
        # batched rows: vmap the whole row sort
        out = jax.vmap(row_sort)(bits, seg_bits, *arrays)
    else:
        out = row_sort(bits, seg_bits, *arrays)

    result = []
    pos = 0
    if "keys" in want:
        if f16_keys:
            sorted_bits, flag = out[0], out[1]
            raw = keybits.key_bits_inverse_raw(
                sorted_bits, dt, descending=descending)
            sign = raw.dtype.type(1 << 15)
            raw = jnp.where(flag == 1, raw | sign, raw)
            result.append(keybits.raw_to_keys(raw, dt))
            pos = 2
        else:
            result.append(out[pos])
            pos += 1
    if "values" in want:
        result.append(jax.tree.unflatten(treedef, out[pos : pos + len(leaves)]))
        pos += len(leaves)
    if "indices" in want:
        result.append(out[pos])
    return tuple(result)


# donating variant: the caller's key/value buffers are reused in place --
# the functional spelling of the reference's result-replaces-input contract
# (hpp:936-943); it frees one input-sized buffer of device memory.
_sort_entry_donated = jax.jit(
    _sort_entry.__wrapped__, static_argnames=_STATIC, donate_argnums=(0, 1))


def _prep(keys, order, start_bit, end_bit):
    keys = jnp.asarray(keys)
    if keys.ndim not in (1, 2):
        raise ValueError(
            f"keys must be 1-D (single sort) or 2-D (batched row-wise "
            f"sorts), got shape {keys.shape}")
    descending = SortOrder.parse(order).descending
    start_bit, end_bit = common.resolve_window(keys.dtype, start_bit, end_bit)
    return keys, descending, start_bit, end_bit


def _prep_segments(segment_ids, keys):
    """Validate/normalize ``segment_ids`` to a key_bits-supported int array."""
    if segment_ids is None:
        return None
    seg = jnp.asarray(segment_ids)
    if seg.shape != keys.shape:
        raise ValueError(
            f"segment_ids shape {seg.shape} != keys shape {keys.shape}")
    dt = np.dtype(seg.dtype)
    if dt.kind not in "iu":
        raise TypeError(f"segment_ids must be integers, got {dt}")
    if dt.itemsize < 4:
        seg = seg.astype(jnp.int32)
    return seg


def sort_keys(keys, *, order="ascending", start_bit=0, end_bit=None,
              method="auto", zeros_exact=True, segment_ids=None,
              donate=False):
    """Stable radix sort of ``keys``; returns the sorted array.

    Reference parity: ``RadixSort::sortKeys`` (hpp:845-848). The result
    replaces the input buffer there; here it is returned functionally.

    2-D ``keys`` are a *batch*: each row is sorted independently
    (extension; no reference counterpart).

    ``segment_ids`` (keys-shaped integers) selects a *segmented* sort —
    elements order by ``(segment_id, key)``, stable; with non-decreasing ids
    this sorts each segment in place (cub::DeviceSegmentedRadixSort
    analogue; no reference counterpart). Segment ids always order
    ascending; ``order`` applies to keys within a segment.

    ``zeros_exact`` is accepted for compatibility with :func:`psort_keys`;
    the single-device sort carries the original keys, so ``-0.0`` always
    comes back bit-exactly.

    ``donate=True`` reuses the input buffer in place (it becomes invalid
    afterwards) — the functional spelling of the reference's
    result-replaces-input contract (hpp:936-943); it saves one input-sized
    buffer of device memory on the largest sorts.
    """
    keys, descending, start_bit, end_bit = _prep(keys, order, start_bit, end_bit)
    method = _resolve_method(method)
    entry = _sort_entry_donated if donate else _sort_entry
    (out,) = entry(
        keys, None, descending=descending, start_bit=start_bit, end_bit=end_bit,
        method=method, want=("keys",),
        segment_ids=_prep_segments(segment_ids, keys),
    )
    return out


def sort_pairs(keys, values, *, order="ascending", start_bit=0, end_bit=None,
               method="auto", segment_ids=None, donate=False, stable=True,
               zeros_exact=True):
    """Stable key-value sort; returns ``(sorted_keys, reordered_values)``.

    ``values`` may be a single array or a pytree of arrays sharing the keys'
    leading axis (reference: ``sortPairs``, hpp:849-852, limited there to
    4/8/16-byte payloads; u128 payloads map to shape ``(n, 4)`` uint32).
    2-D keys sort each row independently; value leaves then share the
    leading ``(B, n)`` axes.

    ``stable=False`` permits (does not require) arbitrary order among
    equal keys; the sort stays stable. ``zeros_exact`` has
    :func:`sort_keys` semantics: keys, ``-0.0`` included, come back
    bit-exactly.
    """
    keys, descending, start_bit, end_bit = _prep(keys, order, start_bit, end_bit)
    method = _resolve_method(method)
    values = jax.tree.map(jnp.asarray, values)
    entry = _sort_entry_donated if donate else _sort_entry
    out_keys, out_values = entry(
        keys, values, descending=descending, start_bit=start_bit, end_bit=end_bit,
        method=method, want=("keys", "values"),
        segment_ids=_prep_segments(segment_ids, keys),
    )
    return out_keys, out_values


def sort_indices(keys, *, order="ascending", start_bit=0, end_bit=None,
                 method="auto", segment_ids=None, donate=False):
    """The stable sorting permutation: ``keys[perm]`` is sorted (stable argsort
    by transformed key bits). Extension with no reference analogue —
    equivalent to ``sort_pairs(keys, iota)[1]``. 2-D keys return the per-row
    permutation (``jnp.take_along_axis(keys, perm, 1)`` is row-sorted).
    ``donate=True`` reuses the key buffer (see :func:`sort_keys`); the perm
    dtype is i32 for n < 2**31 and i64 beyond."""
    keys, descending, start_bit, end_bit = _prep(keys, order, start_bit, end_bit)
    method = _resolve_method(method)
    entry = _sort_entry_donated if donate else _sort_entry
    (perm,) = entry(
        keys, None, descending=descending, start_bit=start_bit, end_bit=end_bit,
        method=method, want=("indices",),
        segment_ids=_prep_segments(segment_ids, keys),
    )
    return perm


class RadixSort:
    """Config-holding wrapper mirroring ``thrs::RadixSort`` (hpp:694-948).

    Construction is free (no RTC compile — jit tracing happens on first call
    per shape). ``temporary_buffer_bytes`` documents the transient footprint
    for parity with ``getTemporaryBufferBytes`` (hpp:833-843).
    """

    def __init__(self, config: Config | None = None, method: str = "auto"):
        self.config = config or Config()
        self.method = method

    def _kw(self, start_bit, end_bit):
        return dict(
            order=self.config.order,
            start_bit=start_bit,
            end_bit=end_bit,
            method=self.method,
        )

    def sort_keys(self, keys, start_bit: int = 0, end_bit: int | None = None):
        keys = jnp.asarray(keys)
        if np.dtype(keys.dtype) != self.config.key_type.dtype:
            raise TypeError(
                f"keys dtype {keys.dtype} != configured {self.config.key_type.dtype}"
            )
        return sort_keys(keys, **self._kw(start_bit, end_bit))

    def sort_pairs(self, keys, values, start_bit: int = 0, end_bit: int | None = None):
        keys = jnp.asarray(keys)
        if np.dtype(keys.dtype) != self.config.key_type.dtype:
            raise TypeError(
                f"keys dtype {keys.dtype} != configured {self.config.key_type.dtype}"
            )
        return sort_pairs(keys, values, **self._kw(start_bit, end_bit))

    def temporary_buffer_bytes(self, n: int) -> int:
        from .config import temporary_buffer_bytes

        return temporary_buffer_bytes(n, self.config)
