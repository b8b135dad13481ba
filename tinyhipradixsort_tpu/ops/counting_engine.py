"""Tiled counting-sort engine in pure jnp (backend-portable fallback).

Mirrors the reference's three-stage pass pipeline exactly, in functional form
(reference: tinyhipradixsort.hpp:867-933, kernel.cu:73-103/136-204/206-429):

1. per-tile histogram of the current digit       (<- blockCount)
2. bucket-major exclusive scan of ``[B, T]``     (<- prefixSumExclusiveInplace;
   the counter layout ``counterIndex = bucket * numTiles + tile`` is the
   reference's, kernel.cu:97, so a flat exclusive scan yields per-(bucket,tile)
   global base offsets directly)
3. stable rank within tile + scatter             (<- reorderKey/reorderKeyPair;
   per-warp match-mask ranking becomes a one-hot cumulative sum)

Ranking is vectorized (one-hot cumsum per tile under ``lax.map`` to bound the
transient footprint); the permutation is applied as one scatter building the
inverse permutation followed by gathers, which XLA handles on every backend. A cross-check engine for the tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import common

DEFAULT_TILE = 2048  # reference RADIX_SORT_BLOCK_SIZE (hpp:19); fine for the jnp tier.


def _index_dtype(n: int):
    return jnp.int32 if n < 2**31 else jnp.int64


def _pass_inverse_perm(digits, num_buckets: int, idx_dt):
    """digits: (T, tile) int32 -> src indices (T*tile,) such that out = x[src]."""
    T, tile = digits.shape
    bucket_ids = jnp.arange(num_buckets, dtype=jnp.int32)

    def tile_stats(d_row):
        onehot = (d_row[:, None] == bucket_ids[None, :]).astype(idx_dt)
        csum = jnp.cumsum(onehot, axis=0)
        rank = jnp.take_along_axis(csum, d_row[:, None].astype(idx_dt), axis=1)[:, 0] - 1
        return csum[-1], rank

    counts, rank = jax.lax.map(tile_stats, digits)  # (T, B), (T, tile)

    # Bucket-major exclusive scan: base[b, t] = global start of tile t's run of
    # digit b in the output (reference layout, kernel.cu:97).
    flat = counts.T.reshape(-1)
    base = jnp.concatenate([jnp.zeros((1,), idx_dt), jnp.cumsum(flat)[:-1].astype(idx_dt)])
    base_tb = base.reshape(num_buckets, T).T  # (T, B)

    dest = jnp.take_along_axis(base_tb, digits, axis=1) + rank  # (T, tile)
    iota = jnp.arange(T * tile, dtype=idx_dt)
    src = jnp.zeros((T * tile,), idx_dt).at[dest.reshape(-1)].set(
        iota, unique_indices=True, mode="promise_in_bounds"
    )
    return src


def sort_arrays_counting(
    bits,
    arrays,
    start_bit: int,
    end_bit: int,
    radix_bits: int = common.RADIX_BITS,
    tile: int = DEFAULT_TILE,
):
    n = bits.shape[0]
    if n <= 1:
        return list(arrays)
    idx_dt = _index_dtype(n)
    # Padding sorts to the tail: all-ones bits take the max digit in every pass
    # and stability keeps them after all real elements.
    bits_p = common.pad_to_multiple(bits, tile, ~bits.dtype.type(0))
    arrays_p = [common.pad_to_multiple(a, tile, a.dtype.type(0)) if a.ndim == 1
                else _pad_rows(a, tile) for a in arrays]
    T = bits_p.shape[0] // tile

    for shift, width in common.digit_plan(start_bit, end_bit, radix_bits):
        digits = common.extract_digit(bits_p, shift, width).reshape(T, tile)
        src = _pass_inverse_perm(digits, 1 << width, idx_dt)
        bits_p = bits_p[src]
        arrays_p = [a[src] for a in arrays_p]

    return [a[:n] for a in arrays_p]


def _pad_rows(a, multiple: int):
    n = a.shape[0]
    npad = -(-max(n, 1) // multiple) * multiple
    if npad == n:
        return a
    pad_widths = [(0, npad - n)] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad_widths)
