"""Shared engine plumbing: digit plans, padding, window math.

Engines sort by an unsigned *bits* array (produced by
:func:`tinyhipradixsort_tpu.keybits.key_bits`) over a bit window
``[start_bit, end_bit)``, carrying an arbitrary list of same-length arrays
(the original keys, payloads, indices) through the stable permutation.

The reference hard-codes 8-bit digits and requires the window to be a multiple
of 8 (reference: tinyhipradixsort.hpp:856). Here the window may be any width;
the plan packs 8-bit digits from the LSB upward with one narrower top digit for
the remainder — stability makes any digit decomposition produce the identical
result to a single stable sort on the whole window.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

RADIX_BITS = 8


def digit_plan(start_bit: int, end_bit: int, radix_bits: int = RADIX_BITS) -> list[tuple[int, int]]:
    """Return [(shift, bits), ...] LSD-first digit passes covering the window."""
    if not 0 <= start_bit < end_bit <= 64:
        raise ValueError(f"invalid bit window [{start_bit}, {end_bit})")
    plan = []
    shift = start_bit
    while shift < end_bit:
        width = min(radix_bits, end_bit - shift)
        plan.append((shift, width))
        shift += width
    return plan


def resolve_window(key_dtype, start_bit, end_bit) -> tuple[int, int]:
    width = np.dtype(key_dtype).itemsize * 8
    if end_bit is None:
        end_bit = width
    start_bit = int(start_bit)
    end_bit = int(end_bit)
    if not 0 <= start_bit < end_bit <= width:
        raise ValueError(
            f"bit window [{start_bit}, {end_bit}) out of range for {width}-bit keys"
        )
    return start_bit, end_bit


def window_values(bits: jnp.ndarray, start_bit: int, end_bit: int) -> jnp.ndarray:
    """Extract the sort window as a value (used by single-shot argsort engine)."""
    nbits = bits.dtype.itemsize * 8
    if start_bit == 0 and end_bit == nbits:
        return bits
    udt = bits.dtype
    mask = udt.type((1 << (end_bit - start_bit)) - 1) if end_bit - start_bit < nbits else ~udt.type(0)
    return (bits >> udt.type(start_bit)) & mask


def extract_digit(bits: jnp.ndarray, shift: int, width: int) -> jnp.ndarray:
    """Extract an int32 digit in [0, 2**width) at bit offset ``shift``."""
    udt = bits.dtype
    d = (bits >> udt.type(shift)) & udt.type((1 << width) - 1)
    return d.astype(jnp.int32)


def pad_to_multiple(x: jnp.ndarray, multiple: int, fill):
    """Pad 1-D array to a multiple of ``multiple`` with ``fill`` (static shapes)."""
    n = x.shape[0]
    npad = -(-max(n, 1) // multiple) * multiple
    if npad == n:
        return x
    return jnp.concatenate([x, jnp.full((npad - n,), fill, dtype=x.dtype)])

