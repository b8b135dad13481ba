"""Stable sort engines built on XLA's native sort.

Two engines:

* ``argsort``: one stable argsort of the masked bit window, then a single
  gather of every carried array. The engine every public entry point uses
  (``method="auto"``), and the semantic ground truth — any digit
  decomposition must match this exactly.
* ``lsd_argsort``: an LSD pass loop (one stable argsort per 8-bit digit),
  mirroring the reference's per-digit pass structure
  (reference: tinyhipradixsort.hpp:867-933) with XLA sort standing in for the
  histogram/scan/reorder kernels. Used to cross-check pass-loop plumbing.

These run on any backend. On an NVIDIA GPU, XLA can hand a single-key
ascending sort to CUB's device radix sort.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import common


def sort_arrays_argsort(bits, arrays, start_bit, end_bit):
    window = common.window_values(bits, start_bit, end_bit)
    src = jnp.argsort(window, stable=True)
    return [a[src] for a in arrays]


def sort_arrays_lsd_argsort(bits, arrays, start_bit, end_bit, radix_bits=common.RADIX_BITS):
    for shift, width in common.digit_plan(start_bit, end_bit, radix_bits):
        digit = common.extract_digit(bits, shift, width)
        src = jnp.argsort(digit, stable=True)
        bits = bits[src]
        arrays = [a[src] for a in arrays]
    return arrays
