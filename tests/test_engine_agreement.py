"""Cross-engine agreement: argsort (the engine ``auto`` runs), lsd_argsort
and counting against the numpy oracle over dtype x order x bit window —
the combinations test_sort_keys / test_startbits leave out (descending
signed and float keys, windows over signed and float key bits, windows
read in descending order). Pairs with a sequential payload make the
stability contract observable."""

import zlib

import numpy as np
import jax.numpy as jnp
import pytest

import tinyhipradixsort_tpu as thrs
from tinyhipradixsort_tpu.utils.prng import random_keys
from oracles import oracle_perm

ENGINES = ["argsort", "lsd_argsort", "counting"]
DTYPES = ["int32", "int64", "float32", "float64"]
# (order, window) — window as fractions of the key width; None = full.
# Full-width ascending is test_sort_keys' case and is left out.
CASES = [("descending", None),
         ("ascending", "low"), ("descending", "low"),
         ("ascending", "straddle"), ("descending", "straddle")]


def _window(width, name):
    if name is None:
        return 0, None
    if name == "low":
        return 0, width // 2
    return width // 4 - 3, 3 * width // 4 + 5  # not byte-aligned


@pytest.mark.parametrize("order,window", CASES,
                         ids=[f"{o}-{w or 'full'}" for o, w in CASES])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("engine", ENGINES)
def test_engines_agree_with_oracle(engine, dtype, order, window):
    dt = np.dtype(dtype)
    seed = zlib.crc32(f"{engine}/{dtype}/{order}/{window}".encode())
    n = 1500 + seed % 1500
    keys = random_keys(dt, n, seed=seed)
    keys[::7] = keys[3]  # duplicates: ties must keep input order
    values = np.arange(n, dtype=np.uint32)
    start, end = _window(dt.itemsize * 8, window)
    k, v = thrs.sort_pairs(jnp.asarray(keys), jnp.asarray(values),
                           order=order, start_bit=start, end_bit=end,
                           method=engine)
    p = oracle_perm(keys, descending=order == "descending",
                    start_bit=start, end_bit=end)
    u = f"u{dt.itemsize}"
    np.testing.assert_array_equal(np.asarray(k).view(u), keys[p].view(u))
    np.testing.assert_array_equal(np.asarray(v), values[p])
