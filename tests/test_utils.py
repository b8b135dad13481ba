"""Profiling helpers + misc API smoke tests."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import tinyhipradixsort_tpu as thrs
from tinyhipradixsort_tpu.utils.profiling import (Stopwatch, device_report,
                                                  quartiles, time_fn)


def test_stopwatch():
    sw = Stopwatch().start()
    x = jnp.arange(1000)
    s = sw.stop(x * 2)
    assert s > 0 and sw.ms == s * 1e3


def test_time_fn_times_each_rep():
    x = jnp.arange(4096, dtype=jnp.uint32)
    times = time_fn(jax.jit(lambda a: a + 1), x, reps=3)
    assert len(times) == 3 and all(t > 0 for t in times)


def test_quartiles():
    assert quartiles([4.0, 1.0, 3.0, 2.0, 5.0]) == (2.0, 3.0, 4.0)


def test_device_report_names_the_device():
    rep = device_report()
    assert rep["platform"] == jax.devices()[0].platform
    assert rep["device_kind"] == jax.devices()[0].device_kind
    assert rep["count"] == len(jax.devices())
    # name and power limit come from nvidia-smi, or are None without it
    assert (rep["gpu_name"] is None) == (rep["nvidia_smi"] is None)


def test_radixsort_class_roundtrip():
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, size=4096, dtype=np.uint32)
    rs = thrs.RadixSort(thrs.Config.for_keys(np.uint32, order="descending"))
    got = np.asarray(rs.sort_keys(jnp.asarray(keys)))
    np.testing.assert_array_equal(got, np.sort(keys)[::-1])
    assert rs.temporary_buffer_bytes(4096) > 0


def test_wrong_dtype_class_raises():
    rs = thrs.RadixSort(thrs.Config.for_keys(np.uint32))
    with pytest.raises(TypeError):
        rs.sort_keys(jnp.zeros(8, jnp.float32))


def test_psort_rejects_2d():
    with pytest.raises(ValueError):
        thrs.psort_keys(jnp.zeros((4, 4), jnp.uint32))


def test_sort_pairs_length_mismatch():
    with pytest.raises(ValueError):
        thrs.sort_pairs(jnp.zeros(8, jnp.uint32), jnp.zeros(9, jnp.uint32))
