"""Timing, device description and compile-cache helpers for scripts.

Analogue of the reference's OroStopwatch event timing
(reference: unittest.cpp:513-520, main.cpp:154-167) plus jax.profiler trace
capture for per-kernel breakdowns (the reference's commented-out per-kernel
scaffolding, hpp:882-928, becomes a real profiler here).
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time

import jax
import numpy as np

__all__ = ["Stopwatch", "time_fn", "quartiles", "trace", "device_report",
           "enable_compile_cache"]

# <checkout>/.jax_cache: a fixed path, because the path is part of the
# persistent cache's key (a moving directory never hits)
_CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache for a script; returns the
    directory. ``JAX_COMPILATION_CACHE_DIR`` wins when set; otherwise the
    cache lives in ``.jax_cache`` at the root of this checkout. The library
    itself never sets a cache."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or _CHECKOUT_CACHE
    jax.config.update("jax_compilation_cache_dir", path)
    return path


class Stopwatch:
    """Wall-clock stopwatch around device work (OroStopwatch parity)."""

    def __init__(self):
        self._t0 = None
        self.elapsed_s = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self, result=None) -> float:
        if result is not None:
            jax.block_until_ready(result)
        self.elapsed_s = time.perf_counter() - self._t0
        return self.elapsed_s

    @property
    def ms(self) -> float:
        return self.elapsed_s * 1e3


def time_fn(fn, *args, reps: int = 5, warmup: int = 1) -> list[float]:
    """Wall seconds of each of ``reps`` calls of ``fn(*args)``, each timed up
    to ``block_until_ready`` after ``warmup`` untimed calls (compilation)."""
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return times


def quartiles(times) -> tuple[float, float, float]:
    """(q1, median, q3) of a list of timings."""
    q1, med, q3 = np.percentile(np.asarray(times, np.float64), [25, 50, 75])
    return float(q1), float(med), float(q3)


def device_report() -> dict:
    """The device as JAX reports it, plus the card's name and power limit as
    ``nvidia-smi`` reports them (``None`` where there is no nvidia-smi)."""
    devs = jax.devices()
    rep = {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
           "count": len(devs), "gpu_name": None, "power_limit": None,
           "nvidia_smi": None}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return rep
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if lines:
        rep["nvidia_smi"] = lines[0]
        name, _, limit = lines[0].rpartition(",")
        rep["gpu_name"], rep["power_limit"] = name.strip(), limit.strip()
    return rep


@contextlib.contextmanager
def trace(log_dir: str):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
