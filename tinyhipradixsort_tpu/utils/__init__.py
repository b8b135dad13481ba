"""Utilities: deterministic PRNG for tests/benchmarks, timing and device
helpers, native host oracle bridge."""

from .profiling import Stopwatch, time_fn, trace

__all__ = ["Stopwatch", "time_fn", "trace"]
