"""One engine, chosen in one place: ``auto`` is XLA's stable sort (argsort)
and psort's local sort is ``jnp.lexsort``; the removed ``pallas`` engine
raises. Also the scripts' compile-cache helper."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import tinyhipradixsort_tpu as thrs
from tinyhipradixsort_tpu import sort
from tinyhipradixsort_tpu.parallel import psort
from tinyhipradixsort_tpu.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
X = jnp.arange(16, dtype=jnp.uint32)


@pytest.mark.parametrize("call", [
    lambda m: thrs.sort_keys(X, method=m),
    lambda m: thrs.sort_pairs(X, X, method=m),
    lambda m: thrs.sort_indices(X, method=m),
    lambda m: thrs.psort_keys(X, method=m),
    lambda m: thrs.psort_pairs(X, X, method=m),
    lambda m: thrs.psort_indices(X, method=m),
], ids=["sort_keys", "sort_pairs", "sort_indices", "psort_keys",
        "psort_pairs", "psort_indices"])
def test_pallas_method_raises(call):
    with pytest.raises(ValueError, match="unknown method 'pallas'"):
        call("pallas")


def test_auto_resolves_to_argsort():
    assert sort._resolve_method("auto") == "argsort"
    for m in ("argsort", "counting", "lsd_argsort"):
        assert sort._resolve_method(m) == m


def test_psort_accepts_auto_and_lexsort_only():
    x = np.random.default_rng(3).integers(0, 2**32, 4000, dtype=np.uint32)
    for m in ("auto", "lexsort"):
        got = np.asarray(thrs.psort_keys(jnp.asarray(x), method=m))
        np.testing.assert_array_equal(got, np.sort(x))
    with pytest.raises(ValueError):
        thrs.psort_keys(jnp.asarray(x), method="argsort")


def _fresh_python(code):
    """stdout of ``code`` in a new interpreter, with no cache directory set
    from outside."""
    full = {k: v for k, v in os.environ.items()
            if k != "JAX_COMPILATION_CACHE_DIR"}
    full.update(JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], env=full, cwd=REPO,
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def test_import_pulls_in_no_pallas():
    out = _fresh_python(
        "import sys, tinyhipradixsort_tpu as t\n"
        "t.sort_keys(t.psort_keys([3, 1, 2]))\n"
        "print(sorted(m for m in sys.modules if 'pallas' in m))")
    assert out.strip() == "[]"


def test_library_sets_no_compile_cache():
    out = _fresh_python(
        "import jax, tinyhipradixsort_tpu as t\n"
        "t.sort_keys([3, 1, 2])\n"
        "print(jax.config.jax_compilation_cache_dir)")
    assert out.strip() == "None"


def test_compile_cache_env_var_wins(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert profiling.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defaults_into_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = profiling.enable_compile_cache()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_checkout_cache_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
