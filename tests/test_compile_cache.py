"""The persistent compile-cache helper every entry point calls."""

import os
import pathlib
import tempfile

import jax
import pytest

from coltt_tpu.utils import compile_cache

_REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_cache_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in before.items():
        jax.config.update(k, v)


def test_env_var_is_used_and_nothing_is_set(monkeypatch, tmp_path,
                                            restore_cache_config):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_one_fixed_path_in_the_checkout(monkeypatch,
                                                   restore_cache_config):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.configure_compile_cache()
    assert path == str(_REPO / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    # same path on every call: nothing from a temp name, pid or clock
    assert compile_cache.configure_compile_cache() == path
    assert not path.startswith(tempfile.gettempdir())
    assert str(os.getpid()) not in path


def test_default_path_is_git_ignored():
    ignored = (_REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


def test_cache_counter_counts_events():
    from jax._src import monitoring

    counter = compile_cache.CacheCounter()
    try:
        monitoring.record_event("/jax/compilation_cache/cache_hits")
        monitoring.record_event("/jax/compilation_cache/cache_misses")
        monitoring.record_event("/jax/compilation_cache/cache_misses")
        monitoring.record_event("/jax/some/other_event")
        assert counter.snapshot() == {"hits": 1, "misses": 2}
    finally:
        counter.close()
    monitoring.record_event("/jax/compilation_cache/cache_hits")
    assert counter.hits == 1  # unregistered


@pytest.mark.parametrize("entry", [
    "coltt_tpu/__main__.py", "bench.py", "bench_bq.py", "bench_cflat.py",
    "bench_filtered.py", "bench_hnsw.py", "bench_pq.py", "chip_smoke.py",
])
def test_entry_points_use_the_helper(entry):
    src = (_REPO / entry).read_text()
    assert "configure_compile_cache()" in src
    assert "jax_compilation_cache_dir" not in src
