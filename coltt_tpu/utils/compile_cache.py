"""One place that points JAX's persistent compilation cache at a directory.

Every entry point (the server, the bench scripts, ``chip_smoke.py``) calls
:func:`configure_compile_cache` before its first compile. The cache's
directory is part of what makes a later process find an entry, so it is
one fixed path: ``$JAX_COMPILATION_CACHE_DIR`` when that is set (JAX reads
the variable itself, and nothing is set in code), else ``.jax_cache`` at
the root of this checkout (git-ignored).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)

_HIT_EVENT = "/jax/compilation_cache/cache_hits"
_MISS_EVENT = "/jax/compilation_cache/cache_misses"


def configure_compile_cache() -> str:
    """Enable the persistent compilation cache; returns its directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # cache every compile: the serving shapes of a 1M-row store compile in
    # about a second each, below JAX's default 1 s threshold
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return DEFAULT_DIR


class CacheCounter:
    """Counts persistent-cache hits and misses from JAX's monitoring
    events, so a cold start is distinguishable from a cache that never
    hits. ``close()`` unregisters the listener."""

    def __init__(self):
        from jax._src import monitoring

        self.hits = 0
        self.misses = 0
        self._monitoring = monitoring
        monitoring.register_event_listener(self._on_event)

    def _on_event(self, event: str, **_kw) -> None:
        if event == _HIT_EVENT:
            self.hits += 1
        elif event == _MISS_EVENT:
            self.misses += 1

    def snapshot(self) -> dict:
        return {"hits": self.hits, "misses": self.misses}

    def close(self) -> None:
        self._monitoring.unregister_event_listener(self._on_event)
