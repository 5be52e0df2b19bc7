"""Persistent XLA compilation cache for the process-per-invocation surfaces.

The CLI runs one process per image (mirroring the reference binary), so
every invocation would re-pay the per-geometry XLA compile. JAX's persistent
compilation cache removes that across processes: compiled executables are
keyed by program hash and reloaded from disk.

Policy: enabled by the CLI/serve entry points only (a library import must
not mutate global JAX config or write to disk). Where
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no other
directory is set here; otherwise the cache lives at the fixed path
``<checkout>/.cache/jax`` (a fixed path, because the path is part of what a
later process must find again). ``IPT_COMPILE_CACHE=0`` disables it.
"""

from __future__ import annotations

import os

_DISABLE_VALUES = {"0", "off", "false", "no"}

# The checkout's gitignored cache root, shared with the native codec build
# and the sidecar stores.
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".cache",
)
DEFAULT_CACHE_DIR = os.path.join(CACHE_ROOT, "jax")


def enable_persistent_cache() -> str | None:
    """Turn on JAX's persistent compilation cache; return its directory.

    Returns None when disabled or when the default directory cannot be
    created: a cache is an optimization, not a dependency.
    """
    if os.environ.get("IPT_COMPILE_CACHE", "").strip().lower() in _DISABLE_VALUES:
        return None
    import jax

    cache_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not cache_dir:
        cache_dir = DEFAULT_CACHE_DIR
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError:
            return None
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # Cache every program: the CLI's per-geometry programs compile in about
    # a second each (below JAX's default threshold), yet dominate
    # one-process-per-file wall time.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    # A long-lived serving host sees many geometries: bound the cache
    # (LRU-evicted by JAX) so it cannot grow without limit.
    jax.config.update("jax_compilation_cache_max_size", 1 << 30)
    return cache_dir
