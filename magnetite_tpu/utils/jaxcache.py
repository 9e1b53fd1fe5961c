"""Persistent XLA compilation cache location.

JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when it is set, nothing here
touches the cache. Otherwise the cache goes to one fixed directory inside the
checkout, ``<checkout>/.jax_cache`` (listed in .gitignore): the directory is
part of what a later process must find again, so it never depends on the
user, the temp dir, the pid or the time.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache(min_compile_secs: float = 1.0) -> str:
    """Point JAX's persistent compile cache at `CACHE_DIR` unless the
    environment or the caller already chose a directory; returns the
    directory in use. Nothing calls this at import."""
    import jax

    configured = jax.config.jax_compilation_cache_dir
    if configured or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return configured or os.environ["JAX_COMPILATION_CACHE_DIR"]
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
    jax.config.update(
        "jax_persistent_cache_min_compile_time_secs", float(min_compile_secs)
    )
    return CACHE_DIR


def ensure_default_cache() -> None:
    """The library's compile entry points (fem/solve.compile_problem, the
    parallel/sweep compilers) engage the cache on accelerator backends, so
    a fresh process does not pay the large cold compiles again.

    CPU backends are left alone: CPU compiles are local and fast, and XLA's
    CPU cache loads log machine-feature-mismatch noise to stderr, which
    would dirty CLI output for every CPU user."""
    import jax

    if jax.default_backend() != "cpu":
        enable_persistent_cache()
