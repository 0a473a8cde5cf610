"""One rule for JAX's persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already uses it and nothing
else is set.  Otherwise the cache lives at a fixed path inside the checkout
(``.jax_cache/``, gitignored), set through ``jax.config`` so the rule holds
even when ``jax`` was imported before this package.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache(environ=os.environ) -> str:
    """Apply the rule above; returns the cache directory in use."""
    path = environ.get(ENV_VAR)
    if path:
        return path
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
