"""JAX persistent compilation cache for the command-line entry points.

Called by ``chip_smoke.py``, ``bench.py`` and ``ectrans_tpu/programs/*``
before their first compilation; never at library import and never by the
tests.  Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
nothing else is configured.  Otherwise the cache lives at a fixed path inside
the checkout (``<repo>/.jax_cache``, listed in ``.gitignore``): the
directory is part of the cache key, so it must not move between runs.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir(environ=os.environ) -> pathlib.Path:
    """The directory the persistent compilation cache uses."""
    env = environ.get("JAX_COMPILATION_CACHE_DIR")
    return pathlib.Path(env) if env else DEFAULT_DIR


def enable_compile_cache() -> pathlib.Path:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    path = cache_dir()
    if "JAX_COMPILATION_CACHE_DIR" not in os.environ:
        jax.config.update("jax_compilation_cache_dir", str(path))
    return path
