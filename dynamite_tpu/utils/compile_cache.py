"""
Where JAX keeps its persistent compilation cache for this repository's
scripts (``bench.py``, ``chip_smoke.py``).

``JAX_COMPILATION_CACHE_DIR``, when set, is the only cache directory: JAX
reads it at import and nothing here overrides it. Otherwise the cache goes
to ``.jax_cache`` at the root of the checkout. The path is part of the
cache's key, so it is fixed rather than temporary.
"""

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = 'JAX_COMPILATION_CACHE_DIR'


def cache_dir(environ=None):
    """The cache directory in effect for the given environment."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or os.path.join(REPO_ROOT, '.jax_cache')


def enable_compile_cache():
    """Turn on the persistent cache for this process; returns its path.

    Entries of any size are kept once compiling took half a second, so the
    large engine programs are the ones found again on the next run."""
    import jax
    path = cache_dir()
    if not os.environ.get(ENV_VAR):
        jax.config.update('jax_compilation_cache_dir', path)
    jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)
    jax.config.update('jax_persistent_cache_min_compile_time_secs', 0.5)
    return path
