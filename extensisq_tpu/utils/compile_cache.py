"""Where JAX keeps its persistent compilation cache for this repo's
scripts.

Importing the library sets no cache; the entry scripts (``chip_smoke.py``,
``bench.py``, ``validation/benchmarks.py``) call
:func:`enable_compile_cache` before their first compilation.
"""
import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def enable_compile_cache(root=_CHECKOUT):
    """Use ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it
    itself), else the fixed directory ``<root>/.jax_cache``.  A fixed
    path matters: the cache directory is part of what a later run must
    find again.  Returns the directory in use."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if path:
        return path
    path = os.path.join(root, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path
