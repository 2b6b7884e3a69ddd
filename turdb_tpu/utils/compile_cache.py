"""Where JAX keeps its persistent compilation cache.

`use_compile_cache()` is called once at start-up by the entry points that
compile large programs (`chip_smoke.py`, `bench.py`, `python -m
turdb_tpu.cli`). Importing the package sets nothing.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# A fixed path inside the checkout: the cache key includes the directory,
# so a path that moves between runs never hits. `.gitignore` lists it.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def use_compile_cache() -> str:
    """Point the persistent compilation cache at its directory and return
    that directory. When `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it
    itself and this sets nothing; otherwise the cache goes to
    `<checkout>/.jax_cache`."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
