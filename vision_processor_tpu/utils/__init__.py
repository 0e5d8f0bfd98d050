from pathlib import Path

from . import log  # noqa: F401

CHECKOUT = Path(__file__).resolve().parents[2]


def setup_compile_cache() -> None:
    """Keep XLA's compiled programs in a persistent cache.

    JAX reads JAX_COMPILATION_CACHE_DIR itself, so when it is set nothing
    is done here. Otherwise the cache is ``<checkout>/.jax_cache``: a fixed
    path, so every run of this checkout finds what an earlier run compiled.
    Entry points call this before their first compile.
    """
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT / ".jax_cache"))
