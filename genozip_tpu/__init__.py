"""genozip_tpu: lossless genomic compression (ZIP/PIZ pipelines, codecs,
native host runtime, device coders in JAX)."""

import os

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def setup_compile_cache():
    """Keep JAX's persistent compile cache in JAX_COMPILATION_CACHE_DIR when
    that is set (JAX reads it itself), else in .jax_cache/ at the root of
    the checkout: one fixed path, so a later process finds what an earlier
    one compiled."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(_ROOT, ".jax_cache"))
