"""Where the repo's scripts keep JAX's persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR`` wins when it is set: JAX reads it itself, and
nothing here overrides it. Otherwise the cache lives at ``.jax_cache`` in the
repository root, found from this file's location — never from the working
directory — so every script of one checkout shares it."""

import os

import jax

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir():
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache():
    """turn the persistent cache on (before the first compile); returns
    its directory"""
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    return path
