"""Persistent compilation cache.

JAX's in-process jit cache does not survive the process, so every fresh
``python bench.py`` or CLI run would compile again. This module points
JAX's persistent compilation cache at one fixed directory, so a machine
compiles each program once. The directory is part of the cache key, so it
must not move between runs.

Reference analog: the FPGA flow's .aocx is compiled offline once and loaded
by the host at run time (/root/reference/OpenCL/host/src/main.cpp:236-247);
this is the JIT-world equivalent.
"""

from __future__ import annotations

import os

import jax

_ENV = "JAX_COMPILATION_CACHE_DIR"

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_persistent_cache() -> str | None:
    """Turn on the persistent compilation cache; return its directory.

    * ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, so nothing is
      set here and that directory is returned.
    * The CPU backend (``jax_platforms`` starting with ``cpu``): no cache
      (None). XLA:CPU executable (de)serialization segfaulted in this
      suite, both reading entries written on another machine and writing
      large executables.
    * Otherwise: ``<repo>/.jax_cache``.

    Reads the ``jax_platforms`` config value, never initializes a backend,
    so callers may still switch platforms afterwards. Safe to call more
    than once.
    """
    env = os.environ.get(_ENV)
    if env:
        return env
    if str(jax.config.values.get("jax_platforms") or "").startswith("cpu"):
        return None
    os.makedirs(DEFAULT_DIR, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
