"""Persistent XLA compile cache for runs from this checkout.

A cold 256^3 run spends a large share of its wall time compiling the window programs;
the cache keeps them across processes. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX
reads it itself and this module sets nothing. Otherwise the cache lives at a fixed
path, ``<repo root>/.jax_cache`` (listed in .gitignore): the directory is part of
what makes a later run find an entry, so it never depends on a temporary directory,
a process id or the time.
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> Path:
    """The directory compiled programs are cached in."""
    env = os.environ.get(ENV_VAR)
    return Path(env) if env else REPO_CACHE_DIR


def enable() -> Path:
    """Turn the cache on (before the first compilation) and return its directory."""
    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return cache_dir()
