"""Where the port keeps what it compiles: its build cache.

The reference's ``utils/cache.py`` points JAX's persistent compilation
cache at a directory, first thing in its CLI. The port compiles nothing
through XLA. What it caches are its own shared libraries: the CUDA kernels
(``kernels/build.py``, into ``<dir>/kernels``; ``kernel_lab``'s builds
into ``<dir>/lab``) and the native host runtime (``native/``, into
``<dir>/native``). The directory defaults to ``build/`` at the root of the
checkout (listed in ``.gitignore``). ``NGPD_TORCH_BUILD_DIR`` in the
environment, the port's counterpart of ``JAX_COMPILATION_CACHE_DIR``,
wins. Each library's file name carries a hash of its source and flags, so
a directory shared by several checkouts never serves a stale build.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "NGPD_TORCH_BUILD_DIR"
_ROOT = Path(__file__).resolve().parents[2]


def default_cache_dir() -> str:
    """``build/`` at the root of this checkout."""
    return str(_ROOT / "build")


def cache_dir() -> Path:
    """The build cache in use: ``$NGPD_TORCH_BUILD_DIR``, else
    ``default_cache_dir()``. Read at each build, so a change takes effect
    for the next library that is built."""
    return Path(os.environ.get(ENV_VAR) or default_cache_dir())


def enable_compilation_cache(path: str | None = None) -> str:
    """Point the kernel and native builds at ``path`` (default:
    ``default_cache_dir()``) and return the directory in use. An explicit
    ``NGPD_TORCH_BUILD_DIR`` in the environment wins, as
    ``JAX_COMPILATION_CACHE_DIR`` does in the reference."""
    os.environ.setdefault(ENV_VAR, str(path or default_cache_dir()))
    return os.environ[ENV_VAR]
