"""A shared on-disk cache of the kernel libraries (serving cold start).

The port of the JAX package's ``utils/compile_cache.py``. There, the cold
start is XLA's compile of the window and train programs, and JAX's
persistent compilation cache keeps the compiled executables on disk. The
port runs eager PyTorch, so its one compile per process is nvcc's build of
``csrc/`` (``kernels/build.py``): every source, in parallel, at the first
kernel call. By default the libraries go to the package's ``_build/``, so
each fresh checkout or container builds them again. With the cache enabled
they go to a directory shared across processes and checkouts, and a
process that finds its libraries there loads them and runs no nvcc.

Safe by construction, as JAX's: a library's file name is the hash of its
source, the shared headers, the nvcc flags and nvcc's ``--version`` text,
so an edit or another toolkit misses (and builds) rather than loading a
stale library; each library is written to a temporary file and renamed
into place, so concurrent processes never read a partial one.

Enabling applies to the builds after the call: once a process has loaded
the libraries (its first kernel call), they stay loaded from where they
were built, as JAX's cache applies only to later compiles. JAX's
``min_compile_time_secs`` has no counterpart: it keeps small, fast
compiles out of XLA's cache, and every nvcc build here takes seconds.

Used by ``run.py --compile_cache [DIR]`` and ``training/train.py
--compile_cache [DIR]``, and honoured by any entry point that calls
``maybe_enable_from_env`` through the ``VDA_COMPILE_CACHE`` variable (a
directory, or "1" for ``DEFAULT_DIR``).
"""
from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(os.path.expanduser("~"), ".cache", "video_depth_anything_torch",
                           "kernels")

_ENV_VAR = "VDA_COMPILE_CACHE"


def enable_compile_cache(cache_dir: str | None = None) -> str:
    """Build and load the kernel libraries in ``cache_dir`` (created if
    absent; None or "" selects ``DEFAULT_DIR``). Returns the directory."""
    from ..kernels import build

    d = os.path.abspath(os.path.expanduser(cache_dir or DEFAULT_DIR))
    os.makedirs(d, exist_ok=True)
    build.BUILD_DIR = d
    return d


def maybe_enable_from_env() -> str | None:
    """Enable the cache iff ``VDA_COMPILE_CACHE`` is set (a path, or "1").
    Returns the cache directory when enabled, else None."""
    val = os.environ.get(_ENV_VAR)
    if not val:
        return None
    return enable_compile_cache(None if val == "1" else val)
