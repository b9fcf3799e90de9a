"""Where the port's CUDA kernels are built and cached.

Counterpart of ``gsplat_tpu/utils/compile_cache.py``. The JAX package
points XLA's persistent compilation cache at a directory; the port's
cached compilations are its kernel libraries, which ``ops/_build.py``
builds with nvcc at first use into ``BUILD_ROOT/<name>-<hash>/`` (keyed by
the sources and flags) and loads from there afterwards. By default that is
``gsplat_tpu_torch/_build/`` inside the package, which a read-only install
cannot write: :func:`enable_compilation_cache` moves it. The CLIs call it
at startup, as the JAX scripts do; library users can call it themselves
(safe to call repeatedly).
"""

from __future__ import annotations

import os
import tempfile
from pathlib import Path

from ..ops import _build

DEFAULT_BUILD_ROOT = _build.BUILD_ROOT
_process_dirs: dict[int, Path] = {}  # GSPLAT_NO_CACHE's, by process id


def _process_dir() -> Path:
    pid = os.getpid()
    if pid not in _process_dirs:
        _process_dirs[pid] = Path(tempfile.mkdtemp(
            prefix=f"gsplat_kernels_{pid}_"))
    return _process_dirs[pid]


def enable_compilation_cache(cache_dir: str | None = None) -> str:
    """Point the kernel builds at ``cache_dir``, else at the
    ``GSPLAT_CACHE_DIR`` environment variable, else leave them in the
    package's ``_build/``. ``GSPLAT_NO_CACHE=1`` builds into a temporary
    directory of this process instead (nothing is reused across
    processes). Returns the build directory in use. Libraries already
    loaded stay loaded."""
    if os.environ.get("GSPLAT_NO_CACHE"):
        root = _process_dir()
    else:
        chosen = cache_dir or os.environ.get("GSPLAT_CACHE_DIR")
        root = Path(chosen).expanduser() if chosen else DEFAULT_BUILD_ROOT
    _build.BUILD_ROOT = root
    return str(root)
