"""Persistent kernel build cache.

The port's counterpart of pilosa_tpu/parallel/compile_cache.py. The JAX
package points XLA's on-disk compilation cache at a directory so a
restarted node reuses every program it compiled. The port's compiled
programs are its CUDA libraries, which ``ops/build.py`` keys by a hash of
source and flags; ``enable`` moves that cache from ``build/kernels/`` to
``cache_dir``, so a node started again with the same directory loads the
libraries instead of running nvcc. ``stats()`` reports the same keys as
the JAX module: a hit is a library found built, a request any library
the process asked for (``build.COUNTS``).

The directory is process-wide, so ``enable`` is idempotent: the first call
fixes it. It never raises: a node boots even when the directory cannot be
made (kernels then build where they did).
"""

from __future__ import annotations

import os
import threading
from pathlib import Path

from pilosa_tpu_torch.ops import build

_lock = threading.Lock()
_enabled_dir: str | None = None


def enable(cache_dir: str) -> bool:
    """Build and load the kernel libraries under ``cache_dir``. Returns True
    when the cache is active (this call or an earlier one)."""
    global _enabled_dir
    with _lock:
        if _enabled_dir is not None:
            return True
        if not cache_dir:
            return False
        try:
            os.makedirs(cache_dir, exist_ok=True)
        except OSError:
            return False
        _enabled_dir = cache_dir
    build.set_build_dir(Path(cache_dir))
    return True


def stats() -> dict:
    """Snapshot: {'enabled', 'dir', 'hits', 'requests'}."""
    with _lock:
        enabled, cache_dir = _enabled_dir is not None, _enabled_dir or ""
    hits, builds = build.COUNTS["hits"], build.COUNTS["builds"]
    return {"enabled": enabled, "dir": cache_dir, "hits": hits,
            "requests": hits + builds}
