"""Build and load the port's CUDA sources at first use.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface (no PyTorch headers: seconds, not minutes)
and loaded with ctypes. The library lands in ``build/kernels/`` at the root
of the checkout, named by a hash of its source and flags, so an edited
source rebuilds and an unchanged one loads what is there. Nothing is built
when a module is imported: only a launch on a CUDA tensor gets here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from PATH, else the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from csrc/ at first use and need the CUDA toolkit")


def library_path(source: str) -> Path:
    """Where the library for ``csrc/<source>`` lives once built."""
    src = CSRC_DIR / source
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its hashed library exists. The
    output is written under a temporary name and renamed into place, so a
    build that dies leaves nothing half-written behind."""
    out = library_path(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {source}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> dict[str, Path]:
    """Build every ``csrc/*.cu`` at once, one nvcc per source, all started
    together; returns source name -> library path."""
    sources = sorted(p.name for p in CSRC_DIR.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(1, len(sources))) as pool:
        return dict(zip(sources, pool.map(build, sources)))


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``; one CDLL per source
    per process."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = _loaded[source] = ctypes.CDLL(str(build(source)))
        return lib
