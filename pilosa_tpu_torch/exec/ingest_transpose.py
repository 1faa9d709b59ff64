"""Device-side BSI plane transpose for bulk value imports.

The port's counterpart of pilosa_tpu/exec/ingest_transpose.py.
``Fragment.import_values`` can assemble a batch's bit planes on the host,
a numpy pass per magnitude plane, or here: upload the deduplicated
``[M]`` positions and values once and scatter every plane's words in one
``kernels.plane_scatter`` launch (``csrc/ingest_kernels.cu``), which
returns the whole ``[depth + 2, W]`` plane image -- exists row, sign row,
magnitude rows -- for the fragment to merge with word ops
(``old & ~written | new``), keeping last-write-wins bit for bit.

The kernel takes the int32 positions and int64 values as they are and
works out word, bit, sign and magnitude itself; the JAX version's uint32
magnitude halves and its power-of-two padding of M and of the plane axis
exist there to run without x64 and to reuse XLA compiles, and have no
counterpart here.

Selection: ``PILOSA_TPU_INGEST_TRANSPOSE`` = ``on`` | ``off`` | ``auto``
(env wins over the server knob's ``set_mode``). ``auto`` uses a measured
host-vs-device crossover, calibrated once per device type on the
holder's device; both paths are bit-identical by construction and the
equivalence tests force each side. ``PILOSA_TPU_INGEST_TRANSPOSE_MIN``
pins the crossover.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels

_MODES = ("on", "off", "auto")
_default_mode = "auto"


def set_mode(mode: str) -> None:
    """Server-knob default; the PILOSA_TPU_INGEST_TRANSPOSE env var (the
    test/operator override) takes precedence when set."""
    global _default_mode
    if mode not in _MODES:
        raise ValueError(f"ingest_transpose mode must be one of {_MODES}")
    _default_mode = mode


def mode() -> str:
    m = os.environ.get("PILOSA_TPU_INGEST_TRANSPOSE", "").strip().lower()
    return m if m in _MODES else _default_mode


# -- measured size threshold ------------------------------------------------

#: device type -> crossover in plane-bit writes.
_calibrated: dict[str, int] = {}


def _calibrate(device: torch.device) -> int:
    """Crossover, in plane-bit writes (values x planes), above which the
    one-launch device transpose beats the host plane-assembly loop: the
    launch and its copies back are a fixed overhead, host cost scales with
    the batch."""
    m = 4096
    pos = np.arange(m, dtype=np.uint64)
    mag = pos.copy()
    t0 = time.perf_counter()
    for _ in range(8):
        on = ((mag >> np.uint64(3)) & np.uint64(1)) == 1
        _ = pos[on]
    host_per_write = max((time.perf_counter() - t0) / (8 * m), 1e-12)
    z = np.zeros(8, dtype=np.uint32)
    v = np.zeros(8, dtype=np.int64)
    transpose_planes(z, v, 1, device)  # build and load the kernel off-clock
    t0 = time.perf_counter()
    for _ in range(4):
        transpose_planes(z, v, 1, device)
    dev_overhead = (time.perf_counter() - t0) / 4
    return int(min(max(dev_overhead / host_per_write, 1024), 1 << 22))


def _min_size(device: torch.device) -> int:
    env = os.environ.get("PILOSA_TPU_INGEST_TRANSPOSE_MIN", "")
    if env:
        return int(env)
    key = torch.device(device).type
    if key not in _calibrated:
        _calibrated[key] = _calibrate(torch.device(device))
    return _calibrated[key]


def use_device(size: int, device: torch.device) -> bool:
    """size = deduped values x (bit_depth + 2) plane-bit writes."""
    m = mode()
    if m == "off":
        return False
    if m == "on":
        return True
    return size >= _min_size(device)


def transpose_planes(local_u: np.ndarray, vals_u: np.ndarray, bit_depth: int,
                     device: torch.device) -> np.ndarray:
    """Transpose a deduplicated (sorted-unique local positions, values)
    batch into ``[bit_depth + 2, W]`` uint32 plane words on ``device``
    (rows: exists, sign, magnitude bit i). Returns a host copy the caller
    owns, writable."""
    pos = torch.from_numpy(np.ascontiguousarray(local_u, dtype=np.int32)).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(vals_u, dtype=np.int64)).to(device)
    out = kernels.plane_scatter(pos, vals, bit_depth)
    if out.device.type == "cuda":
        out = out.cpu()
    return out.numpy().view(np.uint32)
