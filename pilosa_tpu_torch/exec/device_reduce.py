"""Device-side reduce of distributed bitmap legs.

The port's copy of pilosa_tpu/exec/device_reduce.py. The coordinator folds
remote Row results on the device instead of the host:

* ``row_from_columns`` uploads all of a leg's positions and builds every
  shard's word block in ONE ``scatter_bits`` launch (a leg's positions are
  unique, so each bit lands once and the JAX scatter-add equals the
  kernel's OR). Segments come out as int32 tensors on the given device,
  the form the port's ``Row`` holds.
* ``union_rows`` merges legs: disjoint shards (the common placement case)
  are a dict merge; contested shards stack into one ``[B, K, W]`` tensor
  OR-reduced in ONE ``or_fold`` launch, replacing the per-leg
  ``reduce_fn(result, acc)`` union chain in ``cluster.map_reduce``.

The JAX package buckets the shapes to powers of two so new leg sizes reuse
compiled programs; the port's kernels take any shape, so nothing is padded.

Selection: ``PILOSA_TPU_DEVICE_REDUCE`` = ``on`` | ``off`` | ``auto`` (the
env wins over the server knob's ``set_mode``). ``auto`` uses a measured
host-vs-device crossover so small results keep the cheap host path, as the
JAX module does; both paths are bit-identical and the tests force each
side. ``PILOSA_TPU_DEVICE_REDUCE_MIN`` pins the crossover.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.core.row import Row
from pilosa_tpu_torch.ops import bitops, kernels

_MODES = ("on", "off", "auto")
_default_mode = "auto"


def set_mode(mode: str) -> None:
    """Server-knob default; the PILOSA_TPU_DEVICE_REDUCE env var (the
    test/operator override) takes precedence when set."""
    global _default_mode
    if mode not in _MODES:
        raise ValueError(f"device_reduce mode must be one of {_MODES}")
    _default_mode = mode


def mode() -> str:
    m = os.environ.get("PILOSA_TPU_DEVICE_REDUCE", "").strip().lower()
    return m if m in _MODES else _default_mode


# -- measured size threshold ------------------------------------------------

#: device -> crossover, measured once per device.
_calibrated: dict[str, int] = {}


def _calibrate(device: torch.device) -> int:
    """Crossover, in scattered positions / folded words, above which the
    batched device program beats the host numpy path: device dispatch is a
    fixed overhead, host cost scales with the data (the JAX rule: a host
    round trip of ``or_fold`` over ``[1, 2, W]`` against numpy's OR a
    word, clamped to [W, 256 W])."""
    w = WORDS_PER_SHARD
    a = np.arange(w, dtype=np.uint32)
    b = a[::-1].copy()
    t0 = time.perf_counter()
    for _ in range(8):
        np.bitwise_or(a, b)
    host_per_word = max((time.perf_counter() - t0) / (8 * w), 1e-12)
    stack = torch.zeros((1, 2, w), dtype=torch.int32, device=device)
    kernels.or_fold(stack).cpu()  # build and load outside the clock
    t0 = time.perf_counter()
    for _ in range(4):
        kernels.or_fold(stack).cpu()
    dev_overhead = (time.perf_counter() - t0) / 4
    return int(min(max(dev_overhead / host_per_word, w), 256 * w))


def _min_size(device: torch.device) -> int:
    env = os.environ.get("PILOSA_TPU_DEVICE_REDUCE_MIN", "")
    if env:
        return int(env)
    key = str(torch.device(device))
    if key not in _calibrated:
        _calibrated[key] = _calibrate(torch.device(device))
    return _calibrated[key]


def _use_device(size: int, device: torch.device) -> bool:
    m = mode()
    if m == "off":
        return False
    if m == "on":
        return True
    return size >= _min_size(device)


def row_from_columns(columns, device: torch.device) -> Row:
    """Row.from_columns with the positions->words scatter as ONE
    ``scatter_bits`` launch across all shards, the segments int32 tensors
    on ``device`` (the host path below the measured threshold or when the
    mode says off)."""
    cols = np.asarray(columns, dtype=np.uint64)
    if not _use_device(len(cols), device):
        return Row.from_columns(cols)
    cols = np.unique(cols)
    if len(cols) == 0:
        return Row()
    shard = (cols // np.uint64(SHARD_WIDTH)).astype(np.int64)
    local = (cols % np.uint64(SHARD_WIDTH)).astype(np.int32)
    shards, seg_idx = np.unique(shard, return_inverse=True)
    n_segs = len(shards)
    words = kernels.scatter_bits(
        torch.from_numpy(seg_idx.astype(np.int32)).to(device),
        torch.from_numpy(local).to(device), n_segs)
    return Row({int(s): words[i] for i, s in enumerate(shards)})


def union_rows(rows: list) -> Row | None:
    """Union the accumulated legs of a distributed bitmap query.

    Bit-identical to the chained ``prev.union(v)`` fold it replaces: one
    leg passes through untouched (attrs included); two or more merge
    disjoint shards directly and fold contested shards -- on the device in
    ONE ``or_fold`` launch when the contested volume clears the threshold,
    else with host numpy."""
    rows = [r for r in rows if r is not None]
    if not rows:
        return None
    if len(rows) == 1:
        return rows[0]
    by_shard: dict[int, list] = {}
    for r in rows:
        for s, seg in r.segments.items():
            by_shard.setdefault(s, []).append(seg)
    merged: dict[int, object] = {}
    contested: list[tuple[int, list]] = []
    for s, segs in by_shard.items():
        if len(segs) == 1:
            merged[s] = segs[0]
        else:
            contested.append((s, segs))
    if contested:
        device = next((seg.device for _, segs in contested for seg in segs
                       if isinstance(seg, torch.Tensor)), torch.device("cpu"))
        n_words = sum(len(segs) for _, segs in contested) * WORDS_PER_SHARD
        if _use_device(n_words, device):
            k = max(len(segs) for _, segs in contested)
            zero = torch.zeros(WORDS_PER_SHARD, dtype=torch.int32, device=device)
            stack = torch.stack([
                torch.stack([bitops.to_device_words(seg, device)
                             if not isinstance(seg, torch.Tensor) else seg
                             for seg in segs] + [zero] * (k - len(segs)))
                for _, segs in contested])
            folded = kernels.or_fold(stack)
            for i, (s, _) in enumerate(contested):
                merged[s] = folded[i]
        else:
            for s, segs in contested:
                acc = bitops.to_host_words(segs[0])
                for seg in segs[1:]:
                    acc = np.bitwise_or(acc, bitops.to_host_words(seg))
                merged[s] = acc
    return Row(merged)
