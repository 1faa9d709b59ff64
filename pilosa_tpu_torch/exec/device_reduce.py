"""Device-side reduce of distributed bitmap legs.

The port's copy of pilosa_tpu/exec/device_reduce.py. The coordinator folds
remote Row results on the device instead of the host:

* ``row_from_columns`` uploads all of a leg's positions and builds every
  shard's word block in ONE ``scatter_bits_grouped`` launch (a leg's
  positions are unique, so each bit lands once and the JAX scatter-add
  equals the kernel's OR). The positions are sorted, so each shard's are
  one run of them: the row starts (a searchsorted over the shard
  boundaries) and the in-shard offsets go up in one int32 buffer, one
  host-to-device copy, with no segment index a position. Segments come
  out as int32 tensors on the given device, the form the port's ``Row``
  holds.
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


def sorted_unique(cols: np.ndarray) -> np.ndarray:
    """``np.unique`` of uint64 columns, with no sort or hash where they
    already ascend strictly, as a decoded roaring leg's do: a check of one
    pass (numpy's own unique costs about a microsecond a column on some
    hosts, a second at a 32-shard leg; ``PERF.md`` §6)."""
    if len(cols) > 1 and not bool((cols[1:] > cols[:-1]).all()):
        return np.unique(cols)
    return cols


def shard_starts(cols: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(shards, starts) of sorted unique uint64 columns: the shards that
    hold any, ascending, and where each one's run of columns begins. Found
    by searchsorted over the shard boundaries: every boundary of the span
    at once where the span has no more shards than columns, else shard by
    shard (a leg whose shard ids are far apart)."""
    w = SHARD_WIDTH
    first, last = int(cols[0]) // w, int(cols[-1]) // w
    if last - first < len(cols):
        ends = np.searchsorted(
            cols, np.arange(first, last + 1, dtype=np.uint64) * np.uint64(w)
            + np.uint64(w - 1), side="right")
        held = np.flatnonzero(np.diff(ends, prepend=0))
        return first + held, np.r_[0, ends[held[:-1]]]
    shards, starts, i = [], [], 0
    while i < len(cols):
        s = int(cols[i]) // w
        shards.append(s)
        starts.append(i)
        i = int(np.searchsorted(cols, np.uint64(s * w + w - 1), side="right"))
    return np.asarray(shards, dtype=np.int64), np.asarray(starts, dtype=np.int64)


def leg_buffer(cols: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """(shards, buffer, head) of sorted unique uint64 columns: one int32
    buffer of ``scatter_bits_grouped``'s row starts (``[n_segs + 2]``,
    relative to the offsets, the padding sink's row empty) then, from
    ``head`` (a multiple of 4: 16-byte aligned), every column's in-shard
    offset."""
    shards, starts = shard_starts(cols)
    n, n_segs = len(cols), len(shards)
    head = (n_segs + 2 + 3) & ~3
    buf = np.empty(head + n, dtype=np.int32)
    buf[:n_segs] = starts
    buf[n_segs:head] = n
    np.bitwise_and(cols, np.uint64(SHARD_WIDTH - 1), out=buf[head:], casting="unsafe")
    return shards, buf, head


def row_from_columns(columns, device: torch.device) -> Row:
    """Row.from_columns with the positions->words scatter as ONE
    ``scatter_bits_grouped`` launch across all shards after ONE upload,
    the segments int32 tensors on ``device`` (the host path below the
    measured threshold or when the mode says off)."""
    cols = np.asarray(columns, dtype=np.uint64)
    if not _use_device(len(cols), device):
        return Row.from_columns(cols)
    cols = sorted_unique(cols)
    if len(cols) == 0:
        return Row()
    shards, buf, head = leg_buffer(cols)
    up = torch.from_numpy(buf).to(device)
    words = kernels.scatter_bits_grouped(up[:len(shards) + 2], up[head:])
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
