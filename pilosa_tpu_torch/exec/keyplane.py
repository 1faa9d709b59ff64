"""Device-resident key planes: forward key translation at device speed.

The port's counterpart of pilosa_tpu/exec/keyplane.py. Key translation
keeps host dicts (core/translate.py). For keyed read queries that arrive in
batches -- bulk imports, TopN seed lists, many-key unions -- the serial host
walk is the one stage that scales with key count on the host. This module
builds, per translate store, a version-stamped *key plane*

    sorted [H] hash lane (splitmix64 of FNV-1a'd key bytes)
    parallel [H] id lane

probed on the device by the ``plane_lookup`` kernel (ops/kernels.py,
csrc/keyplane_kernels.cu): one thread a probe, a leftmost search over
the hash (fences in shared memory, then interpolated sector reads). The
64-bit hash lane is stored as two 32-bit lanes (hi, lo), so the plane is
ONE ``[3, H]`` int32 tensor of uint32 bit patterns (compared as unsigned
by the kernel) -- a single stack-cache resident the planner accounts like
any other representation class (``KEYPLANE`` in exec/residency.py,
inserted through ``Planner._insert_stack`` and rebuilt on the residency
prefetcher after a translate-version bump). The planes are bit-equal to
the JAX package's.

Fingerprint semantics (documented contract, same as any PHF): the 64-bit
hash IS the identity test on the device. Keys whose hashes collide
*within* a store are detected at build time and excluded from the plane;
they resolve from a host-side collision bucket. A probe key absent from
the store that collides with a resident hash reads the resident id
(probability ~N*Q/2^64); ``--translate-planes off`` is the escape hatch.
Plane misses always fall back to the host snapshot path, which re-checks
under the store lock before allocating -- a stale plane is therefore
correct-but-incomplete, never wrong about what it holds.

Modes (``PILOSA_TPU_TRANSLATE_PLANES`` env wins over the server knob's
``set_mode``, mirroring residency/prefetch):

* ``auto`` (default) -- device probe only for batches of at least
  ``MIN_DEVICE_BATCH`` keys (below that the lock-free host snapshot is
  faster than a launch, and single-key warm Counts must stay one device
  launch); version-stale planes serve stale + schedule an async rebuild
  on the residency prefetcher.
* ``on``   -- device probe for any batch, synchronous rebuild on version
  bump (the deterministic test/bench mode).
* ``off``  -- host snapshot path only; no planes are built.
"""

from __future__ import annotations

import os
import threading

import numpy as np
import torch

from pilosa_tpu_torch.ops import kernels

_MODES = ("on", "off", "auto")
_default_mode = "auto"

#: representation-class name mirrored into exec/residency.py's
#: REPR_CLASSES/KERNELS tables (the residency-pairing checker enforces
#: the full kernel row there).
KEYPLANE = "keyplane"

#: stack-cache view slot for key planes — never a real fragment view,
#: so plane entries can't alias row-stack entries.
VIEW = "__translate__"

#: ``auto`` threshold: below this many keys the host snapshot dict walk
#: beats a device dispatch, and the warm keyed Count path must not grow
#: a second launch.
MIN_DEVICE_BATCH = 256

#: id-lane miss sentinel; TranslateStore ids start at 1 (boltdb
#: sequence), so 0 is unallocatable.
MISS = 0

#: minimum plane width — tiny stores share one compiled probe shape.
MIN_PLANE_WIDTH = 8

_M64 = (1 << 64) - 1
_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3


def set_mode(mode_: str) -> None:
    """Server-knob default; the PILOSA_TPU_TRANSLATE_PLANES env var
    (the test/operator override) takes precedence when set."""
    global _default_mode
    if mode_ not in _MODES:
        raise ValueError(f"translate_planes mode must be one of {_MODES}")
    _default_mode = mode_


def mode() -> str:
    m = os.environ.get("PILOSA_TPU_TRANSLATE_PLANES", "").strip().lower()
    return m if m in _MODES else _default_mode


# ---------------------------------------------------------------------------
# hashing (host side: keys are Python strings)
# ---------------------------------------------------------------------------


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer (same arithmetic as sketch/hll)."""
    with np.errstate(over="ignore"):
        x = x + np.uint64(0x9E3779B97F4A7C15)
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def hash_keys(keys) -> np.ndarray:
    """uint64 fingerprints of string keys: FNV-1a over the utf-8 bytes
    mixes in every byte, splitmix64 finalizes for avalanche (FNV alone
    is weak in the low bits, and the plane's sort order feeds a binary
    search — clustered hashes would still be correct, just unbalanced
    for the collision check).

    Vectorized ACROSS the batch: keys are padded into one [N, L] byte
    matrix and the FNV chain runs as L masked numpy passes over all N
    lanes — the per-byte Python loop this replaces was slower than the
    host dict walk the plane exists to beat."""
    if not len(keys):
        return np.empty(0, dtype=np.uint64)
    bs = [k.encode("utf-8") for k in keys]
    lens = np.fromiter((len(b) for b in bs), dtype=np.int64,
                       count=len(bs))
    width = max(1, int(lens.max()))
    blob = b"".join(b.ljust(width, b"\0") for b in bs)
    mat = np.frombuffer(blob, dtype=np.uint8).reshape(
        len(bs), width).astype(np.uint64)
    h = np.full(len(bs), np.uint64(_FNV_OFFSET))
    prime = np.uint64(_FNV_PRIME)
    min_len = int(lens.min())
    with np.errstate(over="ignore"):
        for j in range(min_len):       # every lane active: no mask cost
            h = (h ^ mat[:, j]) * prime
        for j in range(min_len, width):
            active = lens > j
            h[active] = (h[active] ^ mat[active, j]) * prime
    return _splitmix64(h)


# ---------------------------------------------------------------------------
# plane build (host side, from a store snapshot)
# ---------------------------------------------------------------------------


def build_plane(fwd: dict[str, int]) -> tuple[np.ndarray, dict[str, int], int]:
    """(mat [3, Hpad] uint32, collision bucket, valid entries) from a
    forward-map snapshot.

    Intra-store hash collisions are verified host-side HERE: every
    member of a colliding hash group is excluded from the plane (its
    slot would be ambiguous) and lands in the returned host bucket.
    Padding slots carry hash 2^64-1 / id MISS; a real key hashing to
    exactly 2^64-1 still resolves — sorted order puts it left of the
    padding and the search returns the leftmost match.
    """
    keys = list(fwd)
    h = hash_keys(keys)
    order = np.argsort(h, kind="stable")
    h = h[order]
    ids = np.fromiter((fwd[keys[i]] for i in order), dtype=np.uint32,
                      count=len(keys))
    collisions: dict[str, int] = {}
    if len(h) > 1:
        dup = np.zeros(len(h), dtype=bool)
        eq = h[1:] == h[:-1]
        dup[1:] |= eq
        dup[:-1] |= eq
        if dup.any():
            for i in np.flatnonzero(dup):
                k = keys[order[i]]
                collisions[k] = fwd[k]
            h, ids = h[~dup], ids[~dup]
    valid = len(h)
    width = max(MIN_PLANE_WIDTH, 1 << max(0, int(valid - 1).bit_length()))
    mat = np.empty((3, width), dtype=np.uint32)
    mat[0, :valid] = (h >> np.uint64(32)).astype(np.uint32)
    mat[1, :valid] = (h & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    mat[2, :valid] = ids
    mat[0, valid:] = np.uint32(0xFFFFFFFF)
    mat[1, valid:] = np.uint32(0xFFFFFFFF)
    mat[2, valid:] = np.uint32(MISS)
    return mat, collisions, valid


class KeyPlane:
    """Host-side descriptor of one store's device plane: the version it
    was built from, the collision bucket, and the stack-cache key whose
    entry holds the [3, H] device tensor."""

    __slots__ = ("version", "collisions", "valid", "key")

    def __init__(self, version: int, collisions: dict[str, int],
                 valid: int, key: tuple):
        self.version = version
        self.collisions = collisions
        self.valid = valid
        self.key = key


# -- the rest of the KEYPLANE row of exec/residency.KERNELS, on plane_lookup


def plane_expand(plane: torch.Tensor) -> torch.Tensor:
    """The plane IS its dense form -- identity, like the dense row's
    expand: [3, H] (hash hi, hash lo, id) lanes."""
    return plane


def plane_count(plane: torch.Tensor) -> torch.Tensor:
    """Allocated mappings resident in the plane (padding and excluded
    collision-bucket slots carry the MISS id)."""
    return torch.sum(plane[2] != MISS, dtype=torch.int32)


def plane_and_count(plane: torch.Tensor, probe_hi: torch.Tensor,
                    probe_lo: torch.Tensor) -> torch.Tensor:
    """|probe batch AND plane|: the probes ``plane_lookup`` finds."""
    return torch.sum(kernels.plane_lookup(plane, probe_hi, probe_lo) != MISS,
                     dtype=torch.int32)


def plane_pair_count(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """|a AND b| over two planes' valid hash sets: a's slots that hold an id
    and whose hash ``plane_lookup`` finds in b."""
    hits = kernels.plane_lookup(b, a[0].contiguous(), a[1].contiguous()) != MISS
    return torch.sum(hits & (a[2] != MISS), dtype=torch.int32)


class KeyPlaneCache:
    """Per-executor registry of key planes, one per translate store.

    Device tensors live in the owning planner's stack cache (class
    ``keyplane``), so planes share the residency budget, the eviction
    policy, and /debug/device byte accounting with row stacks; an evicted
    plane simply rebuilds on next use. Without a planner (host-only
    executors, tests) tensors are pinned locally on ``device``.
    """

    def __init__(self, planner=None, device=None):
        self.planner = planner
        self.device = torch.device(
            device if device is not None
            else planner.device if planner is not None else "cpu")
        self._planes: dict[tuple, KeyPlane] = {}
        self._mats: dict[tuple, torch.Tensor] = {}  # planner-less fallback
        self._lock = threading.Lock()
        self.builds = 0
        self.device_batches = 0
        self.device_keys = 0
        self.collision_hits = 0
        self.stale_served = 0
        self.rebuilds_scheduled = 0

    # -- plumbing ----------------------------------------------------------

    def _stack_key(self, idx, field: str | None) -> tuple:
        # The planner's 7-slot stack key: instance_id so a deleted-and-
        # recreated index can't serve the old index's plane; the class in
        # the last slot drives _insert_stack's per-class accounting.
        return (idx.name, idx.instance_id, field or "", VIEW, 0, (), KEYPLANE)

    def _fetch_mat(self, key: tuple):
        pl = self.planner
        if pl is None:
            return self._mats.get(key)
        with pl._cache_lock:
            hit = pl._stack_cache.get(key)
            if hit is None:
                return None
            pl._stack_cache.move_to_end(key)
            return hit[2]

    def _build(self, key: tuple, store) -> tuple[KeyPlane, torch.Tensor]:
        version, fwd, _ = store.snapshot()
        mat_np, collisions, valid = build_plane(fwd)
        # the same bits as the [3, H] int32 tensor the kernel reads
        arr = torch.from_numpy(mat_np.view(np.int32)).to(self.device)
        pl = self.planner
        if pl is None:
            self._mats[key] = arr
        else:
            pl._insert_stack(key, version, (), arr)
        plane = KeyPlane(version, collisions, valid, key)
        with self._lock:
            self._planes[key] = plane
            self.builds += 1
        return plane, arr

    def _schedule_build(self, key: tuple, store) -> None:
        pl = self.planner
        if pl is None or not pl.prefetcher.enabled():
            return
        with self._lock:
            self.rebuilds_scheduled += 1
        pl.prefetcher.schedule(key, lambda: self._build(key, store))

    # -- the forward-translate entry point ---------------------------------

    def lookup(self, idx, field: str | None, store, keys) -> \
            list[int | None] | None:
        """Resolve ``keys`` via the device plane; ``None`` means the
        device path does not apply here (mode off / batch under the auto
        threshold / plane pending async build) and the caller must use
        the host snapshot path. Per-key ``None`` entries are genuine
        plane misses -- the caller re-checks those under the store lock
        before treating them as absent, so a stale plane can only cost
        a host fallback, never a wrong id."""
        m = mode()
        if m == "off":
            return None
        keys = list(keys)
        if not keys or (m == "auto" and len(keys) < MIN_DEVICE_BATCH):
            return None
        key = self._stack_key(idx, field)
        with self._lock:
            plane = self._planes.get(key)
        mat = self._fetch_mat(key) if plane is not None else None
        version = store.version
        if mat is None or (plane.version != version and m == "on"):
            # No plane (or evicted), or deterministic mode saw a stale
            # one: build in line. ``auto`` instead schedules an async
            # rebuild and serves what it has.
            if m == "auto" and mat is None:
                self._schedule_build(key, store)
                return None
            plane, mat = self._build(key, store)
        elif plane.version != version:
            with self._lock:
                self.stale_served += 1
            self._schedule_build(key, store)
        h = hash_keys(keys)
        probe_hi = torch.from_numpy((h >> np.uint64(32)).astype(np.uint32).view(np.int32))
        probe_lo = torch.from_numpy((h & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32))
        ids = kernels.plane_lookup(mat, probe_hi.to(mat.device), probe_lo.to(mat.device))
        ids = ids.cpu().numpy().view(np.uint32)
        with self._lock:
            self.device_batches += 1
            self.device_keys += len(keys)
        out: list[int | None] = []
        bucket = plane.collisions
        for k, id_ in zip(keys, ids.tolist()):
            hit = bucket.get(k)
            if hit is not None:
                with self._lock:
                    self.collision_hits += 1
                out.append(hit)
            elif id_:
                out.append(id_)
            else:
                out.append(None)
        return out

    # -- observability ------------------------------------------------------

    def debug(self) -> dict:
        with self._lock:
            return {
                "mode": mode(),
                "planes": len(self._planes),
                "builds": self.builds,
                "deviceBatches": self.device_batches,
                "deviceKeys": self.device_keys,
                "collisionHits": self.collision_hits,
                "staleServed": self.stale_served,
                "rebuildsScheduled": self.rebuilds_scheduled,
            }
