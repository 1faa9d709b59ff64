"""Per-fragment HLL plane/register store.

The port's counterpart of pilosa_tpu/sketch/store.py. A fragment's sketch
state is DERIVED data: a packed ``bucket|rho<<18`` int32 plane over the
shard's columns (built from the BSI value planes) and the uint8 register
file folded from it. Both cache on the fragment keyed by ``(bit_depth,
precision)`` and stamped with the fragment generation, so correctness
NEVER depends on the incremental hooks -- a generation mismatch rebuilds
from the authoritative bit planes.

The hook (``observe_values``, called from ``Fragment.set_value`` and
``Fragment.import_values`` after the bit writes land) keeps the plane
current across ingest without rebuilds: a value write is a point overwrite
of the packed plane, which is exact. The derived register file is dropped
instead of updated -- registers are a running max, and an overwrite can
LOWER a column's contribution, which a max can't express.

Hook racing is resolved by generation fencing: an in-place update only
applies when the cached entry still carries the generation the mutation
started from; any interleaved writer drops the entry and the next read
rebuilds.

The JAX store reads the value planes through the JAX fragment's
generation-cached ``[depth + 1, W]`` value stack; the port's fragment keeps
none, so ``_value_stack`` here reads the sign and magnitude rows' words
once per build.
"""

from __future__ import annotations

import numpy as np

from pilosa_tpu_torch.config import SHARD_WIDTH, WORDS_PER_SHARD
from pilosa_tpu_torch.core.fragment import BSI_EXISTS_BIT, BSI_OFFSET_BIT, BSI_SIGN_BIT
from pilosa_tpu_torch.sketch import hll

_PLANES_ATTR = "_hll_planes"
_REGS_ATTR = "_hll_regs"


def _cache(frag, attr: str) -> dict:
    d = getattr(frag, attr, None)
    if d is None:
        d = {}
        setattr(frag, attr, d)
    return d


def _value_stack(frag, depth: int) -> tuple[int, np.ndarray]:
    """(generation, ``[depth + 1, W]`` uint32 words): the sign row, then the
    magnitude rows, read under the fragment's lock so the generation
    stamps exactly these words."""
    with frag._lock:
        gen = frag.generation
        mat = np.zeros((depth + 1, WORDS_PER_SHARD), dtype=np.uint32)
        for i, rid in enumerate([BSI_SIGN_BIT]
                                + list(range(BSI_OFFSET_BIT, BSI_OFFSET_BIT + depth))):
            if rid in frag.rows:
                mat[i] = frag.row_words(rid)
        return gen, mat


def _decode_stored(mat: np.ndarray, pos: np.ndarray,
                   depth: int) -> tuple[np.ndarray, np.ndarray]:
    """(u64 two's-complement, signed int64) stored values at ``pos``
    from a ``[depth+1, W]`` sign-row-first value-plane stack: the JAX
    store's decode, its magnitude gathered plane by plane."""
    wi = (pos >> 5).astype(np.int64)
    sh = (pos & 31).astype(np.uint32)
    words = mat[:depth + 1][:, wi]                       # [depth+1, n]
    on = ((words >> sh) & np.uint32(1)).astype(np.uint64)
    mag = np.zeros(len(wi), dtype=np.uint64)
    for i in range(depth):
        mag |= on[1 + i] << np.uint64(i)
    sign = on[0].astype(bool)
    with np.errstate(over="ignore"):
        u = np.where(sign, (~mag) + np.uint64(1), mag)
    signed = np.where(sign, -mag.astype(np.int64), mag.astype(np.int64))
    return u, signed


def _exists_positions(frag) -> np.ndarray:
    """The in-shard positions of the columns that hold a value, sorted."""
    with frag._lock:
        hr = frag.rows.get(BSI_EXISTS_BIT)
        return (np.empty(0, dtype=np.uint64) if hr is None
                else hr.to_positions().astype(np.uint64))


def plane(frag, depth: int, p: int) -> np.ndarray:
    """Packed ``bucket | rho << 18`` int32 plane over the shard's
    columns (0 = no value); generation-cached on the fragment."""
    planes = _cache(frag, _PLANES_ATTR)
    ent = planes.get((depth, p))
    if ent is not None and ent[0] == frag.generation:
        return ent[1]
    gen, mat = _value_stack(frag, depth)
    pos = _exists_positions(frag)
    packed = np.zeros(SHARD_WIDTH, dtype=np.int32)
    if len(pos):
        u, _ = _decode_stored(mat, pos, depth)
        bucket, rho = hll.bucket_rho(u, p)
        packed[pos] = hll.pack_plane(bucket, rho)
    planes[(depth, p)] = (gen, packed)
    return packed


def registers(frag, depth: int, p: int) -> np.ndarray:
    """uint8[2^p] register file of the whole shard, derived from the
    packed plane and generation-cached separately (the unfiltered
    distinct path uploads these directly)."""
    regs_cache = _cache(frag, _REGS_ATTR)
    ent = regs_cache.get((depth, p))
    if ent is not None and ent[0] == frag.generation:
        return ent[1]
    gen = frag.generation
    regs = hll.registers_from_plane(plane(frag, depth, p), p)
    regs_cache[(depth, p)] = (gen, regs)
    return regs


def _filter_mask(packed: np.ndarray, filt_words: np.ndarray) -> np.ndarray:
    bits = np.unpackbits(np.ascontiguousarray(filt_words).view(np.uint8),
                         bitorder="little")
    return packed * bits[:SHARD_WIDTH].astype(np.int32)


def shard_sketch(frag, depth: int, p: int,
                 filt_words: np.ndarray | None = None) -> hll.HLLSketch:
    """Host oracle / per-shard map half: one shard's HLL sketch, optionally
    masked by a ``[W]`` uint32 filter word plane."""
    pk = plane(frag, depth, p)
    if filt_words is not None:
        pk = _filter_mask(pk, np.asarray(filt_words, dtype=np.uint32))
        regs = hll.registers_from_plane(pk, p)
    else:
        regs = registers(frag, depth, p)
    return hll.HLLSketch(p=p, regs=regs.copy())


def shard_distinct(frag, depth: int,
                   filt_words: np.ndarray | None = None) -> np.ndarray:
    """Exact fallback map half: the shard's sorted unique STORED
    (base-relative, signed) values; the executor adds the BSI base."""
    pos = _exists_positions(frag)
    if filt_words is not None and len(pos):
        fw = np.asarray(filt_words, dtype=np.uint32)
        keep = ((fw[pos >> 5] >> (pos & 31).astype(np.uint32))
                & np.uint32(1)).astype(bool)
        pos = pos[keep]
    if not len(pos):
        return np.empty(0, dtype=np.int64)
    _, mat = _value_stack(frag, depth)
    _, signed = _decode_stored(mat, pos, depth)
    return np.unique(signed)


def observe_values(frag, local_pos: np.ndarray, values: np.ndarray,
                   gen_before: int, gen_after: int) -> None:
    """Incremental ingest hook: point-overwrite every cached plane at
    the written columns and drop the derived register files. Fenced by
    generation -- entries another writer got to first are dropped, not
    updated (see module docstring)."""
    planes = getattr(frag, _PLANES_ATTR, None)
    if planes:
        vals = np.asarray(values, dtype=np.int64)
        pos = np.asarray(local_pos, dtype=np.int64)
        u = vals.astype(np.uint64)
        for (depth, p), (gen, packed) in list(planes.items()):
            if gen != gen_before:
                planes.pop((depth, p), None)
                continue
            bucket, rho = hll.bucket_rho(u, p)
            packed[pos] = hll.pack_plane(bucket, rho)
            planes[(depth, p)] = (gen_after, packed)
    regs_cache = getattr(frag, _REGS_ATTR, None)
    if regs_cache:
        regs_cache.clear()


def invalidate(frag) -> None:
    """Drop all sketch state (bulk clears, anything not expressible as
    a point overwrite)."""
    for attr in (_PLANES_ATTR, _REGS_ATTR):
        d = getattr(frag, attr, None)
        if d:
            d.clear()
