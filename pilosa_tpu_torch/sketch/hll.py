"""HyperLogLog host math: hashing, register planes, and the estimator.

The port's copy of pilosa_tpu/sketch/hll.py, plain numpy as there: the
device kernels (``hll_expand``/``hll_reduce`` in ops/kernels.py, built from
csrc/sketch_kernels.cu) run the SAME register arithmetic, and the CPU tests
hold the two packages' registers and estimates equal. The hash is splitmix64: cheap,
vectorizes to a handful of uint64 ops, and passes the avalanche tests
HLL's rho-statistics depend on (Flajolet et al. 2007 assume a uniform
hash; a weak one shows up as bias long before it shows up in unit
tests).

Register-plane packing: one int32 per column, ``bucket | rho << 18``.
rho fits 6 bits (1..33) and bucket fits 18 (precision is capped at 18),
so the packed word stays under 2^24 and a packed value of 0 reads
unambiguously as "column absent" — rho is never 0 for a present column.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

#: bit layout of a packed (bucket, rho) plane entry; precision <= 18
#: keeps bucket below the rho shift.
RHO_SHIFT = 18
BUCKET_MASK = (1 << RHO_SHIFT) - 1

MIN_PRECISION = 4
MAX_PRECISION = 18


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays."""
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        return x ^ (x >> np.uint64(31))


def bucket_rho(values_u64: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """(bucket, rho) per value: bucket = top ``p`` hash bits, rho =
    1-based position of the first set bit in the next 32 (33 when the
    whole window is zero — with a 64-bit hash the window is wide enough
    that no large-range correction is needed)."""
    h = _splitmix64(np.asarray(values_u64, dtype=np.uint64))
    bucket = (h >> np.uint64(64 - p)).astype(np.int64)
    with np.errstate(over="ignore"):
        w32 = ((h << np.uint64(p)) >> np.uint64(32)).astype(np.uint32)
    # frexp exponent == bit length for positive ints, 0 for 0 — exact in
    # float64 for anything below 2^53, so for the whole uint32 range.
    bitlen = np.frexp(w32.astype(np.float64))[1]
    rho = (33 - bitlen).astype(np.int64)
    return bucket, rho


def pack_plane(bucket: np.ndarray, rho: np.ndarray) -> np.ndarray:
    """Pack per-column (bucket, rho) into int32 plane entries."""
    return (bucket | (rho << RHO_SHIFT)).astype(np.int32)


def _alpha(m: int) -> float:
    if m == 16:
        return 0.673
    if m == 32:
        return 0.697
    if m == 64:
        return 0.709
    return 0.7213 / (1.0 + 1.079 / m)


def error_bound(p: int) -> float:
    """Theoretical relative standard error of an HLL with 2^p registers."""
    return 1.04 / float(np.sqrt(1 << p))


def estimate_from_registers(regs: np.ndarray) -> float:
    """Harmonic-mean estimate with the small-range linear-counting
    correction (Flajolet et al. 2007, fig. 3). ``regs`` is the uint8
    register array; its length must be a power of two."""
    regs = np.asarray(regs, dtype=np.float64)
    m = regs.shape[-1]
    est = _alpha(m) * m * m / np.sum(np.exp2(-regs))
    if est <= 2.5 * m:
        zeros = int(np.count_nonzero(regs == 0))
        if zeros:
            return m * float(np.log(m / zeros))
    return float(est)


@dataclass
class HLLSketch:
    """One distinct-count partial: precision + register array. The merge
    is register-wise max — associative, commutative, idempotent — which
    is what lets partials ride the cluster aggregate wire in any fold
    order."""

    p: int
    regs: np.ndarray

    @classmethod
    def empty(cls, p: int) -> "HLLSketch":
        return cls(p=p, regs=np.zeros(1 << p, dtype=np.uint8))

    def merge(self, other: "HLLSketch") -> "HLLSketch":
        if other.p != self.p:
            raise ValueError(
                f"cannot merge HLL sketches of precision {self.p} and "
                f"{other.p}")
        return HLLSketch(p=self.p, regs=np.maximum(self.regs, other.regs))

    def estimate(self) -> float:
        return estimate_from_registers(self.regs)


def merge_all(sketches) -> HLLSketch:
    """Fold any number of same-precision sketches in one vectorized max."""
    sketches = list(sketches)
    if not sketches:
        raise ValueError("merge_all() of no sketches")
    p = sketches[0].p
    for s in sketches[1:]:
        if s.p != p:
            raise ValueError(
                f"cannot merge HLL sketches of precision {p} and {s.p}")
    regs = np.max(np.stack([s.regs for s in sketches], axis=0), axis=0)
    return HLLSketch(p=p, regs=regs.astype(np.uint8))


def sketch_values(values: np.ndarray, p: int) -> HLLSketch:
    """Host oracle: sketch an int64 value array directly (two's-
    complement reinterpretation, matching the plane builder)."""
    u = np.asarray(values, dtype=np.int64).astype(np.uint64)
    bucket, rho = bucket_rho(u, p)
    regs = np.zeros(1 << p, dtype=np.uint8)
    np.maximum.at(regs, bucket, rho.astype(np.uint8))
    return HLLSketch(p=p, regs=regs)


def registers_from_plane(packed: np.ndarray, p: int) -> np.ndarray:
    """Fold a packed (bucket|rho<<18) column plane into registers.
    Zero entries are absent columns (rho >= 1 for present ones)."""
    nz = packed[packed != 0].astype(np.int64)
    regs = np.zeros(1 << p, dtype=np.uint8)
    if len(nz):
        np.maximum.at(regs, nz & BUCKET_MASK,
                      (nz >> RHO_SHIFT).astype(np.uint8))
    return regs


@dataclass
class DistinctValues:
    """Exact-fallback partial: the sorted unique values seen by one
    node (absolute, base-adjusted). Only flows when the estimate is
    under the exact threshold, so the payload is bounded by it."""

    values: np.ndarray                 # int64, sorted unique

    @classmethod
    def empty(cls) -> "DistinctValues":
        return cls(values=np.empty(0, dtype=np.int64))

    def merge(self, other: "DistinctValues") -> "DistinctValues":
        return DistinctValues(values=np.union1d(self.values, other.values))


# ---------------------------------------------------------------------------
# set-similarity partials
# ---------------------------------------------------------------------------


@dataclass
class SimPartial:
    """One node's SimilarTopN partial: per candidate row, the overlap
    with the filter and the row's own cardinality, plus the filter's
    cardinality — everything the Jaccard/overlap scores need, and all
    of it additive across disjoint shard sets."""

    ids: np.ndarray                    # uint64 [R] candidate row ids
    overlap: np.ndarray                # int64 [R] |row ∧ filter|
    selfcnt: np.ndarray                # int64 [R] |row|
    filtcnt: int                       # |filter| over this partial's shards
    order: np.ndarray | None = field(default=None)  # device top-k, local only

    @classmethod
    def empty(cls) -> "SimPartial":
        return cls(ids=np.zeros(0, dtype=np.uint64),
                   overlap=np.zeros(0, dtype=np.int64),
                   selfcnt=np.zeros(0, dtype=np.int64), filtcnt=0)

    def merge(self, other: "SimPartial") -> "SimPartial":
        """Align by row id and sum counts; shard sets are disjoint, so
        plain addition is exact. The device top-k ordering does not
        survive a merge — the final ranking re-sorts merged totals."""
        ids = np.union1d(self.ids, other.ids)
        overlap = np.zeros(len(ids), dtype=np.int64)
        selfcnt = np.zeros(len(ids), dtype=np.int64)
        for part in (self, other):
            if len(part.ids):
                at = np.searchsorted(ids, part.ids)
                overlap[at] += part.overlap
                selfcnt[at] += part.selfcnt
        return SimPartial(ids=ids, overlap=overlap, selfcnt=selfcnt,
                          filtcnt=self.filtcnt + other.filtcnt)

    def top_pairs(self, n: int, metric: str = "jaccard"):
        """(row_id, overlap, score) triples, best-first. Ties break to
        the lower row id — the same order the planner's stable descending
        sort produces over an id-ascending candidate stack (as
        ``jax.lax.top_k`` does in the JAX package), so the single-node
        device ranking and this host ranking agree bit-for-bit."""
        keep = self.overlap > 0
        ids = self.ids[keep]
        overlap = self.overlap[keep]
        selfcnt = self.selfcnt[keep]
        if metric == "jaccard":
            denom = selfcnt + self.filtcnt - overlap
            score = np.where(denom > 0, overlap / np.maximum(denom, 1), 0.0)
        elif metric == "overlap":
            score = overlap.astype(np.float64)
        else:
            raise ValueError(f"unknown similarity metric {metric!r}")
        order = np.lexsort((ids, -overlap, -score))[:n]
        return [(int(ids[i]), int(overlap[i]), float(score[i]))
                for i in order]
