"""Approximate analytics: HLL distinct-count planes + set-similarity.

The port's counterpart of pilosa_tpu/sketch. Knobs follow the
residency-mode pattern: a server-level setter (``--sketch-precision`` /
``--sketch-exact-threshold`` in cli.py) with a PILOSA_TPU_* env override
that always wins -- tests and operators can flip a precision without
rebuilding a server config. The env vars are the JAX package's, so one
setting holds both packages."""

from __future__ import annotations

import os

from pilosa_tpu_torch.sketch.hll import (  # noqa: F401
    BUCKET_MASK,
    MAX_PRECISION,
    MIN_PRECISION,
    RHO_SHIFT,
    DistinctValues,
    HLLSketch,
    SimPartial,
    error_bound,
    merge_all,
    sketch_values,
)

#: default HLL precision: 2^12 = 4096 registers, ~1.6% standard error,
#: 4 KiB per (shard, field) register file.
DEFAULT_PRECISION = 12

#: below this estimated cardinality the executor answers
#: Count(Distinct) EXACTLY (per-shard unique values + host union):
#: small sets are where relative HLL error is most visible and where
#: exact is cheapest.
DEFAULT_EXACT_THRESHOLD = 1024

#: default result size for SimilarTopN(...) without n=.
DEFAULT_SIMILAR_N = 10

_default_precision = DEFAULT_PRECISION
_default_exact_threshold = DEFAULT_EXACT_THRESHOLD


def _env_int(name: str) -> int | None:
    v = os.environ.get(name, "").strip()
    if not v:
        return None
    try:
        return int(v)
    except ValueError:
        return None


def validate_precision(p: int) -> int:
    if not (MIN_PRECISION <= p <= MAX_PRECISION):
        raise ValueError(
            f"sketch precision must be in [{MIN_PRECISION}, "
            f"{MAX_PRECISION}], got {p}")
    return int(p)


def set_precision(p: int) -> None:
    global _default_precision
    _default_precision = validate_precision(p)


def precision() -> int:
    env = _env_int("PILOSA_TPU_SKETCH_PRECISION")
    if env is not None and MIN_PRECISION <= env <= MAX_PRECISION:
        return env
    return _default_precision


def set_exact_threshold(n: int) -> None:
    global _default_exact_threshold
    if n < 0:
        raise ValueError("sketch exact threshold must be >= 0")
    _default_exact_threshold = int(n)


def exact_threshold() -> int:
    env = _env_int("PILOSA_TPU_SKETCH_EXACT_THRESHOLD")
    if env is not None and env >= 0:
        return env
    return _default_exact_threshold
