"""Kernel warmup: build the CUDA sources and launch every kernel family once
at node start, so the first real query pays neither the build nor a cold
launch.

The port's counterpart of pilosa_tpu/qos/warmup.py. The JAX package warms
its planner's XLA programs; the port has no compile step per shape, but
its kernels are built from ``csrc/*.cu`` at first use (``ops/build.py``,
seconds per source) and each first launch loads a module. So on a CUDA
device the service first builds every source at once, then runs the
canonical query shapes -- the JAX package's set plus a 3-leaf tree and a
``Shift`` for ``tree_count`` and ``shift_left`` -- against a throwaway
schema-only index in a private Holder, for each configured shard-count
bucket, and finally replays the query shapes the previous incarnation of
the node observed (``warmup.json``, as the reference's
``_replay_observed`` does). The scratch index's stacks and plans are
dropped from the node's planner afterwards; its programs stay.
"""

from __future__ import annotations

import logging
import threading
import time

from pilosa_tpu_torch.core.field import FIELD_TYPE_INT, FieldOptions
from pilosa_tpu_torch.core.holder import Holder

logger = logging.getLogger("pilosa_tpu_torch.qos")

SCRATCH_INDEX = "qos-warmup-scratch"

#: canonical kernel families.
KIND_COUNT = "count"
KIND_TOPN = "topn"
KIND_BSI = "bsi"
DEFAULT_KINDS = (KIND_COUNT, KIND_TOPN, KIND_BSI)

DEFAULT_SHARD_COUNTS = (1, 8, 32)

#: the JAX package's warmup field range: BSI programs are depth-shaped.
_INT_MAX = 1 << 20

_QUERIES = {
    KIND_COUNT: (
        "Count(Row(f=1))",
        "Count(Intersect(Row(f=1), Row(g=1)))",
        "Count(Union(Row(f=1), Row(g=1)))",
        "Count(Difference(Row(f=1), Row(g=1)))",
        "Count(Intersect(Row(f=1), Row(g=1), Row(f=2)))",
        "Count(Shift(Row(f=1), n=1))",
    ),
    KIND_TOPN: (
        "TopN(f, n=10)",
        "TopN(f, Row(g=1), n=10)",
        "TopN(f, Intersect(Row(f=1), Row(g=1)), n=10)",
    ),
    KIND_BSI: (
        "Sum(field=v)",
        "Sum(Row(f=1), field=v)",
        "Count(Row(v > 0))",
        "Count(Row(v >< [0, 100]))",
        "Min(field=v)",
        "Max(field=v)",
    ),
}


class WarmupService:
    """Runs canonical query shapes through a planner at node start.

    ``planner`` is the node's live Planner; the queries execute through a
    throwaway Executor over a private Holder on the planner's device, so
    warmup never touches the node's schema or storage."""

    def __init__(self, planner, kinds=DEFAULT_KINDS,
                 shard_counts=DEFAULT_SHARD_COUNTS, stats=None,
                 observed=None, observed_schema=None):
        self.planner = planner
        self.kinds = tuple(k for k in kinds if k in DEFAULT_KINDS)
        self.shard_counts = tuple(sorted({int(s) for s in shard_counts
                                          if int(s) > 0})) or (1,)
        self._stats = stats
        #: query shapes the previous incarnation's planner observed
        #: (warmup.json entries: index/query/shards), replayed after the
        #: canonical set over ``observed_schema``, the persisted schema.
        self.observed = list(observed or [])
        self.observed_schema = list(observed_schema or [])
        self.programs_compiled = 0
        self.queries_run = 0
        self.replayed = 0
        self.errors = 0
        self.seconds = 0.0
        #: seconds spent building the CUDA sources (0 on the CPU).
        self.build_seconds = 0.0
        self.done = threading.Event()
        #: set by close(): the run stops before its next query.
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def run(self) -> dict:
        """Synchronous warmup; always safe to call (per-query failures are
        counted, never raised: a broken warmup query must not take down
        node start)."""
        t0 = time.perf_counter()
        try:
            self._build()
            self._run_queries()
        except Exception:
            self.errors += 1
            logger.exception("kernel warmup aborted")
        finally:
            self.seconds = time.perf_counter() - t0
            self.done.set()
            if self._stats is not None:
                self._stats.count("qos.warmupRuns", 1)
                self._stats.count("qos.warmupPrograms", self.programs_compiled)
                if self.replayed:
                    self._stats.count("qos.warmupReplayed", self.replayed)
                self._stats.timing("qos.warmupSeconds", self.seconds)
            logger.info(
                "kernel warmup: %d programs (%d queries, %d errors) over "
                "shard buckets %s in %.2fs (build %.2fs)",
                self.programs_compiled, self.queries_run, self.errors,
                self.shard_counts, self.seconds, self.build_seconds)
        return {"programs": self.programs_compiled,
                "queries": self.queries_run,
                "errors": self.errors, "seconds": round(self.seconds, 3),
                "build_seconds": round(self.build_seconds, 3)}

    def start(self, name: str = "qos-warmup") -> threading.Thread:
        t = self._thread = threading.Thread(target=self.run, name=name,
                                            daemon=True)
        t.start()
        return t

    def close(self, timeout: float = 60.0) -> None:
        """Stop a background run before its next query and wait for it: a
        thread still in a kernel while the interpreter exits aborts it."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def _build(self) -> None:
        """Every csrc/*.cu built at once (one nvcc each) on a CUDA device."""
        if self.planner is None or self.planner.device.type != "cuda":
            return
        from pilosa_tpu_torch.ops import build

        t0 = time.perf_counter()
        build.build_all()
        self.build_seconds = time.perf_counter() - t0

    def _run_queries(self) -> None:
        from pilosa_tpu_torch.exec.executor import Executor

        if self.planner is None:
            return
        scratch = Holder(device=self.planner.device)
        idx = scratch.create_index(SCRATCH_INDEX)
        idx.create_field("f")
        idx.create_field("g")
        idx.create_field("v", FieldOptions(type=FIELD_TYPE_INT,
                                           min=0, max=_INT_MAX))
        ex = Executor(scratch, planner=self.planner, result_cache=False)
        before = len(self.planner._fn_cache)
        try:
            for n in self.shard_counts:
                shards = list(range(n))
                for kind in self.kinds:
                    for q in _QUERIES[kind]:
                        if self._stop.is_set():
                            return
                        try:
                            ex.execute(SCRATCH_INDEX, q, shards=shards)
                            self.queries_run += 1
                        except Exception:
                            self.errors += 1
                            logger.exception("warmup query failed: %s "
                                             "(shards=%d)", q, n)
        finally:
            self.planner.drop_index(SCRATCH_INDEX)
        self._replay_observed()
        self.programs_compiled = len(self.planner._fn_cache) - before

    def _replay_observed(self) -> None:
        """Replay the previous incarnation's observed query shapes through
        the planner over the persisted schema, in a private Holder."""
        from pilosa_tpu_torch.exec.executor import Executor

        if not self.observed or self.planner is None:
            return
        replay = Holder(device=self.planner.device)
        try:
            replay.apply_schema(self.observed_schema)
        except Exception:
            logger.exception("warmup replay: persisted schema unusable")
            return
        ex = Executor(replay, planner=self.planner, result_cache=False)
        names = set()
        try:
            for entry in self.observed:
                if self._stop.is_set():
                    return
                try:
                    iname = entry["index"]
                    query = entry["query"]
                    n = max(1, int(entry.get("shards", 1)))
                except (KeyError, TypeError, ValueError):
                    continue
                if replay.index(iname) is None:
                    continue
                names.add(iname)
                try:
                    ex.execute(iname, query, shards=list(range(n)))
                    self.queries_run += 1
                    self.replayed += 1
                except Exception:
                    self.errors += 1
                    logger.exception("warmup replay failed: %s (%s, "
                                     "shards=%d)", query, iname, n)
        finally:
            for iname in names:
                self.planner.drop_index(iname)
