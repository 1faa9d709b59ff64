"""BackupScheduler -- unattended periodic backups with retention.

The port's counterpart of pilosa_tpu/backup/scheduler.py. The scheduler
turns operator-initiated backups into a background habit: every
``interval`` seconds it drives one ``BackupWriter`` run through the QoS
internal class, incremental against the last success, opening a fresh
full chain every ``full_every`` runs so retention has something to
prune. Design constraints, in order:

- **never hurt the serving path.** A failing archive degrades to
  alerting (counters + log lines), never to blocking queries or
  crashing the node: every run is wrapped, every failure backs off
  exponentially (full jitter, bounded) before the next attempt.
- **coordinator-only, with takeover.** On a cluster every node ticks,
  but only the current coordinator captures; when the coordinator
  changes, the new one's next tick picks the duty up and *adopts* the
  latest complete backup in the archive as its incremental parent, so
  a handoff doesn't force a full.
- **no-op cycles are free.** If no index epoch moved since the parent
  manifest, the cycle is skipped without touching a fragment (the
  ``skipped-unchanged`` fast path).

Health surface: ``backup.scheduler.{runs,skipped,failed,overruns,
consecutiveFailures,lastSuccessEpoch}`` on /debug/vars and /metrics,
plus ``status()`` behind /debug/backup and a slowlog of runs that
overran their interval.

Deterministic by construction: the clock, and the jitter rng are
injectable, so the fake-clock tests replay interval math, backoff
curves, and coordinator handoffs exactly.
"""

from __future__ import annotations

import random
import time as _time
from collections import deque

from pilosa_tpu_torch.backup.archive import BackupError
from pilosa_tpu_torch.backup.retention import prune_archive
from pilosa_tpu_torch.backup.writer import BackupWriter

#: new full chain every N runs (the incremental chain's max length);
#: retention prunes whole superseded chains.
DEFAULT_FULL_EVERY = 8
#: failure backoff never exceeds this many intervals
MAX_BACKOFF_INTERVALS = 8
#: slowlog entries kept (runs that overran the interval)
SLOWLOG_KEEP = 16

#: run_once outcomes
RAN = "ran"
SKIP_UNCHANGED = "skipped-unchanged"
SKIP_NOT_COORDINATOR = "skipped-not-coordinator"
SKIP_FENCED = "skipped-fenced"
SKIP_NOT_DUE = "waiting"
FAILED = "failed"


class BackupScheduler:
    """Periodic incremental backups into one archive. ``tick()`` is the
    only entry point the node's timer calls; it is cheap unless a run
    is actually due, and it never raises."""

    def __init__(self, *, holder, cluster, client, store, archive,
                 interval: float, node_id: str | None = None,
                 stats=None, logger=None, admission=None,
                 full_every: int = DEFAULT_FULL_EVERY,
                 keep_chains: int = 0,
                 clock=_time.monotonic, rng=None):
        self.holder = holder
        self.cluster = cluster
        self.client = client
        self.store = store
        self.archive = archive
        self.interval = interval
        self.node_id = node_id
        self.stats = stats
        self.logger = logger
        self.admission = admission
        self.full_every = max(1, full_every)
        self.keep_chains = keep_chains
        self.clock = clock
        self._rng = rng or random.Random()

        now = clock()
        self._next_due = now + interval
        self._backoff_until = now
        self._adopted = False
        self.last_manifest: dict | None = None
        self._runs_in_chain = 0
        self.consecutive_failures = 0
        self.last_error: str | None = None
        self.last_status: str = "idle"
        self.last_success_wall: float | None = None
        self.last_prune: dict | None = None
        self.slowlog: deque = deque(maxlen=SLOWLOG_KEEP)
        self.runs = 0
        self.skipped = 0
        self.failed = 0

    # -- helpers -----------------------------------------------------------

    def _count(self, name: str, value: int = 1) -> None:
        if self.stats is not None:
            self.stats.count(name, value)

    def _gauge(self, name: str, value: float) -> None:
        if self.stats is not None:
            self.stats.gauge(name, value)

    def _log(self, fmt: str, *args) -> None:
        if self.logger is not None:
            self.logger.printf(fmt, *args)

    def _is_coordinator(self) -> bool:
        if self.cluster is None or self.node_id is None:
            return True
        coord = self.cluster.coordinator()
        return coord is None or coord.id == self.node_id

    def _is_fenced(self) -> bool:
        """Fencing gate for the coordinator duty: a fenced coordinator
        is on the minority side of a partition, where the majority may
        already have a successor ticking -- two schedulers capturing and
        pruning the same archive is exactly the split-brain retention
        was not designed to survive."""
        return (self.cluster is not None
                and getattr(self.cluster, "fenced", False))

    def _current_epochs(self) -> dict:
        epochs = {}
        for iname in self.holder.index_names():
            idx = self.holder.index(iname)
            epochs[iname] = {"instance": idx.instance_id,
                             "epoch": idx.epoch.value,
                             "schemaEpoch": idx.schema_epoch.value}
        return epochs

    def _adopt_latest(self) -> None:
        """Continue the chain across restarts and coordinator handoffs:
        the latest complete backup in the archive becomes the parent,
        with the chain position recovered by walking its parents."""
        self._adopted = True
        try:
            best = None
            for bid in self.archive.list_backups():
                m = self.archive.read_manifest(bid)
                if best is None or m.get("created", 0) > best["created"]:
                    best = m
            if best is None:
                return
            depth, cur, manifests = 1, best, {best["id"]: best}
            while cur.get("parent"):
                pid = cur["parent"]
                if pid in manifests or not self.archive.has_manifest(pid):
                    break
                cur = self.archive.read_manifest(pid)
                manifests[pid] = cur
                depth += 1
            self.last_manifest = best
            self._runs_in_chain = depth
        except (BackupError, OSError, ValueError) as e:
            # Unreadable archive state: start a fresh full chain.
            self._log("backup scheduler: adopt failed (%s); "
                      "starting a new full chain", e)
            self.last_manifest = None
            self._runs_in_chain = 0

    # -- the tick ----------------------------------------------------------

    def due(self, now: float | None = None) -> bool:
        now = self.clock() if now is None else now
        return now >= self._next_due and now >= self._backoff_until

    def tick(self) -> str:
        """Timer entry point: run if due, swallow everything -- a broken
        archive must degrade to counters, never take the node down."""
        try:
            if not self.due():
                return SKIP_NOT_DUE
            return self.run_once()
        except BaseException as e:  # belt and braces over run_once
            self.last_error = str(e)
            self.last_status = FAILED
            return FAILED

    def run_once(self, now: float | None = None,
                 force: bool = False) -> str:
        """One scheduling decision + (maybe) one backup run. ``force``
        bypasses the due/backoff checks (drills, tests), not the
        coordinator or epoch checks."""
        now = self.clock() if now is None else now
        self._next_due = now + self.interval
        if not force and now < self._backoff_until:
            return SKIP_NOT_DUE

        if not self._is_coordinator():
            # Another node owns the duty; stay warm for takeover.
            self.skipped += 1
            self._count("backup.scheduler.skipped")
            self.last_status = SKIP_NOT_COORDINATOR
            return SKIP_NOT_COORDINATOR

        if self._is_fenced():
            # Still nominally coordinator, but we cannot see a majority
            # of the ring: suspend the duty until the fence lifts.
            self.skipped += 1
            self._count("backup.scheduler.skippedFenced")
            self.last_status = SKIP_FENCED
            return SKIP_FENCED

        if not self._adopted:
            self._adopt_latest()

        parent = None
        if (self.last_manifest is not None
                and self._runs_in_chain < self.full_every):
            parent = self.last_manifest["id"]

        # Epoch fast path: no index moved since the parent capture and
        # none appeared or vanished -- the cycle is a no-op, skip it
        # without touching a single fragment.
        if parent is not None \
                and self._current_epochs() == self.last_manifest.get(
                    "epochs"):
            self.skipped += 1
            self._count("backup.scheduler.skipped")
            self.last_status = SKIP_UNCHANGED
            return SKIP_UNCHANGED

        writer = BackupWriter(self.holder, self.cluster, self.client,
                              self.store, self.archive, stats=self.stats,
                              logger=self.logger,
                              admission=self.admission)
        try:
            manifest = writer.run(parent=parent)
        except BaseException as e:
            self._on_failure(now, e)
            return FAILED

        self.runs += 1
        self.consecutive_failures = 0
        self.last_error = None
        self.last_manifest = manifest
        self._runs_in_chain = (1 if parent is None
                               else self._runs_in_chain + 1)
        self.last_success_wall = manifest.get("created", _time.time())
        self._count("backup.scheduler.runs")
        self._gauge("backup.scheduler.consecutiveFailures", 0)
        self._gauge("backup.scheduler.lastSuccessEpoch",
                    self.last_success_wall)
        self.last_status = RAN

        if self.keep_chains > 0:
            try:
                self.last_prune = prune_archive(
                    self.archive, self.keep_chains, stats=self.stats,
                    logger=self.logger, fence=self._is_fenced)
            except BaseException as e:
                # Retention trouble alerts but never fails the backup.
                self._count("backup.retention.failures")
                self._log("backup retention failed: %s", e)

        took = self.clock() - now
        if self.interval > 0 and took > self.interval:
            # Slowlog: the cadence silently degraded to ~took seconds;
            # an operator reading /debug/backup should see it.
            self.slowlog.append({"id": manifest["id"],
                                 "seconds": round(took, 3),
                                 "intervalS": self.interval,
                                 "finishedEpoch": self.last_success_wall})
            self._count("backup.scheduler.overruns")
            self._log("backup %s overran its interval: %.1fs > %.1fs",
                      manifest["id"], took, self.interval)
        return RAN

    def _on_failure(self, now: float, err: BaseException) -> None:
        self.failed += 1
        self.consecutive_failures += 1
        self.last_error = str(err)
        self.last_status = FAILED
        self._count("backup.scheduler.failed")
        self._gauge("backup.scheduler.consecutiveFailures",
                    self.consecutive_failures)
        # Full-jitter exponential backoff in units of the interval: a
        # down archive costs one cheap failed attempt per backoff
        # window, not a capture storm.
        mult = min(MAX_BACKOFF_INTERVALS,
                   2 ** (self.consecutive_failures - 1))
        delay = self.interval * mult * (1.0 + self._rng.uniform(0, 0.25))
        self._backoff_until = now + delay
        self._log("backup scheduler: run failed (%s); backing off %.1fs "
                  "(%d consecutive)", err, delay,
                  self.consecutive_failures)

    # -- introspection -----------------------------------------------------

    def status(self) -> dict:
        """The /debug/backup document."""
        now = self.clock()
        return {
            "intervalS": self.interval,
            "fullEvery": self.full_every,
            "keepChains": self.keep_chains,
            "runs": self.runs,
            "skipped": self.skipped,
            "failed": self.failed,
            "consecutiveFailures": self.consecutive_failures,
            "lastStatus": self.last_status,
            "lastError": self.last_error,
            "fenced": self._is_fenced(),
            "lastSuccessEpoch": self.last_success_wall,
            "lastBackupId": (self.last_manifest or {}).get("id"),
            "runsInChain": self._runs_in_chain,
            "nextDueInS": round(max(self._next_due, self._backoff_until)
                                - now, 3),
            "backoffRemainingS": round(max(0.0,
                                           self._backoff_until - now), 3),
            "lastPrune": self.last_prune,
            "slowlog": list(self.slowlog),
        }
