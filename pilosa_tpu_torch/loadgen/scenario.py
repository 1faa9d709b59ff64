"""Scenario model: everything a run needs, as plain data.

The port's copy of pilosa_tpu/loadgen/scenario.py.

A Scenario is JSON-serializable both ways (``to_dict``/``from_dict``)
so scenario configs can live in files, CI args, and SLO reports. The
engine never reads anything the Scenario doesn't carry -- same dict +
same seed → same op sequence.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field

#: query-leg kinds the engine knows how to drive
LEG_KINDS = ("dashboard", "adhoc", "bsi", "topn", "keyed", "distinct",
             "similar")


@dataclass
class QueryLeg:
    """One slice of the query mix.

    - ``dashboard``: a small fixed panel of Count queries per tenant --
      repeat-heavy, the result cache's best case.
    - ``adhoc``: randomized Intersect/Difference over a wide row
      population -- cache-miss exploratory traffic.
    - ``bsi``: Range→Sum aggregates over an int field.
    - ``topn``: TopN ranking, optionally filtered.
    - ``keyed``: string-keyed Count/Row queries (exercises key
      translation on the hot path).
    - ``distinct``: Count(Distinct(...)) over the int field -- the HLL
      sketch planes (filtered and unfiltered spellings).
    - ``similar``: SimilarTopN row-similarity ranking over the set
      field.
    """

    name: str
    weight: float = 1.0
    kind: str = "dashboard"
    qos_class: str = "interactive"
    zipf_s: float = 1.1      # skew of the within-leg query population
    population: int = 32     # distinct queries the leg draws from
    no_cache: bool = False

    def __post_init__(self):
        if self.kind not in LEG_KINDS:
            raise ValueError(f"unknown leg kind {self.kind!r} "
                             f"(want one of {LEG_KINDS})")


@dataclass
class IngestLeg:
    """Background PTS1 ingest at a duty cycle: stream a batch, then
    sleep so streaming time ≈ ``duty`` of wall time. duty=1.0 hammers
    continuously (the bench_ingest silo); 0.2 is a trickle."""

    duty: float = 0.5
    shards: int = 4
    per_shard: int = 20_000
    value_min: int = -100_000
    value_max: int = 100_000


@dataclass
class ChaosAction:
    """One timeline entry. Actions: ``slow_peer`` (value = delay ms,
    via POST /internal/fault), ``heal_peer``, ``add_node`` (live
    resize grow), ``remove_node`` (live resize shrink), ``dr_backup``
    (force one scheduled-backup cycle now), ``dr_destroy_data``
    (resize a member out and destroy its data directory -- the DR
    drill's disaster), ``partition`` (cut the network between
    ``group`` -- node indices -- and the rest of the ring; ``mode`` is
    ``drop``/``timeout`` for a symmetric cut or ``oneway`` for an
    asymmetric link where only the group's outbound traffic is lost),
    ``heal_partition`` (clear every injected partition fault)."""

    at_s: float
    action: str
    node: int = 1           # index into the target's node list
    value: float = 0.0
    group: list[int] = field(default_factory=list)  # partition side
    mode: str = "drop"      # partition flavor: drop | timeout | oneway

    def __post_init__(self):
        if self.action not in ("slow_peer", "heal_peer",
                               "add_node", "remove_node",
                               "dr_backup", "dr_destroy_data",
                               "partition", "heal_partition"):
            raise ValueError(f"unknown chaos action {self.action!r}")
        if self.mode not in ("drop", "timeout", "oneway"):
            raise ValueError(f"unknown partition mode {self.mode!r}")


@dataclass
class Scenario:
    """A full run description. ``rate`` is offered load (open-loop);
    the report records both target and achieved rates so a saturated
    load generator is visible too."""

    name: str
    seed: int = 42
    duration_s: float = 10.0
    rate: float = 50.0
    process: str = "poisson"
    cv: float = 1.0

    # target shape (managed mode; ignored when attaching to live urls)
    nodes: int = 1
    replica_n: int = 1
    node_opts: dict = field(default_factory=dict)  # ServerNode kwargs

    # dataset
    shards: int = 4
    rows: int = 64
    density: float = 0.01    # fraction of each shard's columns set

    # mix
    tenants: int = 8
    tenant_s: float = 1.1
    legs: list[QueryLeg] = field(default_factory=list)
    ingest: IngestLeg | None = None
    chaos: list[ChaosAction] = field(default_factory=list)

    # disaster-recovery drill (managed mode only): when set, the engine
    # boots a fault-injected in-process object store, gives every node
    # a data dir plus an unattended backup scheduler pointed at it, and
    # after the run restores the archive into a fresh recovery cluster
    # and proves bit-equivalence. Keys: failRate (per-request 503
    # probability), intervalS (scheduler cadence), fullEvery,
    # keepChains, recoveryNodes, tornUploads.
    dr: dict | None = None

    # the load generator
    max_workers: int = 64
    warmup_queries: int = 8

    def __post_init__(self):
        if not self.legs:
            raise ValueError(f"scenario {self.name!r} has no query legs")

    def to_dict(self) -> dict:
        d = asdict(self)
        d["ingest"] = asdict(self.ingest) if self.ingest else None
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Scenario":
        d = dict(d)
        d["legs"] = [QueryLeg(**leg) for leg in d.get("legs", [])]
        ing = d.get("ingest")
        d["ingest"] = IngestLeg(**ing) if ing else None
        d["chaos"] = [ChaosAction(**c) for c in d.get("chaos", [])]
        return cls(**d)
