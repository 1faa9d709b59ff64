"""loadgen -- the open-loop traffic harness.

The port's copy of pilosa_tpu/loadgen/: the same scenarios, seeded
schedules and report schema, sending load to the port's nodes (managed nodes on
the card unless the caller asks for the CPU).

A *scenario* describes production-shaped load: an open-loop arrival
process (arrivals fire on a precomputed schedule, never gated on
completions, so queue buildup is visible instead of hidden), a
zipf-skewed workload mix of query legs, a background PTS1 ingest leg,
and an optional chaos timeline. One run drives a live node or cluster
over HTTP and emits a machine-readable SLO report: per-QoS-class
p50/p99/p999, shed/quota/hedge/breaker rates, cache hit ratio, ingest
throughput, and p99 exemplar trace ids resolved through
``/debug/queries/<trace-id>`` into full cost profiles.

Run one with ``python -m pilosa_tpu_torch.loadgen <scenario>`` (see
``scenarios.py`` for the built-ins) and gate its report with
``scripts/slo_gate.py``.
"""

from pilosa_tpu_torch.loadgen.arrival import OpenLoopArrivals
from pilosa_tpu_torch.loadgen.engine import run_scenario
from pilosa_tpu_torch.loadgen.mix import WorkloadMix, ZipfPicker, zipf_weights
from pilosa_tpu_torch.loadgen.report import validate_report
from pilosa_tpu_torch.loadgen.scenario import (ChaosAction, IngestLeg, QueryLeg,
                                         Scenario)
from pilosa_tpu_torch.loadgen.scenarios import SCENARIOS, get_scenario
from pilosa_tpu_torch.loadgen.target import AttachedTarget, ManagedTarget

__all__ = [
    "OpenLoopArrivals", "WorkloadMix", "ZipfPicker", "zipf_weights",
    "Scenario", "QueryLeg", "IngestLeg", "ChaosAction",
    "run_scenario", "validate_report", "SCENARIOS", "get_scenario",
    "AttachedTarget", "ManagedTarget",
]
