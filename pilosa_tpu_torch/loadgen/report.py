"""SLO report: the machine-readable artifact one scenario run emits.

The port's copy of pilosa_tpu/loadgen/report.py.

Numbers come from the observability substrate, never private lists:
client-side latencies live in the engine's MemoryStats LogHistograms
(read back through ``timing_quantile``), server-side per-class
latencies are parsed out of each node's ``/metrics`` histogram
buckets, and the p99 tail links to real queries via exemplar trace
ids resolved through ``/debug/queries/<trace-id>``.

``validate_report`` is the schema contract CI and ``slo_gate.py``
hold a report to; bump SCHEMA_VERSION when the shape changes.
"""

from __future__ import annotations

import re

SCHEMA_VERSION = 1

#: required document shape: path → type (dict/list checked by isinstance;
#: "num" accepts int|float). A path segment of "*" means every child.
_REQUIRED: list[tuple[str, type | str]] = [
    ("schemaVersion", int),
    ("scenario", dict),
    ("scenario.name", str),
    ("scenario.seed", int),
    ("target", dict),
    ("target.mode", str),
    ("target.nodes", int),
    ("arrivals", dict),
    ("arrivals.process", str),
    ("arrivals.rateTarget", "num"),
    ("arrivals.rateAchieved", "num"),
    ("arrivals.scheduled", int),
    ("arrivals.dispatched", int),
    ("arrivals.maxLagMs", "num"),
    ("perClass", dict),
    ("perClass.*", dict),
    ("perClass.*.client", dict),
    ("perClass.*.client.count", int),
    ("perClass.*.client.p50Ms", "num"),
    ("perClass.*.client.p99Ms", "num"),
    ("perClass.*.client.p999Ms", "num"),
    ("perClass.*.counts", dict),
    ("perClass.*.shedRate", "num"),
    ("perClass.*.errorRate", "num"),
    ("legs", dict),
    ("legs.*.count", int),
    ("legs.*.p50Ms", "num"),
    ("legs.*.p99Ms", "num"),
    ("rates", dict),
    ("rates.shed", "num"),
    ("rates.quota", "num"),
    ("rates.deadlineMiss", "num"),
    ("rates.hedgeFired", "num"),
    ("rates.hedgeWon", "num"),
    ("rates.breakerOpens", "num"),
    ("cache", dict),
    ("cache.hitRatio", "num"),
    ("exemplars", list),
]


def _walk(doc, segs):
    """Yield every value at ``segs`` (expanding '*')."""
    if not segs:
        yield doc
        return
    head, rest = segs[0], segs[1:]
    if not isinstance(doc, dict):
        return
    if head == "*":
        for v in doc.values():
            yield from _walk(v, rest)
    elif head in doc:
        yield from _walk(doc[head], rest)
    else:
        yield KeyError(head)


def validate_report(doc: dict) -> list[str]:
    """Schema errors, empty when the report is well-formed."""
    errors = []
    for path, want in _REQUIRED:
        segs = path.split(".")
        found = False
        for v in _walk(doc, segs):
            found = True
            if isinstance(v, KeyError):
                errors.append(f"missing: {path}")
            elif want == "num":
                if not isinstance(v, (int, float)) or isinstance(v, bool):
                    errors.append(f"{path}: want number, got {type(v).__name__}")
            elif not isinstance(v, want):
                errors.append(f"{path}: want {want.__name__}, "
                              f"got {type(v).__name__}")
        if not found and "*" not in segs:
            errors.append(f"missing: {path}")
    if doc.get("schemaVersion") != SCHEMA_VERSION:
        errors.append(f"schemaVersion: want {SCHEMA_VERSION}, "
                      f"got {doc.get('schemaVersion')}")
    return errors


# -- /metrics parsing ----------------------------------------------------

_BUCKET_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)_bucket\{(?P<labels>[^}]*)\}'
    r' (?P<cum>\d+)'
    r'(?: # \{trace_id="(?P<tid>[^"]+)"\} (?P<exval>[0-9.eE+-]+))?$')
_LABEL_RE = re.compile(r'(\w+)="([^"]*)"')


class PromHistogram:
    """One parsed exposition histogram series (fixed label set)."""

    def __init__(self):
        self.buckets: list[tuple[float, int]] = []   # (le, cumulative)
        self.exemplars: list[tuple[str, float]] = [] # (trace_id, seconds)

    @property
    def count(self) -> int:
        return self.buckets[-1][1] if self.buckets else 0

    def quantile(self, q: float) -> float:
        """histogram_quantile with linear interpolation inside the
        winning bucket (same estimate LogHistogram.quantile makes)."""
        total = self.count
        if total == 0:
            return 0.0
        rank = q * total
        lo, prev_cum = 0.0, 0
        for le, cum in self.buckets:
            if cum >= rank:
                if le == float("inf"):
                    return lo   # +Inf bucket: floor at last finite bound
                frac = ((rank - prev_cum) / (cum - prev_cum)
                        if cum > prev_cum else 1.0)
                return lo + frac * (le - lo)
            lo, prev_cum = le, cum
        return self.buckets[-1][0]


def parse_prom_histograms(text: str,
                          name: str) -> dict[tuple, PromHistogram]:
    """All series of histogram ``name`` (e.g. "pilosa_qos_service_seconds")
    keyed by their sorted non-``le`` label pairs. Bucket exemplars are
    collected in line order (the exporter only attaches them at p99+)."""
    out: dict[tuple, PromHistogram] = {}
    for line in text.splitlines():
        if not line.startswith(name + "_bucket"):
            continue
        m = _BUCKET_RE.match(line)
        if m is None or m.group("name") != name:
            continue
        labels = dict(_LABEL_RE.findall(m.group("labels")))
        le = float(labels.pop("le"))
        key = tuple(sorted(labels.items()))
        h = out.setdefault(key, PromHistogram())
        h.buckets.append((le, int(m.group("cum"))))
        if m.group("tid"):
            h.exemplars.append((m.group("tid"), float(m.group("exval"))))
    for h in out.values():
        h.buckets.sort()
    return out


def tail_exemplars(hist) -> list[tuple[str, float]]:
    """(trace_id, seconds) exemplars at and above a LogHistogram's p99
    bucket -- the budget-blowing queries worth resolving into profiles."""
    out = []
    p99 = hist.p99_bucket_index()
    for i in range(len(hist.counts)):
        if i < p99:
            continue
        ex = hist.exemplar(i)
        if ex is not None:
            val, tid = ex
            if tid:
                out.append((tid, val))
    out.sort(key=lambda e: -e[1])
    return out
