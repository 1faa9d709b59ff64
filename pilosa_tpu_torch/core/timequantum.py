"""Time quantum: multi-granularity time views.

The port's copy of pilosa_tpu/core/timequantum.py (host only).

Reference: time.go (TimeQuantum :28, viewsByTime :91, viewsByTimeRange
:104, addMonth :178, parseTime :219). A field with quantum "YMDH" writes
each timestamped bit into up to 4 extra views (standard_2017, _201701,
_20170102, _2017010203); a range query greedily covers [start, end) with
the fewest views.
"""

from __future__ import annotations

import datetime as dt

from pilosa_tpu_torch.config import TIME_FORMAT
from pilosa_tpu_torch.errors import InvalidTimeQuantumError

_VALID = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}

_UNIT_FMT = {"Y": "%Y", "M": "%Y%m", "D": "%Y%m%d", "H": "%Y%m%d%H"}


def validate_quantum(q: str) -> str:
    if q not in _VALID:
        raise InvalidTimeQuantumError(f"invalid time quantum: {q!r}")
    return q


def parse_time(t) -> dt.datetime:
    """str (reference TimeFormat) or unix seconds -> datetime."""
    if isinstance(t, str):
        try:
            return dt.datetime.strptime(t, TIME_FORMAT)
        except ValueError:
            raise ValueError("cannot parse string time") from None
    if isinstance(t, int):
        return dt.datetime.fromtimestamp(t, dt.timezone.utc).replace(tzinfo=None)
    raise ValueError(f"invalid time type {type(t)}")


def view_by_time_unit(name: str, t: dt.datetime, unit: str) -> str:
    fmt = _UNIT_FMT.get(unit)
    return f"{name}_{t.strftime(fmt)}" if fmt else ""


def views_by_time(name: str, t: dt.datetime, quantum: str) -> list[str]:
    """All views a timestamped bit lands in (reference viewsByTime)."""
    return [v for u in quantum if (v := view_by_time_unit(name, t, u))]


def _add_year(t: dt.datetime) -> dt.datetime:
    try:
        return t.replace(year=t.year + 1)
    except ValueError:  # Feb 29
        return t.replace(year=t.year + 1, day=28)


def _add_month_norm(t: dt.datetime) -> dt.datetime:
    """time.AddDate(0,1,0) semantics: overflow normalizes (Jan 31 -> Mar 3)."""
    y, m = divmod(t.month, 12)
    y, m = t.year + y, m + 1
    days_in = (dt.datetime(y + (m == 12), (m % 12) + 1, 1) - dt.datetime(y, m, 1)).days
    overflow = t.day - days_in
    if overflow > 0:
        base = dt.datetime(y, m, days_in, t.hour, t.minute)
        return base + dt.timedelta(days=overflow)
    return t.replace(year=y, month=m)


def _add_month(t: dt.datetime) -> dt.datetime:
    """Reference addMonth (time.go:178): clamp day>28 to the 1st first so
    a YM walk can't skip a month."""
    if t.day > 28:
        t = dt.datetime(t.year, t.month, 1, t.hour, 0)
    return _add_month_norm(t)


def _next_year_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _add_year(t)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = _add_month_norm(t)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _next_day_gte(t: dt.datetime, end: dt.datetime) -> bool:
    nxt = t + dt.timedelta(days=1)
    return nxt.date() == end.date() or end > nxt


def views_by_time_range(name: str, start: dt.datetime, end: dt.datetime,
                        quantum: str) -> list[str]:
    """Minimal view cover of [start, end) (reference viewsByTimeRange
    time.go:104): walk up small→large units to a coarse boundary, then back
    down large→small."""
    validate_quantum(quantum)
    has_y, has_m = "Y" in quantum, "M" in quantum
    has_d, has_h = "D" in quantum, "H" in quantum
    t = start
    results: list[str] = []

    # Walk up from smallest units to largest.
    if has_h or has_d or has_m:
        while t < end:
            if has_h:
                if not _next_day_gte(t, end):
                    break
                elif t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t += dt.timedelta(hours=1)
                    continue
            if has_d:
                if not _next_month_gte(t, end):
                    break
                elif t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t += dt.timedelta(days=1)
                    continue
            if has_m:
                if not _next_year_gte(t, end):
                    break
                elif t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_month(t)
                    continue
            break

    # Walk back down from largest to smallest.
    while t < end:
        if has_y and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = _add_year(t)
        elif has_m and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_month(t)
        elif has_d and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t += dt.timedelta(days=1)
        elif has_h:
            results.append(view_by_time_unit(name, t, "H"))
            t += dt.timedelta(hours=1)
        else:
            break

    return results
