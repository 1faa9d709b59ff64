"""Whole-process CPU profiling for a live node.

Reference: http/handler.go:281 exposes Go's pprof (CPU/heap) on a
running server. Python's cProfile only instruments the calling thread,
which is useless for a threaded server — so this is a SAMPLING profiler:
every tick it walks every thread's stack (``sys._current_frames``) and
aggregates per-function self/cumulative time, then serializes the result
in cProfile's marshal format so the standard ``pstats`` tooling
(``python -m pstats``, snakeviz, gprof2dot) reads it directly.

Overhead is bounded by the sampling interval (default 5 ms → ~1-2% on a
busy process), and unlike an instrumenting profiler it can be switched
on against production traffic.

The port's copy of pilosa_tpu/obs/profiler.py.
"""

from __future__ import annotations

import marshal
import sys
import threading
import time


def sample_profile(seconds: float, interval: float = 0.005,
                   skip_thread: int | None = None) -> bytes:
    """Sample all threads for ``seconds``; returns a pstats-loadable
    marshal blob (write to a file, then ``pstats.Stats(path)``)."""
    stats: dict = {}
    own = threading.get_ident()
    deadline = time.monotonic() + max(0.05, float(seconds))
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == own or tid == skip_thread:
                continue
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append((code.co_filename, code.co_firstlineno,
                              code.co_name))
                f = f.f_back
            seen = set()
            for depth, key in enumerate(stack):
                e = stats.get(key)
                if e is None:
                    e = stats[key] = [0, 0, 0.0, 0.0]
                if depth == 0:
                    e[2] += interval       # tt: executing (top of stack)
                if key not in seen:
                    e[0] += 1
                    e[1] += 1
                    e[3] += interval       # ct: anywhere on the stack
                    seen.add(key)
        time.sleep(interval)
    # cProfile dump format: {(file, line, func): (cc, nc, tt, ct,
    # callers)}; callers omitted (empty) — pstats accepts it.
    return marshal.dumps({k: (v[0], v[1], v[2], v[3], {})
                          for k, v in stats.items()})
