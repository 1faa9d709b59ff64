"""Open-loop arrival schedule generation.

The port's copy of pilosa_tpu/loadgen/arrival.py.

The whole schedule is drawn up front from a seeded generator, BEFORE
the first request fires. That is what makes the harness open-loop: an
arrival's time depends only on (seed, rate, process), never on how
long earlier requests took, so a saturated server shows up as queue
delay in the latency distribution instead of silently throttling the
offered load the way closed-loop ("fire the next request when the
last one answers") load generators do.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: supported inter-arrival processes
PROCESSES = ("poisson", "gamma", "uniform")


@dataclass(frozen=True)
class OpenLoopArrivals:
    """Seeded arrival-schedule generator at a target rate.

    - ``poisson``: exponential inter-arrivals (cv = 1) -- memoryless
      open traffic, the M/G/k default.
    - ``gamma``: gamma inter-arrivals with coefficient of variation
      ``cv`` (> 1 burstier than Poisson, < 1 smoother) at the same
      mean rate.
    - ``uniform``: constant spacing -- a pure-pacing control leg.
    """

    rate: float              # target arrivals per second
    duration_s: float        # schedule horizon
    process: str = "poisson"
    cv: float = 1.0          # gamma only: std/mean of inter-arrivals
    seed: int = 0

    def __post_init__(self):
        if self.rate <= 0:
            raise ValueError(f"rate must be > 0, got {self.rate}")
        if self.duration_s <= 0:
            raise ValueError(f"duration_s must be > 0, got {self.duration_s}")
        if self.process not in PROCESSES:
            raise ValueError(f"unknown process {self.process!r} "
                             f"(want one of {PROCESSES})")
        if self.process == "gamma" and self.cv <= 0:
            raise ValueError(f"cv must be > 0, got {self.cv}")

    def schedule(self) -> np.ndarray:
        """Absolute arrival offsets (seconds from run start), sorted,
        all < duration_s. Same seed → bit-identical schedule."""
        rng = np.random.default_rng(self.seed)
        mean = 1.0 / self.rate
        # Draw in chunks until the horizon is covered; the draw count
        # per chunk is deterministic, so the schedule is too.
        n_chunk = max(16, int(self.rate * self.duration_s * 1.2) + 8)
        gaps = []
        total = 0.0
        while total < self.duration_s:
            if self.process == "poisson":
                g = rng.exponential(mean, n_chunk)
            elif self.process == "gamma":
                shape = 1.0 / (self.cv ** 2)
                g = rng.gamma(shape, mean / shape, n_chunk)
            else:  # uniform
                g = np.full(n_chunk, mean)
            gaps.append(g)
            total += float(g.sum())
        offsets = np.cumsum(np.concatenate(gaps))
        return offsets[offsets < self.duration_s]
