"""Workload-mix model: zipf-skewed tenant and query populations.

The port's copy of pilosa_tpu/loadgen/mix.py.

Production traffic is never uniform -- a few tenants and a few
dashboard panels dominate. A zipf(s) rank-frequency law over a finite
population captures that: P(rank r) ∝ 1/r^s. s≈1 is classic web
skew; s=0 degenerates to uniform (handy for control runs).
"""

from __future__ import annotations

import numpy as np


def zipf_weights(n: int, s: float) -> np.ndarray:
    """Normalized zipf pmf over ranks 1..n (rank 0 is the hottest)."""
    if n <= 0:
        raise ValueError(f"population must be > 0, got {n}")
    w = 1.0 / np.power(np.arange(1, n + 1, dtype=np.float64), s)
    return w / w.sum()


class ZipfPicker:
    """Seedable categorical sampler over a zipf-weighted population.

    Sampling goes through a precomputed cdf + searchsorted -- O(log n)
    per pick, bit-deterministic given the caller's rng state.
    """

    def __init__(self, n: int, s: float):
        self.n = n
        self.s = s
        self._cdf = np.cumsum(zipf_weights(n, s))

    def pick(self, rng: np.random.Generator) -> int:
        """One rank in [0, n) -- 0 is the hottest."""
        return int(np.searchsorted(self._cdf, rng.random(), side="right"))


class WorkloadMix:
    """Weighted choice over named legs plus a shared tenant population.

    ``sample(rng)`` → (leg_name, tenant_rank). Leg weights are
    arbitrary positives (normalized internally); tenants follow
    zipf(tenant_s) so the hot-tenant cache/quota interactions show up.
    """

    def __init__(self, legs: list[tuple[str, float]],
                 n_tenants: int = 8, tenant_s: float = 1.1):
        if not legs:
            raise ValueError("mix needs at least one leg")
        names, weights = zip(*legs)
        w = np.asarray(weights, dtype=np.float64)
        if (w <= 0).any():
            raise ValueError(f"leg weights must be > 0, got {list(w)}")
        self.names = list(names)
        self._leg_cdf = np.cumsum(w / w.sum())
        self.tenants = ZipfPicker(n_tenants, tenant_s)

    def sample(self, rng: np.random.Generator) -> tuple[str, int]:
        leg = self.names[int(np.searchsorted(self._leg_cdf, rng.random(),
                                             side="right"))]
        return leg, self.tenants.pick(rng)
