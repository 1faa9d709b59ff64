"""Device functions of the ``hll`` representation class.

The port's counterpart of pilosa_tpu/sketch/kernels.py. The resident forms
(built host-side in sketch/store.py, uploaded and cached by the planner
like any other leaf stack):

* register stack -- ``[S, 2^p]`` uint8, one HLL register file per shard.
  The unfiltered ``Count(Distinct(...))`` reduces it with one register
  max over the shard axis (``hll_reduce``).
* packed plane -- ``[S, SHARD_WIDTH]`` int32 of ``bucket | rho << 18`` per
  column (0 = column absent). The FILTERED path needs per-column
  granularity: the filter tree evaluates to an ``[S, W]`` word plane, and
  ``hll_expand`` re-derives the registers of exactly the surviving columns
  (the masked register gather), with no row set leaving the device.

The gather and the reduce are the hand-written kernels ``hll_expand`` and
``hll_reduce`` of ops/kernels.py (csrc/sketch_kernels.cu), which the
``hll`` row of exec/residency.py names. The estimate functions here stay
torch ops: the executor estimates on the host in float64, and these exist
so that row carries the dense op set, as in the JAX package.
``similar_totals`` is SimilarTopN's device program: the ``similar_count``
kernel's three totals, then a stable descending sort of the overlaps in
place of ``jax.lax.top_k`` (ties go to the lower index).
"""

from __future__ import annotations

import torch

from pilosa_tpu_torch.ops import kernels
from pilosa_tpu_torch.sketch.hll import _alpha


def hll_count(regs: torch.Tensor, p: int | None = None) -> torch.Tensor:
    """Device-side harmonic estimate of register arrays (float32, with the
    linear-counting small-range correction as a select); the last axis
    holds the registers."""
    regs = regs.to(torch.float32)
    m = regs.shape[-1]
    est = _alpha(m) * m * m / torch.sum(torch.exp2(-regs), dim=-1)
    zeros = torch.sum((regs == 0).to(torch.float32), dim=-1)
    linear = m * torch.log(m / torch.clamp(zeros, min=1.0))
    return torch.where((est <= 2.5 * m) & (zeros > 0), linear, est)


def hll_and_count(a_regs: torch.Tensor, b_regs: torch.Tensor) -> torch.Tensor:
    """Estimated |A AND B| by inclusion-exclusion over register maxima:
    est(A) + est(B) - est(A OR B)."""
    union = torch.maximum(a_regs, b_regs)
    return hll_count(a_regs) + hll_count(b_regs) - hll_count(union)


def hll_pair_count(a_regs: torch.Tensor, b_regs: torch.Tensor) -> torch.Tensor:
    """The same inclusion-exclusion estimate, registered under the
    ``pair_count`` op so the class carries the full dense op set."""
    return hll_and_count(a_regs, b_regs)


def similar_totals(cube: torch.Tensor, filt: torch.Tensor):
    """SimilarTopN's program over an id-ascending ``[R, S, W]`` candidate
    cube and the evaluated ``[S, W]`` filter: (order ``[R]``, inter
    ``[R]``, selfc ``[R]``, filtc ``[]``), int32 totals summed over the
    shards, ``order`` the overlaps ranked best-first with ties to the lower
    index (what ``jax.lax.top_k`` gives)."""
    inter, selfc, filtc = kernels.similar_count(cube, filt)
    order = torch.sort(inter, descending=True, stable=True).indices
    return order, inter, selfc, filtc

