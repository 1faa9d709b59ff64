"""pilosa_tpu_torch — the PyTorch/CUDA port of pilosa_tpu.

A bitmap index whose rows live as dense 32-bit word blocks on an NVIDIA
GPU, with set algebra in PyTorch and its kernels written by hand in CUDA
C++ for Hopper: the two count kernels (per-row ``popcount(op(a, b))`` and
per-row popcount, ``csrc/count_kernels.cu``) and the bit-sliced integer
comparator and min/max descent (``csrc/bsi_kernels.cu``). It imports
``torch`` and never ``jax`` or the ``pilosa_tpu`` package, which stays
beside it as the reference.

Entry point: ``Holder(device=...)`` -> ``Executor(holder,
planner=Planner(holder)).execute(index, pql)``. The device defaults to
``cuda`` and a missing card raises; pass ``device="cpu"`` to run the
kernels' plain PyTorch versions on the CPU.

Layering, as in pilosa_tpu:

- :mod:`pilosa_tpu_torch.ops`      — bitmap math, BSI queries and the kernels
- :mod:`pilosa_tpu_torch.core`     — fragment/row/view/field/index/holder
- :mod:`pilosa_tpu_torch.pql`      — PQL parser
- :mod:`pilosa_tpu_torch.exec`     — query executor
- :mod:`pilosa_tpu_torch.parallel` — the all-shards planner on one GPU
- :mod:`pilosa_tpu_torch.storage`  — WAL, snapshots, reload, quarantine
- :mod:`pilosa_tpu_torch.server`   — the HTTP edge of a standalone node
"""

from pilosa_tpu_torch.config import SHARD_WIDTH, shard_width_exponent  # noqa: F401

__version__ = "0.1.0"
