"""All-shards execution on one GPU: the port's cut-down MeshPlanner, with
its async path (batcher, coalescer, prefetcher) and kernel build cache."""

from pilosa_tpu_torch.parallel import compile_cache
from pilosa_tpu_torch.parallel.planner import Planner

__all__ = ["Planner", "compile_cache"]
