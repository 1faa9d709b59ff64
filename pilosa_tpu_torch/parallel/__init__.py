"""All-shards execution on one GPU: the port's cut-down MeshPlanner."""

from pilosa_tpu_torch.parallel.planner import Planner

__all__ = ["Planner"]
