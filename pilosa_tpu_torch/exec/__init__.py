"""Query execution: the PQL call-tree interpreter over the data model."""

from pilosa_tpu_torch.exec.executor import Executor
from pilosa_tpu_torch.exec.result import Pair, ValCount, result_to_json

__all__ = ["Executor", "Pair", "ValCount", "result_to_json"]
