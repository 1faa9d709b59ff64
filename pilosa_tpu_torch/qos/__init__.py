"""Quality-of-service: query admission control, deadlines, load shedding
and slow-query logging.

The port's copy of pilosa_tpu/qos/ without ``warmup.py``: the JAX
package's warmup precompiles its planner's XLA programs, and the port's
counterpart (build the CUDA sources, launch the canonical shapes once)
comes with the plan cache (ROADMAP.md Queue 1: executor remainder).
"""

from .adaptive import AdaptiveLimit
from .admission import (
    CLASS_BATCH,
    CLASS_INTERACTIVE,
    CLASS_INTERNAL,
    DEFAULT_WEIGHTS,
    QOS_CLASSES,
    AdmissionController,
    IngestBackpressureError,
    IngestGate,
    QueryShedError,
    normalize_class,
)
from .deadline import (
    DEADLINE_HEADER,
    Deadline,
    DeadlineExceededError,
    check_current,
    current_deadline,
    extract_http_headers,
    inject_http_headers,
    reset_current_deadline,
    set_current_deadline,
)
from .quota import QuotaExceededError, TenantQuotas
from .slowlog import SlowQueryLog

__all__ = [
    "AdaptiveLimit",
    "AdmissionController",
    "CLASS_BATCH",
    "CLASS_INTERACTIVE",
    "CLASS_INTERNAL",
    "DEADLINE_HEADER",
    "DEFAULT_WEIGHTS",
    "Deadline",
    "DeadlineExceededError",
    "IngestBackpressureError",
    "IngestGate",
    "QOS_CLASSES",
    "QueryShedError",
    "QuotaExceededError",
    "SlowQueryLog",
    "TenantQuotas",
    "check_current",
    "current_deadline",
    "extract_http_headers",
    "inject_http_headers",
    "normalize_class",
    "reset_current_deadline",
    "set_current_deadline",
]
