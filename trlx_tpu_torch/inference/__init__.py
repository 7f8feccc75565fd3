"""Policy inference: paged continuous-batching engine, scheduler and
HTTP server (the serving slice of the port)."""

from trlx_tpu_torch.inference.engine import InferenceEngine
from trlx_tpu_torch.inference.metrics import InferenceMetrics
from trlx_tpu_torch.inference.paging import BlockPool, KVPoolExhaustedError, prefix_keys
from trlx_tpu_torch.inference.scheduler import (
    DrainingError,
    InferenceRequest,
    QueueFullError,
    Scheduler,
)
from trlx_tpu_torch.inference.server import InferenceServer

__all__ = [
    "BlockPool",
    "DrainingError",
    "InferenceEngine",
    "InferenceMetrics",
    "InferenceRequest",
    "InferenceServer",
    "KVPoolExhaustedError",
    "QueueFullError",
    "Scheduler",
    "prefix_keys",
]
