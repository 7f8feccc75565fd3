"""Policy inference: the continuous-batching engine (fixed-slot or paged
KV pool, speculative decode), scheduler, HTTP server with checkpoint
hot-reload, chat sessions and token streaming, and the HTTP client (the
serving slice of the port). The rollout fleet and its supervisor are not
ported yet (ROADMAP queue A, item 3), nor multi-tenant adapters (item 4,
with LoRA)."""

from trlx_tpu_torch.inference.client import (
    ChatSession,
    remote_generate,
    sse_stream,
    stream_generate,
)
from trlx_tpu_torch.inference.engine import InferenceEngine
from trlx_tpu_torch.inference.metrics import InferenceMetrics
from trlx_tpu_torch.inference.paging import BlockPool, KVPoolExhaustedError, prefix_keys
from trlx_tpu_torch.inference.scheduler import (
    DrainingError,
    InferenceRequest,
    QueueFullError,
    Scheduler,
)
from trlx_tpu_torch.inference.server import (
    CheckpointWatcher,
    InferenceServer,
    load_checkpoint_params,
)
from trlx_tpu_torch.inference.sessions import (
    SessionBusyError,
    SessionLimitError,
    SessionResetError,
    SessionStore,
)

__all__ = [
    "BlockPool",
    "ChatSession",
    "CheckpointWatcher",
    "DrainingError",
    "InferenceEngine",
    "InferenceMetrics",
    "InferenceRequest",
    "InferenceServer",
    "KVPoolExhaustedError",
    "QueueFullError",
    "Scheduler",
    "SessionBusyError",
    "SessionLimitError",
    "SessionResetError",
    "SessionStore",
    "load_checkpoint_params",
    "prefix_keys",
    "remote_generate",
    "sse_stream",
    "stream_generate",
]
