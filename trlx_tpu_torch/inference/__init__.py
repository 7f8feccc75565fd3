"""Policy inference: the continuous-batching engine (fixed-slot or paged
KV pool, speculative decode), scheduler, HTTP server with checkpoint
hot-reload, chat sessions and token streaming, the HTTP client, and the
rollout fleet: the replica router, the fleet supervisor and the policy
server process (`serve_policy`), and multi-tenant serving: many tenants'
LoRA adapters over one trunk (`adapters.AdapterStore`)."""

from trlx_tpu_torch.inference.adapters import (
    AdapterCapacityError,
    AdapterError,
    AdapterNotFoundError,
    AdapterStore,
    adapter_salt,
    load_adapter_leaves,
)
from trlx_tpu_torch.inference.client import (
    ChatSession,
    remote_generate,
    sse_stream,
    stream_generate,
)
from trlx_tpu_torch.inference.engine import InferenceEngine
from trlx_tpu_torch.inference.fleet import FleetUnavailableError, Replica, ReplicaRouter
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
from trlx_tpu_torch.inference.supervisor import (
    FleetSupervisor,
    ReplicaHandle,
    SubprocessReplica,
    ThreadReplica,
    serve_policy_command,
)

__all__ = [
    "AdapterCapacityError",
    "AdapterError",
    "AdapterNotFoundError",
    "AdapterStore",
    "BlockPool",
    "ChatSession",
    "CheckpointWatcher",
    "DrainingError",
    "FleetSupervisor",
    "FleetUnavailableError",
    "InferenceEngine",
    "InferenceMetrics",
    "InferenceRequest",
    "InferenceServer",
    "KVPoolExhaustedError",
    "QueueFullError",
    "Replica",
    "ReplicaHandle",
    "ReplicaRouter",
    "Scheduler",
    "SessionBusyError",
    "SessionLimitError",
    "SessionResetError",
    "SessionStore",
    "SubprocessReplica",
    "ThreadReplica",
    "adapter_salt",
    "load_adapter_leaves",
    "load_checkpoint_params",
    "prefix_keys",
    "remote_generate",
    "serve_policy_command",
    "sse_stream",
    "stream_generate",
]
