"""dynamo_tpu_torch.runtime — the distributed runtime of the port.

Port of `dynamo_tpu/runtime` on a standard-library codec: the same
discovery service, request plane, frames and discovery layout, so a port
worker and a reference frontend share one control plane and one wire.
Public surface as the reference's for these modules: DistributedRuntime,
Namespace/Component/Endpoint, Context, PushRouter/RouterMode, discovery
client/server, config, logging.
"""

from . import faults
from .backoff import Backoff
from .config import RuntimeConfig, discovery_address
from .component import (
    Client,
    Component,
    DistributedRuntime,
    Endpoint,
    Instance,
    Namespace,
    ServedEndpoint,
    INSTANCE_ROOT,
    MODEL_ROOT,
)
from .discovery import DiscoveryClient, DiscoveryServer, Lease, Watch, WatchEvent
from .engine import Context
from .logging import (
    DistributedTraceContext,
    current_trace,
    init_logging,
    parse_traceparent,
    set_trace,
)
from .push_router import PushRouter, RouterMode
from .request_plane import (
    DeadlineExceeded,
    EndpointStats,
    EngineError,
    RequestPlaneClient,
    RequestPlaneServer,
    StreamLost,
)

__all__ = [
    "Backoff",
    "Client",
    "Component",
    "Context",
    "DeadlineExceeded",
    "DiscoveryClient",
    "DiscoveryServer",
    "DistributedRuntime",
    "DistributedTraceContext",
    "Endpoint",
    "EndpointStats",
    "EngineError",
    "Instance",
    "INSTANCE_ROOT",
    "Lease",
    "MODEL_ROOT",
    "Namespace",
    "PushRouter",
    "RequestPlaneClient",
    "RequestPlaneServer",
    "RouterMode",
    "RuntimeConfig",
    "ServedEndpoint",
    "StreamLost",
    "Watch",
    "WatchEvent",
    "current_trace",
    "discovery_address",
    "faults",
    "init_logging",
    "parse_traceparent",
    "set_trace",
]
