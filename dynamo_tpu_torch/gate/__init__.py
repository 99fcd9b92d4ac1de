"""dynogate — frontend overload discipline (docs/overload.md).

Port of `dynamo_tpu/gate/`: the same admission decisions, counters and exposition.

Admission control at the HTTP edge (429 + Retry-After BEFORE
tokenization, driven by worker-published load signals), per-tenant
weighted fairness + token-bucket rate limits, and priority-aware load
shedding that keeps goodput flat as offered load passes capacity."""

from .config import GateConfig, parse_tenant_weights
from .fairness import TokenBucket, WfqEntry, WfqQueue
from .gate import AdmissionGate, GateDecision, retry_after_header
from .signals import InstanceLoad, LoadSignals

__all__ = [
    "AdmissionGate",
    "GateConfig",
    "GateDecision",
    "InstanceLoad",
    "LoadSignals",
    "TokenBucket",
    "WfqEntry",
    "WfqQueue",
    "parse_tenant_weights",
    "retry_after_header",
]
