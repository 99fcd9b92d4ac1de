"""dynogate configuration: the `DYN_GATE_*` knob surface.

Port of `dynamo_tpu/gate/config.py`, unchanged.

The knobs are the reference's, documented in docs/configuration.md.
`DYN_GATE=0` compiles the whole subsystem out of the frontend: no
admission checks, no metrics subscription, no router preference — streams
are byte-identical to a build without this package (docs/overload.md).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

from ..runtime.config import env_bool, env_float, env_int


def parse_tenant_weights(spec: Optional[str]) -> Dict[str, float]:
    """`a=4,b=1` → {"a": 4.0, "b": 1.0}; malformed entries are skipped
    (a typo must not take admission down), non-positive weights clamp to
    the 1.0 default."""
    out: Dict[str, float] = {}
    for item in (spec or "").split(","):
        item = item.strip()
        if not item or "=" not in item:
            continue
        name, _, raw = item.partition("=")
        try:
            w = float(raw)
        except ValueError:
            continue
        if name.strip():
            out[name.strip()] = w if w > 0 else 1.0
    return out


@dataclasses.dataclass(frozen=True)
class GateConfig:
    """Resolved dynogate knobs (one instance per frontend process)."""

    enabled: bool = True
    #: base TTFT target (ms) for admission-class math; 0 = inherit
    #: DYN_SLA_TTFT_MS so the gate and the worker scheduler agree on what
    #: "on time" means. Class target = base x 0.5^priority (SlaConfig).
    ttft_ms: float = 0.0
    #: multiplier on the class TTFT target: admission rejects when the
    #: fleet's projected TTFT exceeds headroom x class target
    ttft_headroom: float = 1.5
    #: per-instance queue-depth watermark: the router prefers instances
    #: below it, and admission falls back to it when no worker publishes
    #: a TTFT estimate (fifo-policy fleets)
    queue_watermark: int = 16
    #: gate queue bound; past it the LOWEST class sheds first
    max_queue: int = 64
    #: cap (ms) on how long a request may wait in the gate queue before
    #: it is shed (the effective wait bound is min(this, class headroom))
    max_wait_ms: float = 1000.0
    #: HTTP header carrying the tenant key ("" disables tenant plumbing)
    tenant_header: str = "x-dynamo-tenant"
    #: per-tenant token-bucket rate (requests/s); 0 = unlimited
    tenant_rate: float = 0.0
    #: per-tenant bucket burst size; 0 = max(2 x rate, 1)
    tenant_burst: float = 0.0
    #: WFQ weights per tenant ("gold=4,free=1"); unlisted tenants weigh 1
    tenant_weights: Dict[str, float] = dataclasses.field(default_factory=dict)
    #: load signals older than this (s) are ignored — a cold/stale fleet
    #: view must admit, never reject on ghosts
    signal_ttl_s: float = 5.0
    #: minimum Retry-After (s) on any 429
    retry_after_floor_s: float = 1.0

    @classmethod
    def from_env(cls) -> "GateConfig":
        ttft = env_float("DYN_GATE_TTFT_MS", 0.0)
        if ttft <= 0:
            # inherit the scheduler's target: the gate's "will it be on
            # time" and the worker's "is it on time" must be one number
            ttft = env_float("DYN_SLA_TTFT_MS", 2000.0)
        return cls(
            enabled=env_bool("DYN_GATE", True),
            ttft_ms=max(ttft, 1.0),
            ttft_headroom=max(env_float("DYN_GATE_TTFT_HEADROOM", 1.5), 0.1),
            queue_watermark=max(env_int("DYN_GATE_QUEUE_WATERMARK", 16), 1),
            max_queue=max(env_int("DYN_GATE_MAX_QUEUE", 64), 0),
            max_wait_ms=max(env_float("DYN_GATE_MAX_WAIT_MS", 1000.0), 0.0),
            tenant_header=os.environ.get(
                "DYN_GATE_TENANT_HEADER", "x-dynamo-tenant"
            ),
            tenant_rate=max(env_float("DYN_GATE_TENANT_RATE", 0.0), 0.0),
            tenant_burst=max(env_float("DYN_GATE_TENANT_BURST", 0.0), 0.0),
            tenant_weights=parse_tenant_weights(
                os.environ.get("DYN_GATE_TENANT_WEIGHTS")
            ),
            signal_ttl_s=max(env_float("DYN_GATE_SIGNAL_TTL_S", 5.0), 0.1),
            retry_after_floor_s=max(
                env_float("DYN_GATE_RETRY_AFTER_FLOOR_S", 1.0), 0.0
            ),
        )

    def class_target_ms(self, priority: int) -> float:
        """The SLA class's TTFT target: each +1 of priority halves it,
        each -1 doubles it (the SlaConfig.deadline math, so an edge
        rejection and a worker deadline miss describe the same SLA)."""
        p = max(min(int(priority), 8), -8)
        return self.ttft_ms * (0.5 ** p)

    def class_headroom_ms(self, priority: int) -> float:
        """Admission ceiling: reject when the fleet's projected TTFT
        exceeds this — serving the request would blow its class SLA."""
        return self.class_target_ms(priority) * self.ttft_headroom

    def weight(self, tenant: str) -> float:
        return self.tenant_weights.get(tenant, 1.0)
