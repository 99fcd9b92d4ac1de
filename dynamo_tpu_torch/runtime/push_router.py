"""Client-side request routing across endpoint instances.

Port of `dynamo_tpu/runtime/push_router.py`, unchanged. Mirrors reference PushRouter with RouterMode {RoundRobin, Random, Direct, KV}
(lib/runtime/src/pipeline/network/egress/push_router.rs:71). The KV mode is
implemented by KvPushRouter in llm/kv_router (it picks an instance by cache
overlap, then delegates here via `direct`).
"""

from __future__ import annotations

import enum
import random
from typing import Any, AsyncIterator, Callable, List, Optional

from .component import Client
from .engine import Context
from .request_plane import StreamLost


class RouterMode(str, enum.Enum):
    ROUND_ROBIN = "round-robin"
    RANDOM = "random"
    DIRECT = "direct"
    KV = "kv"


def request_excluded_instances(request: Any) -> List[int]:
    """Per-request dead-instance exclusions (`router.exclude_instances`,
    set by migration retries — docs/fault_tolerance.md): routers must not
    dial these even while the corpse's lease lingers in discovery."""
    router = (
        request.get("router") if isinstance(request, dict)
        else getattr(request, "router", None)
    )
    if not isinstance(router, dict):
        return []
    try:
        return [int(i) for i in router.get("exclude_instances") or []]
    except (TypeError, ValueError):
        return []


class PushRouter:
    """Route requests over the live instances of an endpoint client
    (reference push_router.rs:71)."""

    def __init__(
        self,
        client: Client,
        mode: RouterMode = RouterMode.ROUND_ROBIN,
        direct_instance: Optional[int] = None,
        prefer: Optional[Callable[[List[int]], List[int]]] = None,
    ):
        self.client = client
        self.mode = mode
        self.direct_instance = direct_instance
        # load-aware instance preference (dynogate, docs/overload.md):
        # narrows the candidate set to instances below the gate's
        # queue-depth watermark, so a saturated-but-ready worker is not
        # dialed like an idle one. The hook may degrade the choice but
        # never empty it (it falls back to the full set); DIRECT mode is
        # pinned and bypasses it.
        self.prefer = prefer
        self._rr_index = 0

    def _pick(self, exclude: set) -> int:
        if self.mode == RouterMode.DIRECT:
            # pinned routing has no failover set: a dead pinned instance
            # must fail fast after ONE StreamLost, not be re-dialed once
            # per live instance
            if self.direct_instance is None:
                raise ValueError("direct mode requires an instance id")
            if self.direct_instance in exclude:
                raise StreamLost(
                    f"pinned instance {self.direct_instance:x} unavailable "
                    f"for {self.client.endpoint.subject}"
                )
            return self.direct_instance
        # NEW streams only target ready instances: a `draining` discovery
        # record means the worker is mid-scale-down and will reject the
        # stream anyway — skipping it here saves a dial + rejection per
        # request during the drain window
        ids = [i for i in self.client.ready_instance_ids() if i not in exclude]
        if not ids:
            raise StreamLost(f"no instances for {self.client.endpoint.subject}")
        if self.prefer is not None and len(ids) > 1:
            preferred = [i for i in self.prefer(ids) if i not in exclude]
            if preferred:
                ids = preferred
        if self.mode == RouterMode.RANDOM:
            return random.choice(ids)
        # round-robin default
        inst = ids[self._rr_index % len(ids)]
        self._rr_index += 1
        return inst

    async def generate(
        self, request: Any, context: Optional[Context] = None
    ) -> AsyncIterator[Any]:
        """Pick an instance and issue the request. On connect failure, retry
        the remaining instances once each before giving up. Failed instances
        are only skipped within this call — discovery (lease expiry) is the
        authority on permanent removal. A migration retry additionally
        names its dead worker(s) in `router.exclude_instances`: the corpse
        is never dialed even while its lease lingers."""
        tried: set = set(request_excluded_instances(request))
        last_err: Optional[Exception] = None
        for _ in range(max(1, len(self.client.instance_ids()))):
            try:
                instance_id = self._pick(exclude=tried)
            except StreamLost:
                break
            try:
                return await self.client.direct(request, instance_id, context)
            except StreamLost as e:
                last_err = e
                tried.add(instance_id)
                continue
        raise last_err or StreamLost("no instances available")
