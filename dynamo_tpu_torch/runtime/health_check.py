"""Canary health checks for served endpoints.

Port of `dynamo_tpu/runtime/health_check.py`, the role of the reference's
HealthCheckManager
(lib/runtime/src/health_check.rs:39-162, DYN_HEALTH_CHECK_* config
config.rs:155-167): an endpoint that has been idle longer than
`idle_timeout` gets a canary request sent through the real request plane
(loopback to this process's own server — the full codec/dispatch path).
Success keeps the endpoint healthy; a timeout or stream error marks it
unhealthy in SystemHealth, which flips the status server's /health to 503
so orchestrators can restart the worker.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .system_status import SystemHealth

logger = logging.getLogger(__name__)


@dataclass
class _Target:
    subject: str
    address: str
    path: str  # namespace/component/endpoint for SystemHealth
    canary: Any  # request payload the handler treats as a no-op probe
    stats: Any  # EndpointStats (idle tracking)
    consecutive_failures: int = 0


class HealthCheckManager:
    def __init__(
        self,
        drt,
        health: SystemHealth,
        idle_timeout: float = 60.0,
        request_timeout: float = 10.0,
        check_interval: Optional[float] = None,
    ):
        self.drt = drt
        self.health = health
        self.idle_timeout = idle_timeout
        self.request_timeout = request_timeout
        self.check_interval = check_interval or max(idle_timeout / 4, 0.5)
        self._targets: Dict[str, _Target] = {}
        self._task: Optional[asyncio.Task] = None
        # canaries sent and failed (the worker exports both)
        self.probes = 0
        self.probe_failures = 0

    def register(self, served_endpoint, canary_payload: Any) -> None:
        """Track a ServedEndpoint; `canary_payload` must be a request the
        handler completes quickly (reference: engines expose a designated
        health-check request)."""
        ep = served_endpoint
        t = _Target(
            subject=ep.instance.subject,
            address=ep.instance.address,
            path=f"{ep.instance.namespace}/{ep.instance.component}/{ep.instance.endpoint}",
            canary=canary_payload,
            stats=ep.stats,
        )
        self._targets[t.subject] = t
        self.health.set_endpoint_health(t.path, True)

    def unregister(self, subject: str) -> None:
        t = self._targets.pop(subject, None)
        if t is not None:
            self.health.remove_endpoint(t.path)

    def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        # take-then-act: claim the task BEFORE awaiting, so a concurrent
        # stop() (or a start() racing a stop) never reaps the same task
        # twice or nulls out a fresh one
        task, self._task = self._task, None
        if task is not None:
            task.cancel()
            try:
                await task
            except asyncio.CancelledError:
                pass

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.check_interval)
            now = time.monotonic()
            due = [
                t for t in self._targets.values()
                if now - t.stats.last_request_at >= self.idle_timeout
            ]
            if due:
                # concurrent probes: one wedged endpoint must not delay the
                # others' canaries past a single request_timeout
                await asyncio.gather(*(self._probe(t) for t in due))

    async def _probe(self, t: _Target) -> None:
        self.probes += 1
        try:
            # the connect/call AND the drain share one timeout: a wedged
            # transport that never returns a stream must count as a failed
            # probe, not hang the canary loop forever
            async def call_and_drain():
                stream = await self.drt.client.call(t.address, t.subject, t.canary)
                async for _ in stream:
                    pass

            await asyncio.wait_for(call_and_drain(), timeout=self.request_timeout)
            if t.consecutive_failures:
                logger.info("endpoint %s recovered", t.path)
            t.consecutive_failures = 0
            self.health.set_endpoint_health(t.path, True)
        except Exception as e:  # noqa: BLE001 — any failure counts
            t.consecutive_failures += 1
            self.probe_failures += 1
            logger.warning(
                "health canary failed for %s (%d consecutive): %s",
                t.path, t.consecutive_failures, e,
            )
            self.health.set_endpoint_health(t.path, False)
