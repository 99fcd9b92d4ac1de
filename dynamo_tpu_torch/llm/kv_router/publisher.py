"""Worker-side publishers: KV events + engine load metrics.

Port of `dynamo_tpu/llm/kv_router/publisher.py`: the same topics and
payloads, so a reference router's indexer and scheduler consume a port
worker's events and stats. Mirrors reference lib/llm/src/kv_router/publisher.rs: `KvEventPublisher`
(:92) forwards engine block stored/removed events to the event plane, and
`WorkerMetricsPublisher` (:684) periodically publishes ForwardPassMetrics
(the reference scrapes via NATS $SRV.STATS; here both ride the discovery
pub/sub topics)."""

from __future__ import annotations

import asyncio
import logging
from typing import Callable, List, Optional

from ...runtime import codec
from ...runtime.component import DistributedRuntime, Endpoint
from ..mocker.kv_manager import KvEvent

logger = logging.getLogger(__name__)

#: the reference indexer's topic (`dynamo_tpu/llm/kv_router/indexer.py:248`)
EVENT_TOPIC_FMT = "kv_events/{namespace}/{component}"
METRICS_TOPIC_FMT = "kv_metrics/{namespace}/{component}"


class KvEventPublisher:
    """Batch + publish KV events for one worker (reference publisher.rs:92)."""

    def __init__(
        self,
        drt: DistributedRuntime,
        endpoint: Endpoint,
        worker_id: int,
        flush_interval: float = 0.01,
    ):
        self.drt = drt
        self.worker_id = worker_id
        self.topic = EVENT_TOPIC_FMT.format(
            namespace=endpoint.component.namespace, component=endpoint.component.name
        )
        self.flush_interval = flush_interval
        self._buffer: List[dict] = []
        self._task: Optional[asyncio.Task] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None

    async def start(self):
        self._loop = asyncio.get_running_loop()
        self._task = asyncio.create_task(self._flush_loop())

    def publish(self, event: KvEvent):
        """Queue an event (engine step-loop side, same event loop)."""
        self._buffer.append(event.to_dict())

    def publish_threadsafe(self, event: KvEvent):
        """Queue an event from a thread other than the event loop's."""
        if self._loop is None:
            self._buffer.append(event.to_dict())
        else:
            self._loop.call_soon_threadsafe(self._buffer.append, event.to_dict())

    async def _flush_loop(self):
        while True:
            await asyncio.sleep(self.flush_interval)
            if not self._buffer or self.drt.discovery is None:
                continue
            batch, self._buffer = self._buffer, []
            try:
                await self.drt.discovery.publish(
                    self.topic,
                    codec.pack({"worker_id": self.worker_id, "events": batch}),
                )
            except ConnectionError:
                logger.warning("kv event publish failed; dropping %d events", len(batch))

    async def close(self):
        if self._task:
            self._task.cancel()


class WorkerMetricsPublisher:
    """Publish engine load stats for the router's scheduler
    (reference WorkerMetricsPublisher publisher.rs:684)."""

    def __init__(
        self,
        drt: DistributedRuntime,
        endpoint: Endpoint,
        worker_id: int,
        stats_fn: Callable[[], dict],
        interval: float = 0.25,
    ):
        self.drt = drt
        self.worker_id = worker_id
        self.subject = endpoint.subject
        self.topic = METRICS_TOPIC_FMT.format(
            namespace=endpoint.component.namespace, component=endpoint.component.name
        )
        self.stats_fn = stats_fn
        self.interval = interval
        self._task: Optional[asyncio.Task] = None

    async def start(self):
        self._task = asyncio.create_task(self._loop())

    def _stats(self) -> dict:
        stats = dict(self.stats_fn() or {})
        # request-plane coalescing counters ride along: items/frames is the
        # worker-side tokens-per-frame signal the serving-gap bench and
        # hardware e2e rows read off this topic
        ep = self.drt.server.stats(self.subject)
        if ep is not None:
            stats.setdefault("frames_total", ep.frames_total)
            stats.setdefault("items_total", ep.items_total)
            # zero-copy token path visibility (docs/frontend_scaleout.md):
            # frames that rode the ENC_TOK binary payload
            stats.setdefault("frames_binary", ep.frames_binary)
        return stats

    async def _loop(self):
        while True:
            try:
                if self.drt.discovery is not None:
                    await self.drt.discovery.publish(
                        self.topic,
                        codec.pack(
                            {"worker_id": self.worker_id, "stats": self._stats()}
                        ),
                    )
            except ConnectionError:
                pass
            except Exception:  # noqa: BLE001
                logger.exception("metrics publish failed")
            await asyncio.sleep(self.interval)

    async def close(self):
        if self._task:
            self._task.cancel()
