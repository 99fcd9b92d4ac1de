"""Worker load signals: the gate's view of fleet pressure.

Port of `dynamo_tpu/gate/signals.py`, unchanged.

Every worker already publishes its engine stats on the discovery metrics
topic (`kv_metrics/{ns}/{comp}`, llm/kv_router/publisher.py
WorkerMetricsPublisher, 0.25s cadence): `sched_est_ttft_ms` (the
scheduler's queue-depth x cost-model prefill estimate — the same signal
the disagg router reads), `num_waiting_reqs`/`num_running_reqs`, and the
drain state rides discovery records. This module subscribes once per
(namespace, component), keeps a per-instance table, and answers the two
questions admission asks:

  * `projected_ttft_ms(model)` — the BEST ready instance's estimated
    TTFT (the router will pick a good instance, so the fleet is only
    overloaded when even the best one is). None when no fresh signal
    exists: a cold or stale view must admit, never reject on ghosts.
  * `queue_depth(instance)` — feeds the PushRouter watermark preference
    (below-watermark instances are dialed first) and the admission
    fallback for fleets whose workers publish no TTFT estimate.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..llm.kv_router.publisher import METRICS_TOPIC_FMT
from ..runtime import codec
from ..runtime.metrics import (
    NUM_RUNNING_REQS,
    NUM_WAITING_REQS,
    SCHED_EST_REQ_MS,
    SCHED_EST_TTFT_MS,
)
from .config import GateConfig

logger = logging.getLogger(__name__)


@dataclass
class InstanceLoad:
    """Last published load sample for one worker instance."""

    est_ttft_ms: Optional[float] = None  # None = worker publishes no estimate
    est_req_ms: Optional[float] = None  # marginal cost per admitted request
    queue_depth: int = 0  # waiting + running requests
    updated: float = 0.0  # monotonic receive time


class LoadSignals:
    """Per-component instance load tables fed by the metrics topic."""

    def __init__(self, drt, config: GateConfig):
        self.drt = drt
        self.config = config
        # (namespace, component) -> instance_id -> InstanceLoad; the table
        # for one component is mutated ONLY by its _watch task
        self._by_comp: Dict[Tuple[str, str], Dict[int, InstanceLoad]] = {}
        self._models: Dict[str, Tuple[str, str]] = {}  # model -> comp key
        self._clients: Dict[str, object] = {}  # model -> endpoint Client
        self._subs: Dict[Tuple[str, str], object] = {}
        self._tasks: Dict[Tuple[str, str], asyncio.Task] = {}
        self.samples_total = 0

    async def track(self, model: str, namespace: str, component: str,
                    client) -> None:
        """Follow `model`'s backend component; one subscription per
        (namespace, component) no matter how many models share it."""
        key = (namespace, component)
        self._models[model] = key
        self._clients[model] = client
        if key in self._tasks or self.drt.discovery is None:
            return
        # reserve the key SYNCHRONOUSLY: a concurrent track() for the
        # same component must not double-subscribe while we await
        self._tasks[key] = None
        try:
            sub = await self.drt.discovery.subscribe(
                METRICS_TOPIC_FMT.format(
                    namespace=namespace, component=component)
            )
        except BaseException:
            # a failed subscribe must not leave the reservation behind —
            # the retry (next model-card put) would see the key and skip,
            # leaving the gate permanently signal-blind for the component
            if self._tasks.get(key) is None:
                self._tasks.pop(key, None)
            raise
        if key not in self._tasks:  # untracked while subscribing
            await sub.cancel()
            return
        self._subs[key] = sub
        self._tasks[key] = asyncio.create_task(self._watch(key, sub))

    async def untrack(self, model: str) -> None:
        key = self._models.pop(model, None)
        self._clients.pop(model, None)
        if key is None or key in self._models.values():
            return  # another model still shares the component
        task = self._tasks.pop(key, None)
        if task is not None:
            task.cancel()
        sub = self._subs.pop(key, None)
        if sub is not None:
            await sub.cancel()
        self._by_comp.pop(key, None)

    async def close(self) -> None:
        # cancel sweep is synchronous (no yield of control until every
        # task is cancelled and the containers are clear)
        for task in list(self._tasks.values()):
            if task is not None:
                task.cancel()
        self._tasks.clear()
        subs = list(self._subs.values())
        self._subs.clear()
        for sub in subs:
            await sub.cancel()
        self._by_comp.clear()

    async def _watch(self, key: Tuple[str, str], sub) -> None:
        table = self._by_comp.setdefault(key, {})
        try:
            async for payload in sub:
                try:
                    msg = codec.unpack(payload)
                    stats = msg.get("stats", {})
                    inst = table.setdefault(int(msg["worker_id"]), InstanceLoad())
                    est = stats.get(SCHED_EST_TTFT_MS)
                    inst.est_ttft_ms = float(est) if est is not None else None
                    req = stats.get(SCHED_EST_REQ_MS)
                    inst.est_req_ms = float(req) if req is not None else None
                    inst.queue_depth = int(stats.get(NUM_WAITING_REQS, 0)) \
                        + int(stats.get(NUM_RUNNING_REQS, 0))
                    inst.updated = time.monotonic()
                    self.samples_total += 1
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — load stats are advisory
                    logger.debug("bad gate metrics message", exc_info=True)
        except asyncio.CancelledError:
            raise

    # -- queries ---------------------------------------------------------- #

    def _fresh(self, model: str, now: Optional[float] = None
               ) -> List[Tuple[int, InstanceLoad]]:
        """Fresh samples for `model`'s READY instances (stale samples and
        draining/dead instances are invisible to admission)."""
        key = self._models.get(model)
        if key is None:
            return []
        table = self._by_comp.get(key) or {}
        client = self._clients.get(model)
        ready = None
        if client is not None:
            try:
                ready = set(client.ready_instance_ids())
            except Exception:  # noqa: BLE001 — discovery hiccup = no filter
                ready = None
        now = time.monotonic() if now is None else now
        out = []
        for iid, load in table.items():
            if ready is not None and iid not in ready:
                continue
            if now - load.updated > self.config.signal_ttl_s:
                continue
            out.append((iid, load))
        return out

    def projected_ttft_ms(self, model: str) -> Optional[float]:
        """Best ready instance's projected TTFT (ms). Instances that
        publish no estimate project from the queue-depth watermark
        instead: depth/watermark x class base target, so a fifo fleet
        still saturates the gate rather than bypassing it. None = no
        fresh signal (cold fleet: admit)."""
        best: Optional[float] = None
        for _iid, load in self._fresh(model):
            if load.est_ttft_ms is not None:
                est = load.est_ttft_ms
            else:
                est = (load.queue_depth / max(self.config.queue_watermark, 1)
                       ) * self.config.ttft_ms
            if best is None or est < best:
                best = est
        return best

    def per_request_ms(self, model: str) -> float:
        """Marginal TTFT cost of one more admitted request — the
        optimism-debt unit the gate charges for admissions between signal
        refreshes. Workers that publish `sched_est_req_ms` (their own
        service-rate view) are believed; otherwise fall back to the best
        instance's (estimate / depth), which underestimates an idle
        fleet's per-request service time but corrects within one publish
        interval."""
        samples = self._fresh(model)
        if not samples:
            return 0.0
        best = min(
            samples,
            key=lambda s: s[1].est_ttft_ms
            if s[1].est_ttft_ms is not None else float("inf"),
        )[1]
        if best.est_req_ms is not None:
            return best.est_req_ms
        if best.est_ttft_ms is None or best.est_ttft_ms <= 0:
            return 0.0
        return best.est_ttft_ms / max(best.queue_depth, 1)

    def last_update(self, model: str) -> float:
        """Newest sample time for the model's component (0.0 = never)."""
        key = self._models.get(model)
        table = self._by_comp.get(key) if key is not None else None
        if not table:
            return 0.0
        return max(load.updated for load in table.values())

    def queue_depth(self, namespace: str, component: str,
                    instance_id: int) -> Optional[int]:
        load = (self._by_comp.get((namespace, component)) or {}).get(instance_id)
        if load is None:
            return None
        if time.monotonic() - load.updated > self.config.signal_ttl_s:
            return None
        return load.queue_depth

    def prefer_below_watermark(self, namespace: str, component: str):
        """Instance-preference hook for PushRouter._pick: keep only
        instances below the gate's queue-depth watermark (unknown/fresh-
        less instances count as below — a new worker must not starve).
        Falls back to the full set when every instance is saturated, so
        the preference can degrade the choice but never empty it."""

        def prefer(ids: List[int]) -> List[int]:
            below = []
            for iid in ids:
                depth = self.queue_depth(namespace, component, iid)
                if depth is None or depth < self.config.queue_watermark:
                    below.append(iid)
            return below or ids

        return prefer

    def stats(self) -> dict:
        out = {"gate_signal_samples": self.samples_total}
        for (_ns, comp), table in self._by_comp.items():
            out[f"gate_instances_{comp}"] = len(table)
        return out
