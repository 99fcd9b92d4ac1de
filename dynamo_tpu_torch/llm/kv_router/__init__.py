"""KV-cache-aware routing (reference lib/llm/src/kv_router/).

Port of `dynamo_tpu/llm/kv_router/__init__.py`, unchanged.

`KvPushRouter` = the RouterMode::KV network hop: score workers by cached
prefix overlap (KvIndexer), pick via the scheduler cost + softmax
(KvScheduler), then send direct to the chosen instance
(reference KvRouter kv_router.rs:202, find_best_match :318).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, AsyncIterator, Dict, Optional

from ...runtime import codec
from ...runtime.component import Client, DistributedRuntime
from ...runtime.engine import Context
from ...runtime.request_plane import StreamLost
from ..model_card import ModelDeploymentCard
from ..tokens import compute_seq_hashes, salt_hash
from .indexer import (
    ApproxKvIndexer,
    KvIndexer,
    KvIndexerSharded,
    OverlapScores,
    RadixTree,
)
from .publisher import KvEventPublisher, WorkerMetricsPublisher, METRICS_TOPIC_FMT
from .scheduler import KvRouterConfig, KvScheduler, WorkerLoad, softmax_sample

logger = logging.getLogger(__name__)

__all__ = [
    "ApproxKvIndexer",
    "KvIndexerSharded",
    "KvEventPublisher",
    "KvIndexer",
    "KvPushRouter",
    "KvRouterConfig",
    "KvScheduler",
    "OverlapScores",
    "RadixTree",
    "WorkerLoad",
    "WorkerMetricsPublisher",
    "make_kv_router_factory",
    "softmax_sample",
]


class KvPushRouter:
    """The KV routing hop (reference KvPushRouter in bindings / KvRouter
    kv_router.rs:202)."""

    def __init__(
        self,
        drt: DistributedRuntime,
        client: Client,
        config: Optional[KvRouterConfig] = None,
        block_size: int = 64,
    ):
        self.drt = drt
        self.client = client
        self.config = config or KvRouterConfig(block_size=block_size)
        # the model card's kv block size is authoritative: hashes must match
        # what the worker's engine emits (SURVEY.md hard part (c))
        self.block_size = block_size
        self.config.block_size = block_size
        ns = client.endpoint.component.namespace
        comp = client.endpoint.component.name
        if self.config.use_kv_events:
            self.indexer = KvIndexer(drt, ns, comp, self.block_size)
        else:
            self.indexer = ApproxKvIndexer(self.block_size)
        # event mode: a short-TTL overlay of ROUTED prefixes, merged into
        # the event-based scores. Engine KV events take seconds to land;
        # without the overlay, same-prefix requests arriving inside that
        # window score overlap 0 everywhere and spread across workers —
        # exactly the requests the KV router exists to co-locate.
        self._inflight_overlay = (
            ApproxKvIndexer(self.block_size, ttl=self.config.inflight_prefix_ttl_s)
            if self.config.use_kv_events and self.config.inflight_prefix_ttl_s > 0
            else None
        )
        self.scheduler = KvScheduler(self.config)
        self._metrics_sub = None
        self._metrics_task: Optional[asyncio.Task] = None
        self._known_workers: set[int] = set()
        # replica sync (reference kv_router/subscriber.rs): multiple KV-mode
        # frontends mirror each other's routing decisions so their
        # active-block accounting (and approx indexers) don't drift
        import secrets as _secrets

        self._sync_id = _secrets.token_hex(4)
        self._sync_sub = None
        self._sync_task: Optional[asyncio.Task] = None
        self._bg: set = set()
        # fast corpse cleanup (docs/fault_tolerance.md): a worker whose
        # stream just died is SUSPECT until this deadline — its radix/
        # overlay/scheduler state is forgotten immediately (stale prefix
        # scores must not pin retries to the corpse, and the holder hint
        # must never name it) and new streams skip it while its lease
        # lingers. A live worker re-earns entries through its own events.
        self._suspect: Dict[int, float] = {}

    @property
    def _sync_topic(self) -> str:
        ns = self.client.endpoint.component.namespace
        comp = self.client.endpoint.component.name
        return f"kv_router_sync/{ns}/{comp}"

    async def start(self):
        if isinstance(self.indexer, KvIndexer):
            await self.indexer.start()
        ns = self.client.endpoint.component.namespace
        comp = self.client.endpoint.component.name
        if self.drt.discovery is not None:
            self._metrics_sub = await self.drt.discovery.subscribe(
                METRICS_TOPIC_FMT.format(namespace=ns, component=comp)
            )
            self._metrics_task = asyncio.create_task(self._metrics_loop())
            if self.config.replica_sync:
                self._sync_sub = await self.drt.discovery.subscribe(self._sync_topic)
                self._sync_task = asyncio.create_task(self._sync_loop())

    def _publish_sync(self, msg: dict):
        if self._sync_sub is None or self.drt.discovery is None:
            return
        msg["router"] = self._sync_id

        async def _pub():
            try:
                await self.drt.discovery.publish(self._sync_topic, codec.pack(msg))
            except Exception:  # noqa: BLE001 — sync is best-effort
                logger.debug("replica sync publish failed", exc_info=True)

        t = asyncio.create_task(_pub())
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)

    async def _sync_loop(self):
        async for payload in self._sync_sub:
            try:
                msg = codec.unpack(payload)
                if msg.get("router") == self._sync_id:
                    continue  # our own event
                if msg["op"] == "route":
                    # mirrored=True: no local stream ends this entry, so the
                    # scheduler TTL-prunes it if the peer's 'free' never
                    # arrives (peer crash / dropped best-effort publish)
                    self.scheduler.add_request(
                        msg["request_id"], msg["worker"], msg["blocks"],
                        mirrored=True,
                    )
                    hashes = msg.get("prefix_hashes") or []
                    if not hashes and msg.get("token_ids"):
                        # older peers shipped raw token ids
                        hashes = compute_seq_hashes(
                            msg["token_ids"], self.block_size
                        )
                    if hashes:
                        if isinstance(self.indexer, ApproxKvIndexer):
                            self.indexer.apply_routed_hashes(hashes, msg["worker"])
                        if self._inflight_overlay is not None:
                            self._inflight_overlay.apply_routed_hashes(
                                hashes, msg["worker"]
                            )
                elif msg["op"] == "free":
                    self.scheduler.mark_free(msg["request_id"])
            except Exception:  # noqa: BLE001
                logger.exception("bad replica sync message")

    async def _metrics_loop(self):
        async for payload in self._metrics_sub:
            try:
                msg = codec.unpack(payload)
                self.scheduler.update_load(msg["worker_id"], msg.get("stats", {}))
            except Exception:  # noqa: BLE001
                logger.exception("bad metrics message")

    def _prune_dead_workers(self, live: list[int]):
        live_set = set(live)
        dead = self._known_workers - live_set
        for w in dead:
            self.indexer.remove_worker(w)
            if self._inflight_overlay is not None:
                self._inflight_overlay.remove_worker(w)
            self.scheduler.remove_worker(w)
            self._suspect.pop(w, None)  # lease authority took over
        self._known_workers = live_set

    def note_stream_lost(self, worker: int, ttl_s: float = 15.0):
        """A stream on `worker` died mid-flight: treat the worker as a
        corpse ahead of lease expiry — forget its radix/overlay/scheduler
        state NOW (stale overlap scores and holder hints must not pin
        retries to it) and keep it out of new-stream candidate sets for
        `ttl_s`. If the worker is actually alive (transient blip), it
        re-earns index entries from its own KV events and load reports —
        degraded routing for a moment, never a wrong dial."""
        self._suspect[int(worker)] = time.monotonic() + ttl_s
        self.indexer.remove_worker(int(worker))
        if self._inflight_overlay is not None:
            self._inflight_overlay.remove_worker(int(worker))
        self.scheduler.remove_worker(int(worker))

    def _live_suspects(self) -> set:
        now = time.monotonic()
        for w, dl in list(self._suspect.items()):
            if now >= dl:
                del self._suspect[w]
        return set(self._suspect)

    def find_best_match(
        self,
        token_ids: list[int],
        router_override: Optional[dict] = None,
        seq_hashes: Optional[list[int]] = None,
        return_scores: bool = False,
        exclude: Optional[set] = None,
    ) -> tuple:
        """Returns (worker_id, overlap_blocks) — reference find_best_match
        kv_router.rs:318. `seq_hashes`: precomputed block hashes (generate()
        hashes the prompt ONCE and reuses them here, for the overlay record
        and for the sync publish). `return_scores=True` appends the full
        per-worker overlap map (the cluster-KV-fabric holder hint reads
        the best-overlap worker from it). `exclude`: instances a migration
        retry named dead — never scheduled, never the holder hint."""
        live = self.client.instance_ids()
        # NEW streams schedule only onto ready instances: a `draining`
        # worker (scale-down in progress) would reject the stream anyway —
        # same invariant as PushRouter._pick. It stays in `live` though:
        # its index/overlay state is pruned by the lease-revoke delete,
        # not by the drain mark.
        ready = self.client.ready_instance_ids()
        hard = set(exclude or ())  # named dead by a migration retry
        avoid = hard | self._live_suspects()
        if avoid:
            # corpse-free candidate set; when ONLY suspects remain, fall
            # back to them (a suspect may be a transient blip — serving
            # beats refusing), but hard exclusions never come back: the
            # retry KNOWS that worker lost its stream
            filtered = [i for i in ready if i not in avoid]
            ready = filtered or [i for i in ready if i not in hard]
        if not ready:
            raise StreamLost(f"no instances for {self.client.endpoint.subject}")
        self._prune_dead_workers(live)
        pruned = self.scheduler.prune_mirrored()
        if pruned:
            logger.info("pruned %d stale mirrored sync entries", pruned)
        if seq_hashes is None:
            seq_hashes = compute_seq_hashes(token_ids, self.block_size)
        scores = self.indexer.find_matches_for_hashes(seq_hashes)
        if self._inflight_overlay is not None:
            inflight = self._inflight_overlay.find_matches_for_hashes(seq_hashes)
            for w, ov in inflight.scores.items():
                scores.scores[w] = max(scores.scores.get(w, 0), ov)
        request_blocks = len(token_ids) // self.block_size
        cfg = self.config
        if router_override:
            cfg = KvRouterConfig(
                overlap_score_weight=router_override.get(
                    "overlap_score_weight", cfg.overlap_score_weight
                ),
                router_temperature=router_override.get(
                    "router_temperature", cfg.router_temperature
                ),
                block_size=cfg.block_size,
            )
        saved = self.scheduler.config
        self.scheduler.config = cfg
        try:
            worker = self.scheduler.schedule(request_blocks, scores.scores, ready)
        finally:
            self.scheduler.config = saved
        if return_scores:
            return worker, scores.scores.get(worker, 0), dict(scores.scores)
        return worker, scores.scores.get(worker, 0)

    async def generate(
        self, request: Dict[str, Any], context: Optional[Context] = None
    ) -> AsyncIterator[Any]:
        token_ids = request.get("token_ids", [])
        request_id = request.get("request_id") or ""
        # LoRA adapters salt the hash chain exactly like the engine's
        # prefix cache (tokens.py; reference protocols.rs lora_id): the
        # router only co-locates same-adapter prefixes
        salt = (
            salt_hash(request["lora_name"].encode())
            if request.get("lora_name") else 0
        )
        seq_hashes = compute_seq_hashes(token_ids, self.block_size, salt)
        pinned = request.get("router", {}).get("backend_instance_id")
        from ...runtime.push_router import request_excluded_instances

        excluded = set(request_excluded_instances(request))
        holder = None
        if pinned is not None and int(pinned) in excluded:
            # a pin naming an excluded (dead) instance must not bypass
            # the corpse-exclusion contract — route as if unpinned
            pinned = None
        if pinned is not None:
            worker, overlap = int(pinned), 0
        else:
            worker, overlap, overlap_scores = self.find_best_match(
                token_ids, request.get("router") or None,
                seq_hashes=seq_hashes, return_scores=True,
                exclude=excluded,
            )
            # cluster KV fabric (docs/kvbm.md): the index already knows
            # which OTHER worker holds the longest cached prefix — ship
            # (holder, matched_blocks) with the request so the chosen
            # worker can pull those blocks from the holder's tiers instead
            # of recomputing them. Only a strictly-better holder is worth
            # a hint; the worker's own announcement mesh covers the rest.
            # A dead/suspect worker must never be the hint: a stale holder
            # would pin the resumed stream's onboard to the corpse.
            avoid_holder = excluded | self._live_suspects()
            best_holder = max(
                (w for w in overlap_scores
                 if w != worker and w not in avoid_holder),
                key=lambda w: overlap_scores[w], default=None,
            )
            if best_holder is not None and overlap_scores[best_holder] > overlap:
                holder = {
                    "instance": int(best_holder),
                    "blocks": int(overlap_scores[best_holder]),
                }
        request = dict(request)
        request["estimated_prefix_hit_num_blocks"] = overlap
        if holder is not None:
            request["kv_holder"] = holder
        blocks = max(len(token_ids) // self.block_size, 1)
        self.scheduler.add_request(request_id, worker, blocks)
        if isinstance(self.indexer, ApproxKvIndexer):
            self.indexer.apply_routed_hashes(seq_hashes, worker)
        if self._inflight_overlay is not None:
            self._inflight_overlay.apply_routed_hashes(seq_hashes, worker)
        self._publish_sync(
            {
                "op": "route", "request_id": request_id, "worker": worker,
                "blocks": blocks,
                # peers mirror prefix state (approx indexer / in-flight
                # overlay) from the block HASHES — block_size x smaller
                # than the token list and pre-hashed for the receiver
                "prefix_hashes": list(seq_hashes)
                if isinstance(self.indexer, ApproxKvIndexer)
                or self._inflight_overlay is not None else [],
            }
        )
        try:
            inner = await self.client.direct(request, worker, context)
        except StreamLost:
            self.scheduler.mark_free(request_id)
            # replicas mirrored the route: they must see the free too, or
            # they leak the active request forever (no TTL pruning)
            self._publish_sync({"op": "free", "request_id": request_id})
            self.note_stream_lost(worker)
            raise
        return self._wrap(inner, request_id, worker)

    async def _wrap(self, stream: AsyncIterator[Any], request_id: str,
                    worker: int):
        try:
            async for item in stream:
                yield item
        except StreamLost:
            # mid-stream death: forget the corpse NOW (fast corpse
            # cleanup) so the migration retry's re-route and holder hint
            # never land back on it while its lease lingers
            self.note_stream_lost(worker)
            raise
        finally:
            self.scheduler.mark_free(request_id)
            self._publish_sync({"op": "free", "request_id": request_id})

    async def close(self):
        # in-flight best-effort sync publishes die with the router
        for t in list(self._bg):
            t.cancel()
        if self._metrics_task:
            self._metrics_task.cancel()
        if self._metrics_sub:
            await self._metrics_sub.cancel()
        if self._sync_task:
            self._sync_task.cancel()
        if self._sync_sub:
            await self._sync_sub.cancel()
        if isinstance(self.indexer, KvIndexer):
            await self.indexer.close()


def make_kv_router_factory(config: KvRouterConfig):
    """Factory used by the ModelWatcher when --router-mode kv."""

    async def factory(drt: DistributedRuntime, card: ModelDeploymentCard, client: Client):
        import dataclasses

        per_model = dataclasses.replace(config, block_size=card.kv_cache_block_size)
        router = KvPushRouter(
            drt, client, per_model, block_size=card.kv_cache_block_size
        )
        await router.start()
        return router

    return factory
