"""Model discovery: watch MDC records, keep per-model pipelines current.

Port of `dynamo_tpu/llm/discovery.py`, unchanged.

Mirrors reference lib/llm/src/discovery/: `ModelWatcher::watch` (watcher.rs
:101) follows `v1/mdc/` in discovery, building a serving pipeline when the
first worker for a model appears and tearing it down when the last leaves;
`ModelManager` (model_manager.rs:35) holds the live pipelines the HTTP
service dispatches to.
"""

from __future__ import annotations

import asyncio
import json
import logging
from typing import Callable, Dict, Optional

from ..runtime.component import MODEL_ROOT, Client, DistributedRuntime
from ..runtime.push_router import RouterMode
from .model_card import ModelDeploymentCard
from .service import ModelPipeline, build_routed_pipeline

logger = logging.getLogger(__name__)


class ModelManager:
    """Live models by name (reference ModelManager model_manager.rs:35)."""

    def __init__(self):
        self._pipelines: Dict[str, ModelPipeline] = {}
        self._clients: Dict[str, Client] = {}
        self._kv_routers: Dict[str, object] = {}

    def get(self, model: str) -> Optional[ModelPipeline]:
        return self._pipelines.get(model)

    def names(self):
        return sorted(self._pipelines.keys())

    def add(self, model: str, pipeline: ModelPipeline, client: Client):
        self._pipelines[model] = pipeline
        self._clients[model] = client

    async def remove(self, model: str):
        self._pipelines.pop(model, None)
        client = self._clients.pop(model, None)
        router = self._kv_routers.pop(model, None)
        if router is not None and hasattr(router, "close"):
            await router.close()
        if client is not None:
            await client.close()

    def kv_router_for(self, model: str):
        return self._kv_routers.get(model)

    def client_for(self, model: str) -> Optional[Client]:
        return self._clients.get(model)


class ModelWatcher:
    """Watch v1/mdc/ and maintain the ModelManager
    (reference ModelWatcher watcher.rs:101)."""

    def __init__(
        self,
        drt: DistributedRuntime,
        manager: ModelManager,
        router_mode: RouterMode = RouterMode.ROUND_ROBIN,
        kv_router_factory: Optional[Callable] = None,
        encoder: Optional[str] = None,
        gate=None,
    ):
        self.drt = drt
        self.manager = manager
        self.router_mode = router_mode
        self.kv_router_factory = kv_router_factory
        # "namespace/component/endpoint" of a multimodal encode worker:
        # adds the E hop (llm/multimodal.py) to every model pipeline
        self.encoder = encoder
        # dynogate (gate/, docs/overload.md): each discovered model's
        # backend component is registered so the gate follows its load
        # signals; its watermark preference feeds the PushRouter
        self.gate = gate
        self._task: Optional[asyncio.Task] = None
        self._card_keys: Dict[str, str] = {}  # key -> model name

    async def start(self):
        assert self.drt.discovery is not None, "model watching needs discovery"
        watch = await self.drt.discovery.watch_prefix(MODEL_ROOT)
        for item in watch.snapshot:
            await self._on_put(item["key"], item["value"])
        self._task = asyncio.create_task(self._loop(watch))

    async def _loop(self, watch):
        async for event in watch:
            try:
                if event.type == "put":
                    await self._on_put(event.key, event.value)
                else:
                    await self._on_delete(event.key)
            except Exception:  # noqa: BLE001 — watcher must survive bad cards
                logger.exception("model watcher failed handling %s", event.key)

    async def _on_put(self, key: str, raw: bytes):
        payload = json.loads(raw)
        card = ModelDeploymentCard.from_json(raw)
        ep_info = payload.get("endpoint") or {}
        if self.manager.get(card.name) is not None:  # one serial task: _loop awaits each _on_put
            self._card_keys[key] = card.name
            return  # another worker instance of an already-live model
        ns = ep_info.get("namespace", "dynamo")
        comp = ep_info.get("component", "backend")
        endpoint = (
            self.drt.namespace(ns)
            .component(comp)
            .endpoint(ep_info.get("endpoint", "generate"))
        )
        client = await endpoint.client()
        instance_prefer = None
        if self.gate is not None and self.gate.config.enabled:
            try:
                await self.gate.track_model(card.name, ns, comp, client)
                instance_prefer = self.gate.signals.prefer_below_watermark(
                    ns, comp)
            except Exception:  # noqa: BLE001 — the gate must FAIL OPEN
                # a metrics-subscribe hiccup leaves the gate signal-blind
                # for this model (it then admits everything); it must not
                # abort model registration or crash the watcher snapshot
                logger.warning(
                    "admission gate could not follow %s load signals; "
                    "gate stays fail-open for it", card.name, exc_info=True,
                )
        kv_router = None
        if self.router_mode == RouterMode.KV and self.kv_router_factory is not None:
            kv_router = await self.kv_router_factory(self.drt, card, client)
            self.manager._kv_routers[card.name] = kv_router
        encode_client = None
        if self.encoder:
            seg = self.encoder.split("/")
            if len(seg) == 1:
                ns, comp, ep = "dynamo", seg[0], "encode"
            elif len(seg) == 2:
                ns, comp, ep = seg[0], seg[1], "encode"
            else:
                ns, comp, ep = seg[0], seg[1], seg[2]
            encode_client = await (
                self.drt.namespace(ns).component(comp).endpoint(ep).client()
            )
        pipeline = build_routed_pipeline(
            card, client, self.router_mode, kv_router=kv_router,
            encode_client=encode_client, instance_prefer=instance_prefer,
        )
        self.manager.add(card.name, pipeline, client)
        self._card_keys[key] = card.name
        logger.info("model added: %s (router=%s)", card.name, self.router_mode.value)

    async def _on_delete(self, key: str):
        model = self._card_keys.pop(key, None)
        if model is None:
            return
        # remove only when no other card keys reference the model
        if model not in self._card_keys.values():
            await self.manager.remove(model)
            if self.gate is not None:
                await self.gate.untrack_model(model)
            logger.info("model removed: %s", model)

    async def stop(self):
        if self._task:
            self._task.cancel()
