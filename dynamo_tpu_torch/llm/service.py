"""Serving-pipeline assembly.

Port of `dynamo_tpu/llm/service.py`: the chain is built with the port's
`Migration`; the `--encoder` hop's `EncodeOperator` (which imports torch)
is imported only when an encoder is named.

Mirrors reference lib/llm/src/entrypoint/input/common.rs:259-310
(build_routed_pipeline): the canonical chain

    OpenAIPreprocessor.fwd → Backend.fwd → Migration.fwd →
      ServiceBackend(PushRouter | KvPushRouter)   [network hop]
    → Migration.bwd → Backend.bwd → Preprocessor.bwd → frontend

Built on the generic operator-graph framework (runtime/pipeline.py:
Operator forward/backward/around + compose — the reference's pipeline.rs
node model): Backend contributes a backward stream transform, Migration
owns the downstream call (retry), ServiceBackend is the sink.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator, Optional

from ..runtime.component import Client
from ..runtime.engine import Context
from ..runtime.push_router import PushRouter, RouterMode
from .backend import Backend
from .migration import Migration
from .model_card import ModelDeploymentCard
from .preprocessor import OpenAIPreprocessor
from .protocols import Annotated, PreprocessedRequest
from .tokenizers import load_tokenizer

logger = logging.getLogger(__name__)


class ServiceBackend:
    """The network hop: adapt a PushRouter (or KvPushRouter) into an
    AsyncEngine over PreprocessedRequest dicts
    (reference ServiceBackend in pipeline nodes)."""

    def __init__(self, router):
        self.router = router

    async def generate(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[Any]:
        payload = request.to_dict() if isinstance(request, PreprocessedRequest) else request
        stream = await self.router.generate(payload, context)
        async for item in stream:
            yield item


class ModelPipeline:
    """A ready-to-serve model: preprocessor + backend + migration + router.
    Entry points: chat / completion streaming generators consumed by the
    HTTP service."""

    def __init__(
        self,
        card: ModelDeploymentCard,
        tokenizer,
        engine,
        raw_engine=None,
    ):
        self.card = card
        self.tokenizer = tokenizer
        self.preprocessor = OpenAIPreprocessor(card, tokenizer)
        self.engine = engine  # Backend(Migration(ServiceBackend(router)))
        # the chain below the detokenizer: embeddings and other non-token
        # responses must not pass through incremental detokenization
        self.raw_engine = raw_engine or engine

    def generate_preprocessed(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[Annotated]:
        return self.engine.generate(request, context)


def build_routed_pipeline(
    card: ModelDeploymentCard,
    client: Client,
    router_mode: RouterMode = RouterMode.ROUND_ROBIN,
    kv_router=None,
    busy_threshold: Optional[float] = None,
    encode_client: Optional[Client] = None,
    instance_prefer=None,
) -> ModelPipeline:
    """Assemble the canonical chain for one model
    (reference common.rs:259-310) via the operator graph.
    `encode_client`: endpoint client of a multimodal encode worker — adds
    the E hop of E/P/D ahead of the chain (llm/multimodal.py).
    `instance_prefer`: dynogate load-preference hook for the PushRouter
    (below-watermark instances dialed first, docs/overload.md)."""
    from ..runtime.pipeline import compose

    tokenizer = load_tokenizer(card.tokenizer)
    if router_mode == RouterMode.KV and kv_router is not None:
        router = kv_router
    else:
        router = PushRouter(client, router_mode, prefer=instance_prefer)
    sink = ServiceBackend(router)
    migration = Migration(migration_limit=card.migration_limit)
    backend = Backend(tokenizer=tokenizer)
    ops = [backend, migration]
    if encode_client is not None:
        from .multimodal import EncodeOperator

        ops.insert(0, EncodeOperator(
            PushRouter(encode_client, RouterMode.ROUND_ROBIN),
            tokenizer.vocab_size,
        ))
    engine = compose(ops, sink)
    raw_engine = compose([migration], sink)  # below the detokenizer
    return ModelPipeline(card, tokenizer, engine, raw_engine=raw_engine)
