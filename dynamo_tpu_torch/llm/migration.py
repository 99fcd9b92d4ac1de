"""Request migration: resume in-flight requests on surviving workers.

The port's own copy of `dynamo_tpu/llm/migration.py` (the reference's
migration.rs: Migration, RetryManager). When a worker dies mid-stream
(StreamLost), the request is issued again — its prompt extended by the
tokens already produced — to another worker, up to `migration_limit` times;
the caller sees one uninterrupted stream.

The retry request names the dead worker(s) in `router.exclude_instances`
(routers never dial the corpse again, even while its lease lingers), drops a
`kv_holder` hint or a per-request pin that names a dead instance and the
per-attempt disagg transfer descriptors, and carries a `migration` ordinal,
so the survivor classifies and counts the resume (checkpoint / peer / local /
recompute). With incremental commit and session checkpointing on, the
survivor onboards the session's prefix and recomputes only the tail.

`engine` is anything whose `generate(request, context)` returns a response
stream, or an awaitable of one (the runtime's `PushRouter`); the request
goes to it in its wire form, a dict.
"""

from __future__ import annotations

import inspect
import logging
from typing import AsyncIterator

from ..runtime.backoff import Backoff
from ..runtime.engine import Context
from ..runtime.request_plane import DeadlineExceeded, StreamLost
from .protocols import Annotated, LLMEngineOutput, PreprocessedRequest

logger = logging.getLogger(__name__)


class MigrationMetrics:
    """Process-wide migration counters, rendered in the Prometheus text
    format. Plain ints mutated on the event loop only."""

    def __init__(self):
        self.migrations = 0  # retries actually issued
        self.replayed_tokens = 0  # emitted tokens re-sent in retry prompts
        self.exhausted = 0  # streams that died past the budget

    def render_prometheus(self) -> bytes:
        lines = [
            "# HELP dynamo_frontend_migrations_total Stream migrations "
            "(retries after a worker death)",
            "# TYPE dynamo_frontend_migrations_total counter",
            f"dynamo_frontend_migrations_total {self.migrations}",
            "# HELP dynamo_frontend_migration_replayed_tokens_total "
            "Already-delivered tokens re-sent in migration retry prompts",
            "# TYPE dynamo_frontend_migration_replayed_tokens_total counter",
            f"dynamo_frontend_migration_replayed_tokens_total {self.replayed_tokens}",
            "# HELP dynamo_frontend_migrations_exhausted_total Streams "
            "lost after the migration budget ran out",
            "# TYPE dynamo_frontend_migrations_exhausted_total counter",
            f"dynamo_frontend_migrations_exhausted_total {self.exhausted}",
        ]
        return ("\n".join(lines) + "\n").encode()


MIGRATION_METRICS = MigrationMetrics()


class Migration:
    """Retry-on-stream-death around an engine (reference Migration,
    migration.rs:26). `around` is the pipeline-node form: it owns the
    downstream call."""

    def __init__(self, inner=None, migration_limit: int = 3):
        self.inner = inner
        self.migration_limit = migration_limit

    async def generate(self, request: PreprocessedRequest,
                       context: Context) -> AsyncIterator[Annotated]:
        async for item in RetryManager(self.inner, request, self.migration_limit).run(context):
            yield item

    def around(self, next_engine, request: PreprocessedRequest, context: Context):
        return RetryManager(next_engine, request, self.migration_limit).run(context)


class RetryManager:
    """Tracks emitted tokens; on StreamLost builds the retry request with
    them appended to the prompt (reference RetryManager migration.rs:82)."""

    def __init__(self, engine, request: PreprocessedRequest, limit: int):
        self.engine = engine
        self.request = request
        self.retries_left = limit
        self.attempts = 0
        self.emitted_tokens: list = []
        # workers that lost a stream of THIS request
        self.dead_instances: set = set()
        # jitter seeded per request: a fleet of retries spreads out, and a
        # re-run reproduces exactly
        self.backoff = Backoff.seeded(request.request_id or "", base=0.02, max_delay=0.5)

    def _retry_request(self) -> PreprocessedRequest:
        req = PreprocessedRequest.from_dict(self.request.to_dict())
        req.token_ids = list(self.request.token_ids) + self.emitted_tokens
        stop = dict(req.stop_conditions)
        if stop.get("max_tokens") is not None:
            stop["max_tokens"] = max(1, stop["max_tokens"] - len(self.emitted_tokens))
        if stop.get("min_tokens") is not None:
            # the survivor's generated count restarts at 0: without the
            # shrink it would hold eos back longer than the first stream
            stop["min_tokens"] = max(int(stop["min_tokens"]) - len(self.emitted_tokens), 0)
        req.stop_conditions = stop
        # the survivor classifies and counts the resume
        req.migration = self.attempts
        router = dict(req.router or {})
        # the union with the caller's own exclusions: the first attempt
        # honoured them, the retry must too
        caller_excluded = {int(i) for i in (router.get("exclude_instances") or ())}
        router["exclude_instances"] = sorted(caller_excluded | self.dead_instances)
        # a pin naming the corpse would re-dial it until the budget runs out
        pin = router.get("backend_instance_id")
        if pin is not None and int(pin) in self.dead_instances:
            router.pop("backend_instance_id", None)
        req.router = router
        # a holder hint naming a dead instance would pin the onboard to it
        holder = req.kv_holder or {}
        if int(holder.get("instance", -1)) in self.dead_instances:
            req.kv_holder = None
        # per-attempt transfer descriptors died with the stream; only the
        # capability flags survive
        if req.disagg_params:
            keep = {k: v for k, v in req.disagg_params.items()
                    if k in ("return_kv", "kv_pull", "kv_stream")}
            req.disagg_params = keep or None
        return req

    async def run(self, context: Context) -> AsyncIterator[Annotated]:
        request = self.request
        while True:
            try:
                stream = self.engine.generate(request.to_dict(), context)
                if inspect.isawaitable(stream):
                    stream = await stream
                async for item in stream:
                    ann = item if isinstance(item, Annotated) else Annotated.from_dict(item)
                    if ann.data is not None:
                        data = (ann.data.to_dict() if isinstance(ann.data, LLMEngineOutput)
                                else ann.data)
                        self.emitted_tokens.extend(data.get("token_ids", []))
                    yield ann
                return
            except DeadlineExceeded as e:
                yield Annotated.from_error(f"deadline exceeded: {e}")
                return
            except StreamLost as e:
                dead = getattr(context, "routed_instance", None)
                if dead is not None:
                    self.dead_instances.add(int(dead))
                if context.is_stopped() or context.is_killed():
                    return
                if self.retries_left <= 0:
                    logger.error("stream lost and migration budget exhausted: %s", e)
                    MIGRATION_METRICS.exhausted += 1
                    yield Annotated.from_error(f"stream lost, migration exhausted: {e}")
                    return
                if context.deadline_exceeded():
                    logger.error("stream lost past request deadline: %s", e)
                    yield Annotated.from_error(
                        f"stream lost and request deadline exceeded: {e}")
                    return
                self.retries_left -= 1
                self.attempts += 1
                request = self._retry_request()
                logger.warning(
                    "migrating request %s (%d tokens emitted, %d retries left, excluding %s)",
                    self.request.request_id, len(self.emitted_tokens), self.retries_left,
                    [f"{i:x}" for i in sorted(self.dead_instances)])
                if not await self.backoff.wait(context.deadline):
                    yield Annotated.from_error(
                        "stream lost and request deadline exceeded during backoff")
                    return
                # counted once the retry is really issued
                MIGRATION_METRICS.migrations += 1
                MIGRATION_METRICS.replayed_tokens += len(self.emitted_tokens)
