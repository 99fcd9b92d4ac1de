"""OpenAI-compatible HTTP service.

Port of `dynamo_tpu/llm/http/service.py` on asyncio streams
(`llm/http/server.py`) in place of `aiohttp.web`: the same routes, status
codes, JSON bodies, SSE framing and metrics. The handlers are the
reference's; a client that leaves a stream cancels its handler at once,
which kills the pipeline context before the next token.

Mirrors reference lib/llm/src/http/service/: route assembly
(service_v2.rs:319-339), chat/completions handlers (openai.rs), SSE
streaming with client-disconnect detection (disconnect.rs), Prometheus
metrics (metrics.rs), and the clear-kv-blocks admin route.

A dropped client cancels the pipeline context (kill), which propagates
over the request plane to the worker.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import AsyncIterator, Optional

from ...runtime.engine import Context
from ..discovery import ModelManager
from ..parsers import JailedStream
from ..preprocessor import ChatDeltaGenerator, CompletionDeltaGenerator
from ..protocols import (
    Annotated,
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatMessage,
    Choice,
    CompletionChoice,
    CompletionRequest,
    CompletionResponse,
    EmbeddingRequest,
    EmbeddingResponse,
    LLMEngineOutput,
    ModelInfo,
    ModelList,
    Usage,
)
from .metrics import HttpMetrics
from .server import HttpServer, Request, Response, StreamResponse, json_response

logger = logging.getLogger(__name__)


#: compact separators on every wire-bound json.dumps — SSE framing bytes
#: are pure per-token overhead (llm/preprocessor.py COMPACT is the same
#: contract for the chunk templates)
_COMPACT = (",", ":")


def _sse_event(event: str, data: dict) -> bytes:
    """Named SSE event frame (Responses API framing)."""
    return (
        f"event: {event}\ndata: "
        f"{json.dumps(data, separators=_COMPACT)}\n\n".encode()
    )


def _content_text(message: dict) -> str:
    """Flatten a Responses-API message's content (string or typed parts)."""
    content = message.get("content", "")
    if isinstance(content, str):
        return content
    return "".join(
        p.get("text", "") for p in content if isinstance(p, dict)
    )


# chat n>1 fan-out bound (OpenAI caps n at 128; engine slots are the real
# limit here — one HTTP request must not monopolize the worker batch)
MAX_N_CHOICES = 8


def _sse(data: str) -> bytes:
    return f"data: {data}\n\n".encode()


class HttpService:
    """The frontend HTTP server (reference HttpService service_v2.rs)."""

    def __init__(
        self,
        manager: ModelManager,
        host: str = "0.0.0.0",
        port: int = 8000,
        enable_responses: bool = True,
        gate=None,
    ):
        self.manager = manager
        self.host, self.port = host, port
        self.metrics = HttpMetrics()
        # dynogate admission control (gate/, docs/overload.md): consulted
        # BEFORE tokenization on every token-generating route. None (or a
        # DYN_GATE=0 gate) = the pre-gate request path, byte-identical.
        self.gate = gate
        self.app = HttpServer(client_max_size=64 * 1024 * 1024)
        self._setup_routes()

    def _setup_routes(self):
        # reference route assembly: service_v2.rs:319-339
        self.app.add_post("/v1/chat/completions", self.chat_completions)
        self.app.add_post("/v1/completions", self.completions)
        self.app.add_post("/v1/embeddings", self.embeddings)
        self.app.add_post("/v1/responses", self.responses)
        self.app.add_get("/v1/models", self.list_models)
        self.app.add_get("/health", self.health)
        self.app.add_get("/live", self.live)
        self.app.add_get("/metrics", self.prometheus)
        # admin: flush every worker's reusable KV blocks (reference
        # clear_kv_blocks route assembly, service_v2.rs:319-339)
        self.app.add_post("/clear-kv-blocks", self.clear_kv_blocks)

    async def start(self) -> int:
        self.port = await self.app.start(self.host, self.port)  # 0: ephemeral
        logger.info("HTTP service listening on %s:%d", self.host, self.port)
        return self.port

    async def stop(self):
        await self.app.stop()

    # ------------------------------------------------------------------ #
    # handlers
    # ------------------------------------------------------------------ #

    async def health(self, request: Request) -> Response:
        return json_response({"status": "healthy", "models": self.manager.names()})

    async def live(self, request: Request) -> Response:
        return json_response({"status": "live"})

    async def prometheus(self, request: Request) -> Response:
        from ..migration import MIGRATION_METRICS

        body = self.metrics.render()
        if self.gate is not None and self.gate.config.enabled:
            body += self.gate.render_prometheus()
        # migration observability (docs/fault_tolerance.md): what worker
        # deaths cost this frontend's streams
        body += MIGRATION_METRICS.render_prometheus()
        return Response(body, content_type="text/plain; charset=utf-8")

    # ------------------------------------------------------------------ #
    # dynogate admission (docs/overload.md)
    # ------------------------------------------------------------------ #

    def _gate_tenant(self, request: Request) -> str:
        header = self.gate.config.tenant_header
        return (request.headers.get(header, "") if header else "") or "default"

    @staticmethod
    def _gate_priority(body: dict) -> int:
        nvext = body.get("nvext")
        raw = nvext.get("priority") if isinstance(nvext, dict) else None
        try:
            return int(raw) if raw is not None else 0
        except (TypeError, ValueError):
            return 0  # the preprocessor 400s it later; the gate is lenient

    async def _gate_admit(
        self, request: Request, model: str, body: dict, endpoint: str, t0
    ):
        """Run the admission gate ahead of tokenization. Returns
        (None, tenant) when admitted, or (a finished 429 response, tenant)
        when the request is rejected/shed — the body carries the decision
        detail and the Retry-After header tells the client exactly when
        to come back (docs/overload.md)."""
        if self.gate is None or not self.gate.config.enabled:
            return None, None
        from ...gate import retry_after_header

        tenant = self._gate_tenant(request)
        priority = self._gate_priority(body)
        decision = await self.gate.admit(model, tenant, priority)
        if decision.admitted:
            return None, tenant
        self.metrics.request_start(model, endpoint)
        self.metrics.request_end(model, endpoint, t0, error=True)
        detail = {
            "message": (
                f"overloaded: admission {decision.reason} for tenant "
                f"{tenant!r} (retry after {decision.retry_after_s:.1f}s)"
            ),
            "type": "overloaded",
            "code": 429,
            "reason": decision.reason,
            "tenant": tenant,
            "priority": priority,
            "retry_after_s": round(decision.retry_after_s, 3),
        }
        if decision.projected_ttft_ms is not None:
            detail["projected_ttft_ms"] = round(decision.projected_ttft_ms, 1)
        resp = json_response(
            {"error": detail},
            status=429,
            headers={"Retry-After": retry_after_header(decision.retry_after_s)},
        )
        return resp, tenant

    async def clear_kv_blocks(self, request: Request) -> Response:
        """Tell every worker instance of every (or one given) model to drop
        its reusable KV blocks; returns per-instance cleared counts."""
        model_filter = request.query.get("model")
        results: dict = {}
        for name in self.manager.names():
            if model_filter and name != model_filter:
                continue
            client = self.manager.client_for(name)
            if client is None:
                continue
            per_model: dict = {}
            for inst in client.instance_ids():
                try:
                    ctx = Context()
                    stream = await client.direct(
                        {"annotations": ["clear_kv_blocks"], "token_ids": []},
                        inst,
                        ctx,
                    )
                    cleared = None
                    async for item in stream:
                        ev = item.get("event") if isinstance(item, dict) else None
                        if ev == "clear_kv_blocks":
                            cleared = int((item.get("comment") or ["0"])[0])
                    per_model[f"{inst:x}"] = cleared if cleared is not None else "no-op"
                except Exception as e:  # noqa: BLE001 — report per instance
                    per_model[f"{inst:x}"] = f"error: {e}"
            results[name] = per_model
        return json_response({"cleared": results})

    async def _embed_one(self, pipeline, token_ids: list[int]) -> list[float]:
        """One embed round-trip below the detokenizer; raises on engine
        errors (including migration-exhausted annotations)."""
        from ..protocols import PreprocessedRequest

        ctx = Context()
        pre = PreprocessedRequest(
            token_ids=token_ids,
            embed=True,
            stop_conditions={"max_tokens": 1},
        )
        try:
            async for out in pipeline.raw_engine.generate(pre, ctx):
                if hasattr(out, "is_error") and out.is_error():
                    raise RuntimeError((out.comment or ["engine error"])[0])
                d = out.data if hasattr(out, "data") else out
                if isinstance(d, dict) and "embedding" in d:
                    return d["embedding"]
        finally:
            ctx.stop_generating()
        raise RuntimeError(
            "engine returned no embedding (model not embedding-capable?)"
        )

    async def embeddings(self, request: Request) -> Response:
        """/v1/embeddings (reference openai.rs embeddings handler): tokenize
        each input, embed all inputs concurrently below the detokenizer, and
        assemble the OpenAI embedding list."""
        t0 = time.monotonic()
        try:
            body = await request.json()
            req = EmbeddingRequest.model_validate(body)
        except Exception as e:  # noqa: BLE001
            return self._error(400, f"invalid request: {e}")
        if req.encoding_format not in (None, "float"):
            return self._error(
                400, f"encoding_format {req.encoding_format!r} not supported"
            )
        if req.dimensions is not None:
            return self._error(400, "dimensions parameter not supported")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return self._error(404, f"model {req.model!r} not found", "model_not_found")
        self.metrics.request_start(req.model, "embeddings")
        error_msg = None
        prompt_tokens = 0
        data: list[dict] = []
        try:
            inputs = req.input if isinstance(req.input, list) else [req.input]
            if inputs and isinstance(inputs[0], int):  # single pre-tokenized prompt
                inputs = [inputs]
            token_lists = [
                pipeline.tokenizer.encode(item) if isinstance(item, str) else list(item)
                for item in inputs
            ]
            prompt_tokens = sum(len(t) for t in token_lists)
            results = await asyncio.gather(
                *(self._embed_one(pipeline, t) for t in token_lists),
                return_exceptions=True,
            )
            for i, emb in enumerate(results):
                if isinstance(emb, BaseException):
                    error_msg = str(emb)
                    break
                data.append({"object": "embedding", "index": i, "embedding": emb})
        except Exception as e:  # noqa: BLE001
            error_msg = str(e)
        finally:
            self.metrics.request_end(
                req.model, "embeddings", t0, error=bool(error_msg),
                input_tokens=prompt_tokens,
            )
        if error_msg:
            return self._error(500, error_msg, "engine_error")
        resp = EmbeddingResponse(
            data=data,
            model=req.model,
            usage=Usage(
                prompt_tokens=prompt_tokens, completion_tokens=0,
                total_tokens=prompt_tokens,
            ),
        )
        return json_response(resp.model_dump(exclude_none=True))

    async def responses(self, request: Request) -> StreamResponse:
        """/v1/responses (reference service_v2.rs:319-339 responses route,
        async-openai Responses types): `input` (string or message list) runs
        through the chat pipeline; unary returns a `response` object, stream
        emits response.created / response.output_text.delta /
        response.completed SSE events."""
        import secrets as _secrets

        t0 = time.monotonic()
        try:
            body = await request.json()
            model = body["model"]
            raw_input = body.get("input", "")
            stream_mode = bool(body.get("stream", False))
            max_tokens = body.get("max_output_tokens") or body.get("max_tokens")
        except Exception as e:  # noqa: BLE001
            return self._error(400, f"invalid request: {e}")
        pipeline = self.manager.get(model)
        if pipeline is None:
            return self._error(404, f"model {model!r} not found", "model_not_found")

        try:
            if isinstance(raw_input, str):
                messages = [{"role": "user", "content": raw_input}]
            elif isinstance(raw_input, list):
                messages = [
                    {"role": m.get("role", "user"), "content": _content_text(m)}
                    if isinstance(m, dict)
                    else {"role": "user", "content": str(m)}
                    for m in raw_input
                ]
            else:
                raise ValueError(f"input must be a string or list, got {type(raw_input).__name__}")
            if body.get("instructions"):
                messages.insert(0, {"role": "system", "content": body["instructions"]})
            chat_req = ChatCompletionRequest(
                model=model, messages=messages, max_tokens=max_tokens,
                temperature=body.get("temperature"), top_p=body.get("top_p"),
            )
        except Exception as e:  # noqa: BLE001 — malformed request, not a 500
            return self._error(400, f"invalid request: {e}")
        reject, tenant = await self._gate_admit(
            request, model, body, "responses", t0
        )
        if reject is not None:
            return reject
        self.metrics.request_start(model, "responses")
        ctx = Context()
        try:
            pre = await pipeline.preprocessor.preprocess_chat_async(chat_req)
        except ValueError as e:
            self.metrics.request_end(model, "responses", t0, error=True)
            return self._error(400, str(e))
        if tenant and tenant != "default":
            pre.tenant = tenant
        resp_id = f"resp_{_secrets.token_hex(12)}"
        engine_stream = pipeline.generate_preprocessed(pre, ctx)
        # same structured-output jail as the chat path (reasoning models must
        # not leak thinking tags into output_text)
        reasoning_parser = pipeline.card.runtime_config.get("reasoning_parser")
        if reasoning_parser:
            engine_stream = JailedStream(
                engine_stream, reasoning_parser=reasoning_parser
            ).__aiter__()

        texts: list[str] = []
        n_out = 0
        error_msg = None
        first_token_at = None
        last_token_at = None

        def response_obj(status: str) -> dict:
            return {
                "id": resp_id,
                "object": "response",
                "created_at": int(time.time()),
                "status": status,
                "model": model,
                "output": [
                    {
                        "type": "message",
                        "id": f"msg_{resp_id[5:]}",
                        "role": "assistant",
                        "status": status,
                        "content": [
                            {"type": "output_text", "text": "".join(texts),
                             "annotations": []}
                        ],
                    }
                ],
                "usage": {
                    "input_tokens": len(pre.token_ids),
                    "output_tokens": n_out,
                    "total_tokens": len(pre.token_ids) + n_out,
                },
            }

        sse_resp: Optional[StreamResponse] = None
        try:
            if stream_mode:
                sse_resp = StreamResponse(
                    status=200, headers={"Content-Type": "text/event-stream"}
                )
                await sse_resp.prepare(request)
                await sse_resp.write(
                    _sse_event("response.created",
                               {"type": "response.created",
                                "response": response_obj("in_progress")})
                )
            async for ann in engine_stream:
                if ann.is_error():
                    error_msg = (ann.comment or ["engine error"])[0]
                    break
                if ann.event is not None or ann.data is None:
                    continue
                out: LLMEngineOutput = ann.data
                if out.token_ids:
                    last_token_at = time.monotonic()
                    if first_token_at is None:
                        first_token_at = last_token_at
                        self.metrics.observe_ttft(model, first_token_at - t0)
                n_out += len(out.token_ids)
                if out.text:
                    texts.append(out.text)
                    if sse_resp is not None:
                        await sse_resp.write(
                            _sse_event(
                                "response.output_text.delta",
                                {"type": "response.output_text.delta",
                                 "item_id": f"msg_{resp_id[5:]}",
                                 "output_index": 0, "content_index": 0,
                                 "delta": out.text},
                            )
                        )
                if out.finish_reason:
                    break
        except (ConnectionResetError, asyncio.CancelledError):
            ctx.kill()
            self.metrics.client_disconnect(model)
            raise
        finally:
            ctx.stop_generating()
            self.metrics.request_end(
                model, "responses", t0, error=bool(error_msg),
                output_tokens=n_out, input_tokens=len(pre.token_ids),
                first_token_at=first_token_at, last_token_at=last_token_at,
            )
        if sse_resp is not None:
            ev = "response.failed" if error_msg else "response.completed"
            final = response_obj("failed" if error_msg else "completed")
            if error_msg:
                final["error"] = {"message": error_msg}
            await sse_resp.write(_sse_event(ev, {"type": ev, "response": final}))
            return sse_resp
        if error_msg:
            return self._error(500, error_msg, "engine_error")
        return json_response(response_obj("completed"))

    async def list_models(self, request: Request) -> Response:
        models = ModelList(data=[ModelInfo(id=name) for name in self.manager.names()])
        return json_response(models.model_dump())

    def _error(self, status: int, message: str, err_type: str = "invalid_request_error"):
        return json_response(
            {"error": {"message": message, "type": err_type, "code": status}},
            status=status,
        )

    async def chat_completions(self, request: Request) -> StreamResponse:
        t0 = time.monotonic()
        try:
            body = await request.json()
            req = ChatCompletionRequest.model_validate(body)
        except Exception as e:  # noqa: BLE001
            return self._error(400, f"invalid request: {e}")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return self._error(404, f"model {req.model!r} not found", "model_not_found")
        # admission control BEFORE tokenization: a rejected request must
        # not spend compute-pool time on the chat template (docs/overload.md)
        reject, tenant = await self._gate_admit(request, req.model, body, "chat", t0)
        if reject is not None:
            return reject
        self.metrics.request_start(req.model, "chat")
        ctx = Context()
        try:
            pre = await pipeline.preprocessor.preprocess_chat_async(req)
        except ValueError as e:
            self.metrics.request_end(req.model, "chat", t0, error=True)
            return self._error(400, str(e))
        if tenant and tenant != "default":
            pre.tenant = tenant  # rides to the worker's fairness tiebreak
        include_usage = bool(
            req.stream_options and req.stream_options.include_usage
        )
        rc = pipeline.card.runtime_config
        tool_parser = rc.get("tool_call_parser") if req.tools else None
        reasoning_parser = rc.get("reasoning_parser")

        def mk_stream(p, c=None):
            s = pipeline.generate_preprocessed(p, c or ctx)
            # structured-output jail: hold tool-call/reasoning tokens out
            # of the content stream, release them parsed (parsers/jail.py)
            if tool_parser or reasoning_parser:
                s = JailedStream(
                    s, tool_parser=tool_parser,
                    reasoning_parser=reasoning_parser,
                ).__aiter__()
            return s

        n = req.n or 1
        if n > MAX_N_CHOICES:
            self.metrics.request_end(req.model, "chat", t0, error=True)
            return self._error(
                400, f"n is capped at {MAX_N_CHOICES} (got {n})"
            )
        if n > 1:
            # parallel sampling: n engine requests over the SAME prompt —
            # the prefix cache + in-flight skip-ahead dedupe the prompt
            # compute, so choices cost ~decode only (vLLM n>1 role).
            # Each choice runs under its OWN child context: a stop-string
            # hit on one choice must not cancel its siblings (parent
            # kill/stop still propagates to all).
            import dataclasses as _dc

            pres = []
            for i in range(n):
                p = _dc.replace(
                    pre,
                    request_id=f"{pre.request_id}-{i}",
                    sampling_options=dict(pre.sampling_options),
                )
                seed = p.sampling_options.get("seed")
                if seed is not None:
                    p.sampling_options["seed"] = int(seed) + i
                pres.append(p)
            gens = [
                ChatDeltaGenerator(
                    req.model, pre.request_id,
                    include_usage=include_usage, index=i,
                )
                for i in range(n)
            ]
            for g in gens:
                g.prompt_tokens = len(pre.token_ids)
            streams = [mk_stream(p, ctx.child()) for p in pres]
            try:
                if req.stream:
                    return await self._stream_chat_multi(
                        request, req, streams, gens, ctx, t0
                    )
                return await self._unary_chat_multi(
                    req, streams, gens, ctx, t0
                )
            finally:
                ctx.stop_generating()

        gen = ChatDeltaGenerator(
            req.model, pre.request_id, include_usage=include_usage,
        )
        gen.prompt_tokens = len(pre.token_ids)
        stream = mk_stream(pre)
        try:
            if req.stream:
                return await self._stream_chat(request, req, stream, gen, ctx, t0)
            return await self._unary_chat(req, stream, gen, ctx, t0)
        finally:
            ctx.stop_generating()

    async def _stream_chat(
        self, http_req, req, stream: AsyncIterator[Annotated], gen, ctx: Context, t0
    ) -> StreamResponse:
        """Single-choice streaming == the multi path with one stream (kept
        as an alias so chunk-handling fixes live in ONE place)."""
        return await self._stream_chat_multi(
            http_req, req, [stream], [gen], ctx, t0
        )

    async def _stream_chat_multi(
        self, http_req, req, streams, gens, ctx: Context, t0
    ) -> StreamResponse:
        """n>1 streaming: merge the per-choice streams into one SSE flow;
        every chunk carries its choice index (OpenAI multi-choice chunks)."""
        resp = StreamResponse(
            status=200,
            headers={"Content-Type": "text/event-stream",
                     "Cache-Control": "no-cache"},
        )
        await resp.prepare(http_req)
        n = len(streams)
        queue: asyncio.Queue = asyncio.Queue()

        async def pump(i, s):
            try:
                async for ann in s:
                    await queue.put((i, ann))
            finally:
                # synchronous: an await here is a cancellation delivery
                # point and the end-of-choice marker must always land
                queue.put_nowait((i, None))

        tasks = [asyncio.create_task(pump(i, s)) for i, s in enumerate(streams)]
        first_token_at = None
        last_token_at = None
        error = False
        done = 0
        finished = [False] * n
        try:
            while done < n:
                i, ann = await queue.get()
                gen = gens[i]
                if ann is None:
                    done += 1
                    if not finished[i] and not error:
                        await resp.write(_sse(gen.finish_chunk_json("stop")))
                        finished[i] = True
                    continue
                if ann.is_error():
                    error = True
                    msg = (ann.comment or ["engine error"])[0]
                    await resp.write(_sse(json.dumps(
                        {"error": {"message": msg}}, separators=_COMPACT)))
                    break
                if ann.event is not None:
                    await resp.write(
                        f": {ann.event} "
                        f"{json.dumps(ann.comment, separators=_COMPACT)}"
                        "\n\n".encode()
                    )
                    continue
                out: LLMEngineOutput = ann.data
                if out.token_ids:
                    last_token_at = time.monotonic()
                    if first_token_at is None:
                        first_token_at = last_token_at
                        self.metrics.observe_ttft(
                            req.model, first_token_at - t0)
                    self.metrics.observe_tokens_per_frame(
                        req.model, len(out.token_ids))
                if out.reasoning_content:
                    await resp.write(_sse(gen.reasoning_chunk(
                        out.reasoning_content).model_dump_json(
                            exclude_none=True)))
                if out.tool_calls:
                    await resp.write(_sse(gen.tool_calls_chunk(
                        out.tool_calls).model_dump_json(exclude_none=True)))
                if out.text or out.logprob_entries:
                    # one SSE event per delta batch; the preserialized
                    # template path serializes only the delta fields
                    if out.logprob_entries:
                        payload = gen.text_chunk(
                            out.text or "", len(out.token_ids),
                            logprob_entries=out.logprob_entries,
                        ).model_dump_json(exclude_none=True)
                    else:
                        payload = gen.text_chunk_json(
                            out.text or "", len(out.token_ids))
                    await resp.write(_sse(payload))
                elif out.token_ids:
                    gen.completion_tokens += len(out.token_ids)
                if out.finish_reason and not finished[i]:
                    await resp.write(_sse(gen.finish_chunk_json(
                        out.finish_reason)))
                    finished[i] = True
            if not error and gens[0].include_usage:
                usage = gens[0].usage_chunk()
                usage.usage.completion_tokens = sum(
                    g.completion_tokens for g in gens)
                usage.usage.total_tokens = (
                    gens[0].prompt_tokens + usage.usage.completion_tokens)
                await resp.write(_sse(usage.model_dump_json(exclude_none=True)))
            await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            ctx.kill()
            self.metrics.client_disconnect(req.model)
            raise
        finally:
            for t in tasks:
                t.cancel()
            self.metrics.request_end(
                req.model, "chat", t0, error=error,
                output_tokens=sum(g.completion_tokens for g in gens),
                input_tokens=gens[0].prompt_tokens,
                first_token_at=first_token_at, last_token_at=last_token_at,
            )
        return resp

    async def _unary_chat_multi(
        self, req, streams, gens, ctx: Context, t0
    ) -> Response:
        """n>1 non-streamed: collect every choice, answer once."""
        from ..protocols.openai import chat_logprobs

        async def collect(s):
            texts, reasoning, tools, lp_entries = [], [], [], []
            finish, n_out, err = "stop", 0, None
            async for ann in s:
                if ann.is_error():
                    err = (ann.comment or ["engine error"])[0]
                    break
                if ann.event is not None:
                    continue
                out: LLMEngineOutput = ann.data
                n_out += len(out.token_ids)
                if out.reasoning_content:
                    reasoning.append(out.reasoning_content)
                if out.tool_calls:
                    tools.extend(out.tool_calls)
                if out.text:
                    texts.append(out.text)
                if out.logprob_entries:
                    lp_entries.extend(out.logprob_entries)
                if out.finish_reason:
                    finish = ("stop" if out.finish_reason == "eos"
                              else out.finish_reason)
                    break
            return texts, reasoning, tools, lp_entries, finish, n_out, err

        results = await asyncio.gather(*[collect(s) for s in streams])
        total_out = sum(r[5] for r in results)
        self.metrics.request_end(
            req.model, "chat", t0, error=any(r[6] for r in results),
            output_tokens=total_out, input_tokens=gens[0].prompt_tokens,
        )
        for r in results:
            if r[6]:
                return self._error(500, r[6], "engine_error")
        choices = []
        for i, (texts, reasoning, tools, lp_entries, finish, _n, _e) in \
                enumerate(results):
            message = ChatMessage(role="assistant", content="".join(texts))
            if reasoning:
                message.reasoning_content = "".join(reasoning)
            if tools:
                from ..protocols.openai import ToolCall

                message.tool_calls = [
                    ToolCall.model_validate(tc) for tc in tools]
                message.content = message.content or None
            choices.append(Choice(
                index=i, message=message, finish_reason=finish,
                logprobs=chat_logprobs(lp_entries),
            ))
        response = ChatCompletionResponse(
            id=gens[0].id,
            model=req.model,
            choices=choices,
            usage=Usage(
                prompt_tokens=gens[0].prompt_tokens,
                completion_tokens=total_out,
                total_tokens=gens[0].prompt_tokens + total_out,
            ),
        )
        return json_response(response.model_dump(exclude_none=True))

    async def _unary_chat(
        self, req, stream: AsyncIterator[Annotated], gen, ctx: Context, t0
    ) -> Response:
        texts: list[str] = []
        finish = "stop"
        n_out = 0
        error_msg = None
        first_token_at = None
        last_token_at = None
        reasoning_parts: list[str] = []
        tool_calls: list = []
        lp_entries: list = []
        async for ann in stream:
            if ann.is_error():
                error_msg = (ann.comment or ["engine error"])[0]
                break
            if ann.event is not None:
                continue
            out: LLMEngineOutput = ann.data
            if out.token_ids:
                last_token_at = time.monotonic()
                if first_token_at is None:
                    first_token_at = last_token_at
                    self.metrics.observe_ttft(req.model, first_token_at - t0)
            n_out += len(out.token_ids)
            if out.reasoning_content:
                reasoning_parts.append(out.reasoning_content)
            if out.tool_calls:
                tool_calls.extend(out.tool_calls)
            if out.text:
                texts.append(out.text)
            if out.logprob_entries:
                lp_entries.extend(out.logprob_entries)
            if out.finish_reason:
                finish = "stop" if out.finish_reason == "eos" else out.finish_reason
                break
        self.metrics.request_end(
            req.model, "chat", t0, error=bool(error_msg), output_tokens=n_out,
            input_tokens=gen.prompt_tokens, first_token_at=first_token_at,
            last_token_at=last_token_at,
        )
        if error_msg:
            return self._error(500, error_msg, "engine_error")
        message = ChatMessage(role="assistant", content="".join(texts))
        if reasoning_parts:
            message.reasoning_content = "".join(reasoning_parts)
        if tool_calls:
            from ..protocols.openai import ToolCall

            message.tool_calls = [ToolCall.model_validate(tc) for tc in tool_calls]
            message.content = message.content or None
        from ..protocols.openai import chat_logprobs

        chat_lp = chat_logprobs(lp_entries)
        response = ChatCompletionResponse(
            id=gen.id,
            model=req.model,
            choices=[
                Choice(
                    index=0,
                    message=message,
                    finish_reason=finish,
                    logprobs=chat_lp,
                )
            ],
            usage=Usage(
                prompt_tokens=gen.prompt_tokens,
                completion_tokens=n_out,
                total_tokens=gen.prompt_tokens + n_out,
            ),
        )
        return json_response(response.model_dump(exclude_none=True))

    async def completions(self, request: Request) -> StreamResponse:
        t0 = time.monotonic()
        try:
            body = await request.json()
            req = CompletionRequest.model_validate(body)
        except Exception as e:  # noqa: BLE001
            return self._error(400, f"invalid request: {e}")
        pipeline = self.manager.get(req.model)
        if pipeline is None:
            return self._error(404, f"model {req.model!r} not found", "model_not_found")
        reject, tenant = await self._gate_admit(
            request, req.model, body, "completions", t0
        )
        if reject is not None:
            return reject
        self.metrics.request_start(req.model, "completions")
        ctx = Context()
        try:
            pre = await pipeline.preprocessor.preprocess_completion_async(req)
        except ValueError as e:
            self.metrics.request_end(req.model, "completions", t0, error=True)
            return self._error(400, str(e))
        if tenant and tenant != "default":
            pre.tenant = tenant
        gen = CompletionDeltaGenerator(req.model, pre.request_id)
        gen.prompt_tokens = len(pre.token_ids)
        stream = pipeline.generate_preprocessed(pre, ctx)
        try:
            if req.stream:
                return await self._stream_completion(request, req, stream, gen, ctx, t0)
            return await self._unary_completion(req, stream, gen, ctx, t0)
        finally:
            ctx.stop_generating()

    async def _stream_completion(
        self, http_req, req, stream, gen, ctx: Context, t0
    ) -> StreamResponse:
        resp = StreamResponse(
            status=200, headers={"Content-Type": "text/event-stream"}
        )
        await resp.prepare(http_req)
        error = False
        first_token_at = None
        last_token_at = None
        try:
            finish_sent = False
            async for ann in stream:
                if ann.is_error():
                    error = True
                    msg = (ann.comment or ["engine error"])[0]
                    await resp.write(_sse(json.dumps(
                        {"error": {"message": msg}}, separators=_COMPACT)))
                    break
                if ann.event is not None:
                    await resp.write(
                        f": {ann.event} "
                        f"{json.dumps(ann.comment, separators=_COMPACT)}"
                        "\n\n".encode()
                    )
                    continue
                out: LLMEngineOutput = ann.data
                if out.token_ids:
                    last_token_at = time.monotonic()
                    if first_token_at is None:
                        first_token_at = last_token_at
                        self.metrics.observe_ttft(req.model, first_token_at - t0)
                    self.metrics.observe_tokens_per_frame(
                        req.model, len(out.token_ids))
                if out.text or out.logprob_entries:
                    if out.logprob_entries:
                        payload = gen.text_chunk(
                            out.text or "", len(out.token_ids),
                            logprob_entries=out.logprob_entries,
                        ).model_dump_json(exclude_none=True)
                    else:
                        payload = gen.text_chunk_json(
                            out.text or "", len(out.token_ids))
                    await resp.write(_sse(payload))
                elif out.token_ids:
                    # batch fully held back (mid multi-byte sequence /
                    # stop-string holdback): no chunk, but the tokens
                    # still count toward usage — same as the chat path
                    gen.completion_tokens += len(out.token_ids)
                if out.finish_reason:
                    await resp.write(_sse(gen.finish_chunk_json(out.finish_reason)))
                    finish_sent = True
                    break
            if not error and not finish_sent:
                await resp.write(_sse(gen.finish_chunk_json("stop")))
            if not error and req.stream_options \
                    and req.stream_options.include_usage:
                # completions parity with the chat route (and the KServe
                # stream's completion_tokens): a final usage chunk on ask
                await resp.write(
                    _sse(gen.usage_chunk().model_dump_json(exclude_none=True))
                )
            await resp.write(b"data: [DONE]\n\n")
        except (ConnectionResetError, asyncio.CancelledError):
            ctx.kill()
            self.metrics.client_disconnect(req.model)
            raise
        finally:
            self.metrics.request_end(
                req.model, "completions", t0, error=error,
                output_tokens=gen.completion_tokens,
                input_tokens=gen.prompt_tokens, first_token_at=first_token_at,
                last_token_at=last_token_at,
            )
        return resp

    async def _unary_completion(self, req, stream, gen, ctx: Context, t0) -> Response:
        texts: list[str] = []
        finish = "stop"
        n_out = 0
        error_msg = None
        first_token_at = None
        last_token_at = None
        lp_entries: list = []
        async for ann in stream:
            if ann.is_error():
                error_msg = (ann.comment or ["engine error"])[0]
                break
            if ann.event is not None:
                continue
            out: LLMEngineOutput = ann.data
            if out.token_ids:
                last_token_at = time.monotonic()
                if first_token_at is None:
                    first_token_at = last_token_at
                    self.metrics.observe_ttft(req.model, first_token_at - t0)
            n_out += len(out.token_ids)
            if out.text:
                texts.append(out.text)
            if out.logprob_entries:
                lp_entries.extend(out.logprob_entries)
            if out.finish_reason:
                finish = "stop" if out.finish_reason == "eos" else out.finish_reason
                break
        self.metrics.request_end(
            req.model, "completions", t0, error=bool(error_msg), output_tokens=n_out,
            input_tokens=gen.prompt_tokens, first_token_at=first_token_at,
            last_token_at=last_token_at,
        )
        if error_msg:
            return self._error(500, error_msg, "engine_error")
        from ..protocols.openai import completion_logprobs

        lp = completion_logprobs(lp_entries)
        response = CompletionResponse(
            id=gen.id,
            model=req.model,
            choices=[
                CompletionChoice(index=0, text="".join(texts),
                                 finish_reason=finish, logprobs=lp)
            ],
            usage=Usage(
                prompt_tokens=gen.prompt_tokens,
                completion_tokens=n_out,
                total_tokens=gen.prompt_tokens + n_out,
            ),
        )
        return json_response(response.model_dump(exclude_none=True))
