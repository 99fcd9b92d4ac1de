"""Decode-side disaggregation orchestration.

Port of `dynamo_tpu/jax_worker/disagg_handler.py:maybe_remote_prefill`. The
decode worker decides per request (conditional disaggregation), calls the
prefill pool with max_tokens=1 and `disagg_params`, receives the first token
and the prompt's KV — a data-plane descriptor, or the pages inline — on
that response stream, injects, and decodes on. With `DYN_DISAGG_STREAM`
on (the default) it also asks for the streamed handoff: a prefill worker
that can stage early sends its descriptor at admission, and the pull
(`TorchEngine.begin_streamed_pull`) overlaps the peer's prefill. Any failure
on the prefill path (no prefill worker, a dead one, a refused or failed
pull, a format mismatch) falls back to a local prefill on this worker, so
disaggregation is strictly an optimization.

A LoRA request (`lora_name`) is probed on its adapter-salted hash chain,
and its remote prefill carries `lora_name` to the prefill worker, which must
serve the adapter too. Blocks the engine's KVBM tiers hold — locally or
announced by a peer — count as cached: they onboard at admission, so recomputing them remotely
would waste the prefill pool. Under the `sla` policy the engine's
estimated local prefill wait (`estimated_prefill_wait_ms`) joins the static
token threshold: a short prompt still goes remote when the local queue
would spend the TTFT target.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator

from ..llm.disagg import DisaggregatedRouter, unpack_kv_payload
from ..llm.protocols import Annotated, LLMEngineOutput
from ..llm.tokens import compute_seq_hashes, salt_hash
from ..runtime.config import env_bool
from ..runtime.engine import Context
from ..runtime.push_router import PushRouter, RouterMode
from ..runtime.request_plane import EngineError, StreamLost

logger = logging.getLogger(__name__)


async def maybe_remote_prefill(
    engine,
    prefill_client,
    disagg_router: DisaggregatedRouter,
    request: dict,
    context: Context,
) -> AsyncIterator[Any]:
    prompt = request.get("token_ids") or []
    page_size = engine.config.page_size
    # the cached-prefix probe reads the same hash chain the engine's prefix
    # cache keys on: a LoRA request's is salted with its adapter's name
    salt = salt_hash(request["lora_name"].encode()) if request.get("lora_name") else 0
    hashes = compute_seq_hashes(prompt, page_size, salt)
    n_cached = len(engine.allocator.cached_prefix(hashes))
    if engine.kvbm is not None and n_cached < len(hashes):
        n_cached += len(engine.kvbm.probe(hashes[n_cached:]))
    cached_tokens = n_cached * page_size
    have_workers = bool(prefill_client and prefill_client.instance_ids())
    want_annotation = "remote_prefill" in (request.get("annotations") or [])

    # under the sla policy the engine's estimated local prefill wait joins
    # the static threshold (fifo keeps the threshold rule alone)
    est_ms = target_ms = None
    if engine.scheduler.policy == "sla":
        est_ms = engine.estimated_prefill_wait_ms(len(prompt) - cached_tokens)
        target_ms = engine.scheduler.sla.ttft_target_ms
    if not disagg_router.prefill_remote(
        len(prompt), cached_tokens, have_workers,
        local_ttft_est_ms=est_ms, ttft_target_ms=target_ms,
    ):
        if want_annotation:
            yield {"event": "remote_prefill", "comment": ["false"]}
        async for item in engine.generate(request, context):
            yield item
        return

    want_stream = env_bool("DYN_DISAGG_STREAM", True)
    prefill_req = dict(request)
    stop = dict(prefill_req.get("stop_conditions") or {})
    stop["max_tokens"] = 1
    prefill_req["stop_conditions"] = stop
    # kv_pull: we can pull from the prefill worker's data plane; a worker
    # without one answers inline anyway (a capability hint, not a demand).
    # kv_stream: we can also consume the early-staged streamed handoff
    prefill_req["disagg_params"] = {
        "return_kv": True, "kv_pull": True, "kv_stream": want_stream,
    }

    first_token = first_lp = first_top = kv_payload = None
    early = None  # StreamedPullHandle once the early descriptor arrives
    try:
        try:
            router = PushRouter(prefill_client, RouterMode.ROUND_ROBIN)
            stream = await router.generate(prefill_req, context.child())
            async for item in stream:
                data = item.get("data") if isinstance(item, dict) else None
                kvp = data.get("kv_transfer_params") if data else None
                if not kvp:
                    continue
                if not data.get("token_ids"):
                    # EARLY streamed descriptor (no token yet): start pulling
                    # the committed chunks while the prefill still computes
                    pull = kvp.get("pull") or {}
                    if want_stream and early is None and pull.get("streamed"):
                        try:
                            early = engine.begin_streamed_pull(request, context, pull)
                        except Exception:  # noqa: BLE001 — the early start is an
                            # optimization; the final descriptor covers it
                            logger.exception("early streamed pull not started")
                    continue
                kv_payload = kvp
                first_token = data["token_ids"][0]
                first_lp = (data.get("log_probs") or [None])[0]
                first_top = (data.get("top_logprobs") or [None])[0]
        except (StreamLost, EngineError) as e:
            logger.warning("remote prefill failed (%s); falling back to local", e)

        if kv_payload is None or first_token is None:
            if early is not None:
                early.abort()
                early = None
            if want_annotation:
                yield {"event": "remote_prefill", "comment": ["false"]}
            async for item in engine.generate(request, context):
                yield item
            return

        if want_annotation:
            yield {"event": "remote_prefill", "comment": ["true"]}
        # the prefill-produced first token goes to the caller (with its
        # logprob when asked: the lists must stay aligned)
        yield Annotated(data=LLMEngineOutput(
            token_ids=[first_token],
            log_probs=[first_lp] if first_lp is not None else None,
            top_logprobs=[first_top] if first_top else None,
        ).to_dict()).to_dict()
        pull = kv_payload.get("pull") or {}
        if early is not None and pull.get("transfer_id") == early.transfer_id:
            # streamed handoff: the early pull has been injecting chunks
            # since admission — hand it the token and decode on
            early.set_first_token(first_token)
            handle, early = early, None
            stream = handle.stream()
        else:
            if early is not None:
                # re-staged serially (the early stage died): abandon it
                early.abort()
                early = None
            if "pull" in kv_payload:
                stream = engine.generate_decode_from_pull(
                    request, context, first_token, kv_payload["pull"])
            elif str(kv_payload.get("fmt", "none")) != engine.config.kv_quant:
                # mixed-precision fleet, inline payload: refuse it typed,
                # count it, and prefill locally from the emitted first token
                engine.kv_format_mismatches += 1
                logger.warning(
                    "disagg kv payload fmt=%r != local kv_quant=%r; prefilling locally",
                    kv_payload.get("fmt"), engine.config.kv_quant)
                stream = engine.generate_decode_resume(request, context, first_token)
            else:
                kv_k, kv_v, n_tokens = unpack_kv_payload(kv_payload)
                stream = engine.generate_decode_from_kv(
                    request, context, first_token, kv_k, kv_v, n_tokens)
        async for item in stream:
            yield item
    finally:
        # handler cancelled (client gone) with an unresolved early pull: the
        # slot must not wait for a first token that never comes
        if early is not None:
            early.abort()
