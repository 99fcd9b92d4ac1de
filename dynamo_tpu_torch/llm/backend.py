"""Backend operator: incremental detokenization + stop-condition handling.

Port of `dynamo_tpu/llm/backend.py`, unchanged, on the port's `DecodeStream`.

Mirrors reference lib/llm/src/backend.rs (Backend :55, Decoder :282): sits
between the preprocessor and the network/router, turning the engine's token
stream into text deltas and enforcing stop strings that the engine can't see
(engines enforce token-level stops; string stops need detok state).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator, List, Optional

from ..runtime.compute import ComputePool
from ..runtime.config import _env
from ..runtime.engine import Context
from ..runtime.pipeline import Operator
from .protocols import Annotated, LLMEngineOutput, PreprocessedRequest

logger = logging.getLogger(__name__)


def _mergeable_ids(ann: Annotated) -> Optional[List[int]]:
    """token_ids if `ann` is a PURE token delta (no event/text/logprobs/
    finish/usage riders) — the only shape safe to concatenate."""
    if ann.event is not None or ann.comment:
        return None
    d = ann.data
    if isinstance(d, LLMEngineOutput):
        d = d.to_dict()
    if not isinstance(d, dict) or set(d) - {"token_ids"}:
        return None
    return d.get("token_ids") or None


async def merge_token_deltas(
    stream: AsyncIterator[Any], max_items: int = 0
) -> AsyncIterator[Annotated]:
    """Merge already-ready pure-token items into one delta batch.

    A pump task drains the upstream while the consumer works; each
    iteration takes everything the pump has ready (never waiting, so a
    slow stream's latency is untouched) and concatenates consecutive
    token-only deltas. Engines that emit per-token (the mocker; a real
    engine between block boundaries) thus still reach the detokenizer and
    SSE assembler as batches — O(1) frontend work per event-loop tick."""
    if max_items <= 0:
        max_items = max(_env("DYN_STREAM_COALESCE_MAX_ITEMS", 64, int), 1)
    done = object()
    queue: asyncio.Queue = asyncio.Queue()

    async def pump():
        try:
            async for item in stream:
                queue.put_nowait(item)
            queue.put_nowait(done)
        except asyncio.CancelledError:
            raise
        except BaseException as e:  # noqa: BLE001 — re-raised consumer-side
            queue.put_nowait(e)

    pump_task = asyncio.create_task(pump())
    try:
        held: Optional[Annotated] = None
        while True:
            if held is not None:
                item, held = held, None
            else:
                item = await queue.get()
            if item is done:
                return
            if isinstance(item, BaseException):
                raise item
            ann = item if isinstance(item, Annotated) else Annotated.from_dict(item)
            ids = _mergeable_ids(ann)
            if ids is None:
                yield ann
                continue
            merged = list(ids)
            terminal = None
            while len(merged) < max_items:
                try:
                    nxt = queue.get_nowait()
                except asyncio.QueueEmpty:
                    break
                if nxt is done or isinstance(nxt, BaseException):
                    terminal = nxt
                    break
                nann = nxt if isinstance(nxt, Annotated) else Annotated.from_dict(nxt)
                nids = _mergeable_ids(nann)
                if nids is None:
                    held = nann
                    break
                merged.extend(nids)
            yield Annotated(data={"token_ids": merged}, id=ann.id)
            if terminal is not None:
                if terminal is done:
                    return
                raise terminal
    finally:
        pump_task.cancel()


class Decoder:
    """Per-request incremental decode state (reference Decoder backend.rs:282)."""

    def __init__(self, tokenizer, stop_strings: Optional[List[str]] = None):
        self._stream = tokenizer.decode_stream()
        self._stop_strings = stop_strings or []
        self._pending = ""  # text withheld because it may begin a stop string

    def _holdback_len(self, text: str) -> int:
        """Length of the longest suffix of `text` that is a proper prefix of
        any stop string (must be withheld until disambiguated)."""
        best = 0
        for s in self._stop_strings:
            for k in range(min(len(s) - 1, len(text)), 0, -1):
                if text.endswith(s[:k]):
                    best = max(best, k)
                    break
        return best

    def step(self, token_id: int) -> tuple[Optional[str], bool]:
        """Returns (text_delta, hit_stop_string). On a stop hit, the delta is
        trimmed up to the stop string start; partial stop-string matches are
        never leaked."""
        delta = self._stream.step(token_id)
        if delta is None:
            return None, False
        return self._scan(delta)

    def _scan(self, delta: str) -> tuple[Optional[str], bool]:
        """Stop-string scan + holdback over newly decoded text."""
        if not self._stop_strings:
            return delta, False
        window = self._pending + delta
        for s in self._stop_strings:
            idx = window.find(s)
            if idx != -1:
                self._pending = ""
                return (window[:idx] or None), True
        hold = self._holdback_len(window)
        emit = window[: len(window) - hold] if hold else window
        self._pending = window[len(window) - hold :] if hold else ""
        return (emit or None), False

    def step_batch(self, token_ids: List[int]) -> tuple[Optional[str], int, bool]:
        """Feed a whole delta batch; returns (text_delta, n_consumed, hit).

        One tokenizer decode for the batch; stop-string holdback applies to
        the joined text, so a stop string straddling a batch boundary is
        caught exactly as in per-token stepping. On a hit the batch replays
        per-token from a state snapshot to attribute the hit to its token —
        `n_consumed` then counts tokens up to and including it, so usage
        accounting matches the singleton-emission path. The replay happens
        at most once per request (at stream end)."""
        if not token_ids:
            return None, 0, False
        if not self._stop_strings:
            return self._stream.step_batch(token_ids), len(token_ids), False
        snap = self._stream.snapshot()
        pending = self._pending
        delta = self._stream.step_batch(token_ids)
        window = pending + (delta or "")
        if not any(s in window for s in self._stop_strings):
            if delta is None:
                return None, len(token_ids), False
            emit, _hit = self._scan(delta)
            return emit, len(token_ids), False
        # a stop string completed somewhere inside the batch: replay to
        # find WHICH token finished it (tokens past it were never "said")
        self._stream.restore(snap)
        self._pending = pending
        parts: List[str] = []
        for n, tok in enumerate(token_ids, start=1):
            emit, hit = self.step(tok)
            if emit:
                parts.append(emit)
            if hit:
                return ("".join(parts) or None), n, True
        return ("".join(parts) or None), len(token_ids), False


class Backend(Operator):
    """Detokenization operator (reference Backend.fwd/bwd backend.rs:55):
    forward passes the request through untouched; backward turns the token
    stream into text deltas and enforces stop strings. Usable either as a
    node in runtime.pipeline.compose() or as a classic engine wrapper
    (`inner` given)."""

    def __init__(self, inner=None,
                 tokenizer=None):
        self.inner = inner
        self.tokenizer = tokenizer
        # detok offload (docs/frontend_scaleout.md): batches big enough to
        # amortize the executor hop — and every stop-string scan, whose
        # worst case (replay on a hit, long holdback windows) is exactly
        # the work that must not stall the shared event loop — run on the
        # bounded compute pool; tiny batches stay inline where the hop
        # would cost more than it frees. Read per-instance so test
        # clusters can flip the env after import.
        self._pool = bool(_env("DYN_DETOK_POOL", True, bool))
        self._pool_min = max(_env("DYN_DETOK_POOL_MIN_TOKENS", 8, int), 1)

    async def generate(
        self, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[Annotated]:
        async for item in self.backward(
            self.inner.generate(request, context), request, context
        ):
            yield item

    async def backward(
        self, stream, request: PreprocessedRequest, context: Context
    ) -> AsyncIterator[Annotated]:
        stop_strings = request.stop_conditions.get("stop") or []
        decoder = Decoder(self.tokenizer, stop_strings)
        stopped = False
        async for ann in merge_token_deltas(stream):
            if ann.data is None:
                yield ann  # pure annotation/error event passes through
                continue
            out = (
                ann.data
                if isinstance(ann.data, LLMEngineOutput)
                else LLMEngineOutput.from_dict(ann.data)
            )
            text_parts: List[str] = []
            lp_entries: List[dict] = []
            if out.log_probs is None:
                # batched fast path: one tokenizer call for the whole
                # delta batch; tokens past a stop-string hit are dropped
                # so usage accounting matches per-token stepping. The
                # decoder is confined to this coroutine, so pool execution
                # is sequential per request — byte-identical to inline.
                ids = out.token_ids
                if self._pool and ids and (
                    stop_strings or len(ids) >= self._pool_min
                ):
                    delta, n_used, stopped = await ComputePool.get().run(
                        decoder.step_batch, ids
                    )
                else:
                    delta, n_used, stopped = decoder.step_batch(ids)
                if n_used < len(out.token_ids):
                    out.token_ids = out.token_ids[:n_used]
                if delta:
                    text_parts.append(delta)
            else:
                for idx, tok in enumerate(out.token_ids):
                    delta, hit = decoder.step(tok)
                    if delta:
                        text_parts.append(delta)
                    # per-token pairing happens HERE. The entry's token
                    # string decodes the id directly — the incremental
                    # delta can be empty (multi-byte UTF-8 split, stop-
                    # string holdback) and entries must stay 1:1 with
                    # tokens for legacy-completions alignment
                    if idx < len(out.log_probs):
                        entry = {"token": self.tokenizer.decode([tok]),
                                 "logprob": out.log_probs[idx]}
                        tops = out.top_logprobs
                        if tops and idx < len(tops) and tops[idx]:
                            entry["top_logprobs"] = [
                                {
                                    "token": self.tokenizer.decode([tid]),
                                    "logprob": tlp,
                                }
                                for tid, tlp in zip(
                                    tops[idx]["ids"], tops[idx]["logprobs"]
                                )
                            ]
                        lp_entries.append(entry)
                    if hit:
                        stopped = True
                        # truncate the batch at the hit token: 1:1 entry
                        # alignment and token counts end where the text did
                        out.token_ids = out.token_ids[: idx + 1]
                        out.log_probs = out.log_probs[: idx + 1]
                        if out.top_logprobs:
                            out.top_logprobs = out.top_logprobs[: idx + 1]
                        break
            if out.text is None:
                out.text = "".join(text_parts) if text_parts else None
            if lp_entries:
                out.logprob_entries = lp_entries
            if stopped and out.finish_reason is None:
                out.finish_reason = "stop"
            yield Annotated(data=out, id=ann.id, event=ann.event, comment=ann.comment)
            if stopped:
                context.stop_generating()
                return
            if out.finish_reason is not None:
                return
