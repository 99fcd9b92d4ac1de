"""Engine-facing protocol types.

Mirrors reference lib/llm/src/protocols/common/: `PreprocessedRequest` (the
tokenized request that crosses the network to workers), `LLMEngineOutput`
(per-step engine emission), `StopConditions`/`SamplingOptions`, and the
`Annotated<T>` event wrapper used on every response stream
(lib/llm/src/protocols/annotated.rs).

These are plain dicts on the wire (msgpack); the dataclasses here are the
typed construction/validation layer.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


class FinishReason:
    STOP = "stop"
    LENGTH = "length"
    EOS = "eos"
    CANCELLED = "cancelled"
    CONTENT_FILTER = "content_filter"
    ERROR = "error"


@dataclass
class StopConditions:
    """When to stop generating (reference common/preprocessor.rs StopConditions)."""

    max_tokens: Optional[int] = None
    stop: Optional[List[str]] = None  # stop strings (detokenizer-side)
    stop_token_ids: Optional[List[int]] = None  # engine-side
    min_tokens: Optional[int] = None
    ignore_eos: bool = False

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v not in (None, False)}


@dataclass
class SamplingOptions:
    """Sampling controls (reference common/preprocessor.rs SamplingOptions)."""

    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    frequency_penalty: Optional[float] = None
    presence_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    n: int = 1
    logprobs: Optional[int] = None

    def to_dict(self) -> dict:
        return {k: v for k, v in dataclasses.asdict(self).items() if v is not None}


@dataclass
class PreprocessedRequest:
    """The tokenized request routed to engine workers
    (reference lib/llm/src/protocols/common/preprocessor.rs).

    `token_ids` is the full prompt; `batch_token_ids` reserved for n>1.
    `sampling_options`/`stop_conditions` are engine-interpretable;
    `annotations` request extra events (e.g. kv-hit-rate); `router` carries
    per-request router overrides (reference RouterConfigOverride);
    `disagg_params` carries the KV-transfer descriptors during
    prefill/decode disaggregation (NIXL-metadata role).
    """

    token_ids: List[int]
    model: str = ""
    sampling_options: Dict[str, Any] = field(default_factory=dict)
    stop_conditions: Dict[str, Any] = field(default_factory=dict)
    eos_token_ids: List[int] = field(default_factory=list)
    annotations: List[str] = field(default_factory=list)
    router: Dict[str, Any] = field(default_factory=dict)
    disagg_params: Optional[Dict[str, Any]] = None
    request_id: str = ""
    estimated_prefix_hit_num_blocks: Optional[int] = None
    # cluster KV fabric holder hint (KvPushRouter → worker): the worker
    # whose cache holds this request's longest prefix, per the router's
    # radix index — {"instance": id, "blocks": matched}. The admission
    # path uses it to pull those blocks from the holder's tiers over the
    # KV data plane instead of recomputing (docs/kvbm.md); advisory only,
    # a wrong/stale hint degrades to recompute.
    kv_holder: Optional[Dict[str, Any]] = None
    embed: bool = False  # embeddings request: engine returns {"embedding": [...]}
    # multimodal content parts extracted from the chat request (reference
    # multimodal E/P/D protocol surface, components/backends/trtllm):
    # [{"type": "image_url", "url": ..., "position": <token offset>}].
    # Engines without multimodal support must REJECT, not silently drop.
    multimodal: Optional[List[Dict[str, Any]]] = None
    # guided-decoding spec ({"kind": "regex"|"choice"|"json_schema"|
    # "json_object", ...}) normalized from response_format / nvext by
    # llm/guided.extract_guided_spec; engines compile it to a token FSM
    guided: Optional[Dict[str, Any]] = None
    # multi-LoRA adapter selection (nvext.lora_name). Salts the token
    # block hashes (reference protocols.rs:110-115 lora_id) so router +
    # prefix cache + KVBM never share KV across adapters.
    lora_name: Optional[str] = None
    # scheduling priority (nvext.priority, engine/scheduler/): each +1
    # halves the request's TTFT target (tighter EDF deadline), each -1
    # doubles it. 0 = default class. Only consulted under
    # DYN_SCHED_POLICY=sla; fifo ignores it.
    priority: int = 0
    # tenant key (dynogate, docs/overload.md): set by the frontend from
    # the DYN_GATE_TENANT_HEADER request header. Drives the gate's
    # weighted-fair queueing / rate limits at the edge and the
    # StepPlanner's per-tenant fairness tiebreak in the worker. None =
    # the 'default' tenant.
    tenant: Optional[str] = None
    # migration retry ordinal (llm/migration.py): > 0 marks a request
    # that RESUMES a stream lost to a worker death — token_ids is the
    # original prompt plus the tokens already delivered to the client.
    # Engines classify the resume source (checkpoint/peer/local/
    # recompute) and count what the death cost (docs/fault_tolerance.md).
    migration: int = 0

    def to_dict(self) -> dict:
        d = {
            "token_ids": self.token_ids,
            "model": self.model,
            "sampling_options": self.sampling_options,
            "stop_conditions": self.stop_conditions,
            "eos_token_ids": self.eos_token_ids,
            "request_id": self.request_id,
        }
        if self.annotations:
            d["annotations"] = self.annotations
        if self.router:
            d["router"] = self.router
        if self.disagg_params is not None:
            d["disagg_params"] = self.disagg_params
        if self.estimated_prefix_hit_num_blocks is not None:
            d["estimated_prefix_hit_num_blocks"] = self.estimated_prefix_hit_num_blocks
        if self.kv_holder is not None:
            d["kv_holder"] = self.kv_holder
        if self.embed:
            d["embed"] = True
        if self.multimodal:
            d["multimodal"] = self.multimodal
        if self.guided:
            d["guided"] = self.guided
        if self.lora_name:
            d["lora_name"] = self.lora_name
        if self.priority:
            d["priority"] = self.priority
        if self.tenant:
            d["tenant"] = self.tenant
        if self.migration:
            d["migration"] = self.migration
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PreprocessedRequest":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class LLMEngineOutput:
    """One engine emission: newly generated tokens for a request
    (reference lib/llm/src/protocols/common/llm_backend.rs LLMEngineOutput)."""

    token_ids: List[int] = field(default_factory=list)
    text: Optional[str] = None  # engines may pre-detokenize (mocker does not)
    cum_log_probs: Optional[float] = None
    log_probs: Optional[List[float]] = None
    top_logprobs: Optional[List[Dict[str, Any]]] = None
    finish_reason: Optional[str] = None
    kv_transfer_params: Optional[Dict[str, Any]] = None
    completion_usage: Optional[Dict[str, int]] = None
    disagg_info: Optional[Dict[str, Any]] = None
    # set by the parsers/jail layer, not by engines
    tool_calls: Optional[List[Dict[str, Any]]] = None
    reasoning_content: Optional[str] = None
    # set by the detokenizer backend when the request asked for logprobs:
    # [{"token": <delta text>, "logprob": f}] aligned with token_ids
    logprob_entries: Optional[List[Dict[str, Any]]] = None

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {"token_ids": self.token_ids}
        for k in (
            "text",
            "cum_log_probs",
            "log_probs",
            "top_logprobs",
            "finish_reason",
            "kv_transfer_params",
            "completion_usage",
            "disagg_info",
            "tool_calls",
            "reasoning_content",
            "logprob_entries",
        ):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "LLMEngineOutput":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class Annotated:
    """SSE event wrapper: data plus optional event name / comments
    (reference lib/llm/src/protocols/annotated.rs Annotated<T>).

    Events carry out-of-band annotations (kv-hit-rate, worker-id, errors)
    alongside the data stream without breaking OpenAI framing.
    """

    data: Optional[Any] = None
    id: Optional[str] = None
    event: Optional[str] = None
    comment: Optional[List[str]] = None

    def is_error(self) -> bool:
        return self.event == "error"

    def to_dict(self) -> dict:
        d: Dict[str, Any] = {}
        if self.data is not None:
            d["data"] = self.data
        if self.id is not None:
            d["id"] = self.id
        if self.event is not None:
            d["event"] = self.event
        if self.comment:
            d["comment"] = self.comment
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "Annotated":
        if not isinstance(d, dict) or not (set(d) <= {"data", "id", "event", "comment"}):
            return cls(data=d)
        return cls(**d)

    @classmethod
    def from_error(cls, message: str) -> "Annotated":
        return cls(data=None, event="error", comment=[message])

    @classmethod
    def from_annotation(cls, name: str, value: Any) -> "Annotated":
        import json

        # compact separators: annotation comments ride the SSE stream
        return cls(
            data=None, event=name,
            comment=[json.dumps(value, separators=(",", ":"))],
        )
