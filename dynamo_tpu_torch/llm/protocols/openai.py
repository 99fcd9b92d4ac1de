"""OpenAI-compatible API types, on the standard library.

Port of `dynamo_tpu/llm/protocols/openai.py` without `pydantic`: the same
types, fields, defaults and field order, declared as annotated classes and
validated the way pydantic's lax mode validates JSON-decoded bodies (an int
from `"3"` or `2.0`, a float from an int, a bool from `1` or `"yes"`;
`StrictBool` only from a bool; a union tries every member strictly before it
tries them leniently). Unknown fields are kept (the reference's
`extra="allow"`) and dumped after the declared ones. `model_validate`,
`model_dump(exclude_none=)` and `model_dump_json(exclude_none=)` give the
reference's dicts and compact JSON, floats in the shortest form pydantic
prints them. An invalid body raises `ValidationError` (a `ValueError`).
Mirrors the reference's vendored async-openai types + NVIDIA `nvext`
extension (lib/async-openai/src/types/, lib/llm/src/protocols/openai/).
"""

from __future__ import annotations

import json
import math
import time
import typing
from typing import Any, Dict, List, Literal, Optional, Union


class ValidationError(ValueError):
    """A request body that does not fit its type (pydantic's ValidationError
    role; the HTTP service answers it with a 400)."""


class StrictBool:
    """Annotation marker: a bool field that takes only JSON true/false."""


class Field:
    """A field default made per instance (pydantic `Field(default_factory=)`)."""

    def __init__(self, default_factory):
        self.default_factory = default_factory


_TRUE = {"1", "on", "t", "true", "y", "yes"}
_FALSE = {"0", "off", "f", "false", "n", "no"}
_MISSING = object()


def _check(tp, v, strict: bool):
    """`v` converted to `tp`, or ValidationError."""
    if tp is Any:
        return v
    origin = typing.get_origin(tp)
    if origin is Union:
        if v is None and type(None) in typing.get_args(tp):
            return None
        members = [a for a in typing.get_args(tp) if a is not type(None)]
        for mode in ((True,) if strict else (True, False)):
            for m in members:
                try:
                    return _check(m, v, mode)
                except ValidationError:
                    continue
        raise ValidationError(f"{v!r} matches none of {tp}")
    if origin is Literal:
        for a in typing.get_args(tp):
            if type(a) is type(v) and a == v:
                return v
        raise ValidationError(f"{v!r} is not one of {typing.get_args(tp)}")
    if origin is list:
        if not isinstance(v, list):
            raise ValidationError(f"expected a list, got {type(v).__name__}")
        (arg,) = typing.get_args(tp)
        return [_check(arg, x, strict) for x in v]
    if origin is dict:
        if not isinstance(v, dict):
            raise ValidationError(f"expected an object, got {type(v).__name__}")
        kt, vt = typing.get_args(tp)
        return {_check(kt, k, strict): _check(vt, x, strict) for k, x in v.items()}
    if isinstance(tp, type) and issubclass(tp, Model):
        if isinstance(v, tp):
            return v
        if isinstance(v, dict):
            return tp.model_validate(v)
        raise ValidationError(f"expected an object for {tp.__name__}")
    if tp is StrictBool:
        if type(v) is bool:
            return v
        raise ValidationError(f"expected a boolean, got {v!r}")
    if tp is str:
        if isinstance(v, str):
            return v
        if not strict and isinstance(v, bytes):
            return v.decode()
        raise ValidationError(f"expected a string, got {type(v).__name__}")
    if tp is bool:
        if type(v) is bool:
            return v
        if not strict:
            if type(v) in (int, float) and v in (0, 1):
                return bool(v)
            if isinstance(v, str) and v.strip().lower() in _TRUE | _FALSE:
                return v.strip().lower() in _TRUE
        raise ValidationError(f"expected a boolean, got {v!r}")
    if tp is int:
        if type(v) is int:
            return v
        if not strict:
            if type(v) is bool:
                return int(v)
            if type(v) is float and math.isfinite(v) and v == int(v):
                return int(v)
            if isinstance(v, str):
                s = v.strip()
                try:
                    return int(s)
                except ValueError:
                    try:
                        f = float(s)
                    except ValueError:
                        f = math.nan
                    if math.isfinite(f) and f == int(f):
                        return int(f)
        raise ValidationError(f"expected an integer, got {v!r}")
    if tp is float:
        if type(v) in (int, float):
            return float(v)
        if not strict:
            if type(v) is bool:
                return float(v)
            if isinstance(v, str):
                try:
                    return float(v.strip())
                except ValueError:
                    pass
        raise ValidationError(f"expected a number, got {v!r}")
    raise TypeError(f"unsupported field type {tp!r}")


def _dump(v, exclude_none: bool):
    if isinstance(v, Model):
        return v.model_dump(exclude_none=exclude_none)
    if isinstance(v, list):
        return [_dump(x, exclude_none) for x in v]
    if isinstance(v, dict):
        return {k: _dump(x, exclude_none) for k, x in v.items()}
    return v


def _json_float(x: float) -> str:
    """A float as pydantic's serializer writes it: the shortest round-trip
    digits, in plain notation while the decimal point falls within 16
    digits and no more than 5 places to the right, else `d.ddde-7`;
    non-finite values are null."""
    if not math.isfinite(x):
        return "null"
    if x == 0:
        return "-0.0" if math.copysign(1.0, x) < 0 else "0.0"
    sign, r = ("-", repr(-x)) if x < 0 else ("", repr(x))
    mant, _, exp = r.partition("e")
    whole, _, frac = mant.partition(".")
    digits = (whole + frac).lstrip("0")
    # the value is 0.<digits> x 10^point
    point = len(whole) + int(exp or 0) - (len(whole + frac) - len(digits))
    digits = digits.rstrip("0")
    k = len(digits)
    if 0 <= point - k and point <= 16:
        return sign + digits + "0" * (point - k) + ".0"
    if 0 < point <= 16:
        return sign + digits[:point] + "." + digits[point:]
    if -5 < point <= 0:
        return sign + "0." + "0" * -point + digits
    e = point - 1
    return sign + digits[0] + ("." + digits[1:] if k > 1 else "") + f"e{e}"


def _json(v) -> str:
    """Compact JSON, non-ASCII kept, floats as `_json_float`."""
    if isinstance(v, float):
        return _json_float(v)
    if isinstance(v, dict):
        return "{" + ",".join(f"{json.dumps(str(k), ensure_ascii=False)}:{_json(x)}"
                              for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_json(x) for x in v) + "]"
    return json.dumps(v, ensure_ascii=False)


class Model:
    """Base of the OpenAI types: annotated class attributes are the fields,
    their values the defaults."""

    _extra = "allow"  # "allow": keep unknown keys; "ignore": drop them
    __fields: Dict[type, list] = {}

    @classmethod
    def _field_specs(cls) -> list:
        specs = Model.__fields.get(cls)
        if specs is None:
            hints = typing.get_type_hints(cls, globalns=globals())
            specs = [(name, hints[name], cls.__dict__.get(name, _MISSING))
                     for name in cls.__dict__.get("__annotations__", {})
                     if not name.startswith("_")]
            Model.__fields[cls] = specs
        return specs

    def __init__(self, **data: Any):
        object.__setattr__(self, "_extras", {})
        for name, tp, default in self._field_specs():
            if name in data:
                value = _check(tp, data.pop(name), False)
            elif default is _MISSING:
                raise ValidationError(f"{type(self).__name__}.{name}: field required")
            elif isinstance(default, Field):
                value = default.default_factory()
            else:
                value = default
            object.__setattr__(self, name, value)
        if self._extra == "allow":
            self._extras.update(data)

    @classmethod
    def model_validate(cls, obj: Any):
        if isinstance(obj, cls):
            return obj
        if not isinstance(obj, dict):
            raise ValidationError(f"{cls.__name__}: expected an object, got {type(obj).__name__}")
        return cls(**obj)

    def __getattr__(self, name: str):
        extras = self.__dict__.get("_extras", {})
        if name in extras:
            return extras[name]
        raise AttributeError(name)

    def model_dump(self, exclude_none: bool = False) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, _tp, _d in self._field_specs():
            v = getattr(self, name)
            if not (exclude_none and v is None):
                out[name] = _dump(v, exclude_none)
        for name, v in self._extras.items():
            if not (exclude_none and v is None):
                out[name] = _dump(v, exclude_none)
        return out

    def model_dump_json(self, exclude_none: bool = False) -> str:
        return _json(self.model_dump(exclude_none=exclude_none))

    def __repr__(self):
        return f"{type(self).__name__}({self.model_dump(exclude_none=True)!r})"


class NvExt(Model):
    """NVIDIA extension block (reference protocols/openai/nvext.rs):
    per-request knobs outside the OpenAI schema."""

    ignore_eos: Optional[bool] = None
    greed_sampling: Optional[bool] = None
    annotations: Optional[List[str]] = None  # e.g. ["kv_hit_rate", "worker_id"]
    backend_instance_id: Optional[int] = None  # pin to a worker
    router_config_override: Optional[Dict[str, Any]] = None
    # guided decoding (reference nvext.rs:73-88), enforced by the engine's
    # token-level FSM logit masks (llm/guided.py)
    guided_json: Optional[Union[Dict[str, Any], str]] = None
    guided_regex: Optional[str] = None
    guided_choice: Optional[List[str]] = None
    guided_grammar: Optional[str] = None  # EBNF: rejected with 400 (unsupported)
    # multi-LoRA: select a served adapter by name
    lora_name: Optional[str] = None
    # scheduling priority under DYN_SCHED_POLICY=sla: each +1 halves the
    # request's TTFT target, each -1 doubles it
    priority: Optional[int] = None


class FunctionCall(Model):
    name: Optional[str] = None
    arguments: Optional[str] = None


class ToolCall(Model):
    id: Optional[str] = None
    type: str = "function"
    function: Optional[FunctionCall] = None
    index: Optional[int] = None


class ChatMessage(Model):
    role: str
    content: Optional[Union[str, List[Dict[str, Any]]]] = None
    name: Optional[str] = None
    tool_calls: Optional[List[ToolCall]] = None
    tool_call_id: Optional[str] = None
    reasoning_content: Optional[str] = None


class StreamOptions(Model):
    include_usage: Optional[bool] = None


class ChatCompletionRequest(Model):
    model: str
    messages: List[ChatMessage]
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None  # common extension
    n: Optional[int] = 1
    stream: Optional[bool] = False
    stream_options: Optional[StreamOptions] = None
    stop: Optional[Union[str, List[str]]] = None
    max_tokens: Optional[int] = None
    max_completion_tokens: Optional[int] = None
    min_tokens: Optional[int] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    logit_bias: Optional[Dict[str, float]] = None
    logprobs: Optional[bool] = None
    top_logprobs: Optional[int] = None
    user: Optional[str] = None
    seed: Optional[int] = None
    tools: Optional[List[Dict[str, Any]]] = None
    tool_choice: Optional[Union[str, Dict[str, Any]]] = None
    parallel_tool_calls: Optional[bool] = None
    response_format: Optional[Dict[str, Any]] = None
    chat_template_args: Optional[Dict[str, Any]] = None
    nvext: Optional[NvExt] = None


class CompletionRequest(Model):
    model: str
    prompt: Union[str, List[str], List[int], List[List[int]]]
    suffix: Optional[str] = None
    max_tokens: Optional[int] = None
    min_tokens: Optional[int] = None
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    top_k: Optional[int] = None
    n: Optional[int] = 1
    stream: Optional[bool] = False
    stream_options: Optional[StreamOptions] = None
    # StrictBool first: an explicit `false` must survive parsing as False
    # (plain int would coerce it to 0 == the legacy sampled-token ask)
    logprobs: Optional[Union[StrictBool, int]] = None
    echo: Optional[bool] = False
    stop: Optional[Union[str, List[str]]] = None
    presence_penalty: Optional[float] = None
    frequency_penalty: Optional[float] = None
    repetition_penalty: Optional[float] = None
    seed: Optional[int] = None
    user: Optional[str] = None
    nvext: Optional[NvExt] = None


class Usage(Model):
    prompt_tokens: int = 0
    completion_tokens: int = 0
    total_tokens: int = 0


class LogProbEntry(Model):
    token: str
    logprob: float
    bytes: Optional[List[int]] = None
    top_logprobs: Optional[List[Dict[str, Any]]] = None


class ChoiceLogProbs(Model):
    content: Optional[List[LogProbEntry]] = None


def chat_logprobs(entries) -> Optional[ChoiceLogProbs]:
    """[{token, logprob}] (backend logprob_entries) → chat logprobs
    object, made here for every chat surface."""
    if not entries:
        return None
    return ChoiceLogProbs(content=[LogProbEntry(**e) for e in entries])


def completion_logprobs(entries, base_offset: int = 0) -> Optional[Dict[str, Any]]:
    """[{token, logprob}] → the legacy completions logprobs object.
    `base_offset`: chars already streamed (offsets index the ACCUMULATED
    text, so chunked emission must carry the running total)."""
    if not entries:
        return None
    tops = None
    if any(e.get("top_logprobs") for e in entries):
        tops = [
            {t["token"]: t["logprob"] for t in e.get("top_logprobs") or []}
            for e in entries
        ]
    offsets, pos = [], base_offset
    for e in entries:
        offsets.append(pos)
        pos += len(e["token"])
    return {
        "tokens": [e["token"] for e in entries],
        "token_logprobs": [e["logprob"] for e in entries],
        "top_logprobs": tops,
        "text_offset": offsets,
    }


class ChoiceDelta(Model):
    role: Optional[str] = None
    content: Optional[str] = None
    reasoning_content: Optional[str] = None
    tool_calls: Optional[List[ToolCall]] = None


class StreamChoice(Model):
    index: int = 0
    delta: ChoiceDelta = Field(default_factory=ChoiceDelta)
    finish_reason: Optional[str] = None
    logprobs: Optional[ChoiceLogProbs] = None


class ChatCompletionChunk(Model):
    id: str
    object: str = "chat.completion.chunk"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[StreamChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None
    system_fingerprint: Optional[str] = None


class Choice(Model):
    index: int = 0
    message: ChatMessage = Field(default_factory=lambda: ChatMessage(role="assistant"))
    finish_reason: Optional[str] = None
    logprobs: Optional[ChoiceLogProbs] = None


class ChatCompletionResponse(Model):
    id: str
    object: str = "chat.completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[Choice] = Field(default_factory=list)
    usage: Optional[Usage] = None


class CompletionChoice(Model):
    index: int = 0
    text: str = ""
    finish_reason: Optional[str] = None
    logprobs: Optional[Dict[str, Any]] = None


class CompletionChunk(Model):
    id: str
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[CompletionChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None


class CompletionResponse(Model):
    id: str
    object: str = "text_completion"
    created: int = Field(default_factory=lambda: int(time.time()))
    model: str = ""
    choices: List[CompletionChoice] = Field(default_factory=list)
    usage: Optional[Usage] = None


class EmbeddingRequest(Model):
    model: str
    input: Union[str, List[str], List[int], List[List[int]]]
    encoding_format: Optional[Literal["float", "base64"]] = "float"
    dimensions: Optional[int] = None
    user: Optional[str] = None


class EmbeddingResponse(Model):
    object: str = "list"
    data: List[Dict[str, Any]] = Field(default_factory=list)
    model: str = ""
    usage: Optional[Usage] = None


class ModelInfo(Model):
    id: str
    object: str = "model"
    created: int = Field(default_factory=lambda: int(time.time()))
    owned_by: str = "dynamo-tpu"


class ModelList(Model):
    _extra = "ignore"

    object: str = "list"
    data: List[ModelInfo] = Field(default_factory=list)
