"""The port's OpenAI types (`dynamo_tpu_torch/llm/protocols/openai.py`, no
pydantic) against the reference's pydantic models: the same bodies parse to
the same dumps or are both refused, and the same response and chunk objects
serialize to the same dicts and the same compact JSON bytes."""

import math
import random
import struct

import pytest

from dynamo_tpu.llm.protocols import openai as R
from dynamo_tpu_torch.llm.protocols import openai as P

CHAT_BODIES = [
    {"model": "m", "messages": [{"role": "user", "content": "hi"}]},
    # extra fields at every level, nvext with extras, numeric strings
    {"model": "m", "messages": [{"role": "user", "content": "hi", "x_extra": 1}],
     "temperature": 1, "max_tokens": "5", "top_k": 3.0, "zzz": [1, None],
     "nvext": {"annotations": ["kv_hit_rate"], "foo": None, "priority": "2",
               "backend_instance_id": 7, "ignore_eos": 1, "lora_name": "a",
               "router_config_override": {"router_temperature": 0.5}}},
    # tools, tool_choice, stream_options, n, logprobs, image parts
    {"model": "m", "messages": [
        {"role": "system", "content": "be brief", "name": "sys"},
        {"role": "user", "content": [
            {"type": "text", "text": "what is"},
            {"type": "image_url", "image_url": {"url": "data:image/png;base64,AAAA"}}]},
        {"role": "assistant", "content": None, "tool_calls": [
            {"id": "c1", "type": "function",
             "function": {"name": "f", "arguments": "{}"}, "extra": True}]},
        {"role": "tool", "content": "42", "tool_call_id": "c1"}],
     "tools": [{"type": "function", "function": {"name": "f", "parameters": {}}}],
     "tool_choice": "auto", "parallel_tool_calls": "false",
     "stream": "true", "stream_options": {"include_usage": "yes", "more": 1},
     "n": 2.0, "logprobs": 1, "top_logprobs": 2, "seed": "7",
     "stop": ["a", "b"], "logit_bias": {"5": 1}, "response_format": {"type": "json_object"},
     "chat_template_args": {"enable_thinking": False},
     "nvext": {"guided_json": {"type": "object"}, "guided_choice": ["a", "b"]}},
    {"model": "m", "messages": [], "stop": "x", "nvext": {"guided_json": "{}"}},
    {"model": "m", "messages": [{"role": "user", "content": "x"}], "max_completion_tokens": 3,
     "min_tokens": 1, "presence_penalty": "0.5", "frequency_penalty": -1,
     "repetition_penalty": 1.1, "user": "u", "tool_choice": {"type": "none"}},
    # invalid bodies: both refuse
    {"model": "m"},
    {"messages": []},
    {"model": 3, "messages": []},
    {"model": "m", "messages": [{"content": "no role"}]},
    {"model": "m", "messages": [{"role": "user"}], "stop": ["a", 1]},
    {"model": "m", "messages": [], "max_tokens": 2.5},
    {"model": "m", "messages": [], "stream": 2},
    {"model": "m", "messages": [], "temperature": "hot"},
    {"model": "m", "messages": "hi"},
    {"model": "m", "messages": [], "nvext": {"priority": 1.5}},
    {"model": "m", "messages": [], "nvext": "x"},
    {"model": "m", "messages": [], "stream_options": []},
    {"model": "m", "messages": [{"role": "user", "content": 5}]},
    {"model": "m", "messages": [], "logit_bias": {"1": "x"}},
]

COMPLETION_BODIES = [
    {"model": "m", "prompt": "hello"},
    {"model": "m", "prompt": [1, 2, 3], "max_tokens": 4, "temperature": 0},
    {"model": "m", "prompt": [[1, 2], [3]], "echo": "no", "suffix": "s"},
    {"model": "m", "prompt": ["a", "b"], "n": 2, "stream": True,
     "stream_options": {"include_usage": True}},
    # logprobs: StrictBool before int
    {"model": "m", "prompt": "x", "logprobs": False},
    {"model": "m", "prompt": "x", "logprobs": True},
    {"model": "m", "prompt": "x", "logprobs": 0},
    {"model": "m", "prompt": "x", "logprobs": 3},
    {"model": "m", "prompt": "x", "logprobs": 2.0},
    {"model": "m", "prompt": "x", "logprobs": "2"},
    {"model": "m", "prompt": "x", "nvext": {"ignore_eos": True}, "extra": {"a": 1}},
    {"model": "m", "prompt": []},
    # invalid
    {"model": "m", "prompt": [1, "a"]},
    {"model": "m", "prompt": 5},
    {"model": "m", "prompt": "x", "logprobs": 1.5},
    {"model": "m", "prompt": "x", "logprobs": "yes"},
    {"model": "m"},
]

EMBEDDING_BODIES = [
    {"model": "m", "input": "a"},
    {"model": "m", "input": ["a", "b"], "encoding_format": "float"},
    {"model": "m", "input": [1, 2], "encoding_format": "base64", "dimensions": "8"},
    {"model": "m", "input": [[1], [2, 3]], "user": "u"},
    {"model": "m", "input": "a", "encoding_format": None},
    {"model": "m", "input": "a", "encoding_format": "FLOAT"},
    {"model": "m", "input": {"a": 1}},
]


def _parse(mod, cls, body):
    try:
        return getattr(mod, cls).model_validate(body).model_dump()
    except Exception as e:  # noqa: BLE001 — the refusal itself is compared
        assert isinstance(e, ValueError), e
        return "refused"


@pytest.mark.parametrize("cls,body", (
    [("ChatCompletionRequest", b) for b in CHAT_BODIES]
    + [("CompletionRequest", b) for b in COMPLETION_BODIES]
    + [("EmbeddingRequest", b) for b in EMBEDDING_BODIES]),
    ids=lambda x: x if isinstance(x, str) else None)
def test_request_bodies_parse_alike(cls, body):
    ref = _parse(R, cls, body)
    port = _parse(P, cls, body)
    assert port == ref
    if ref != "refused":
        # exclude_none dumps, the form the handlers pass on, agree too
        assert (getattr(P, cls).model_validate(body).model_dump(exclude_none=True)
                == getattr(R, cls).model_validate(body).model_dump(exclude_none=True))


def test_parsed_values_keep_their_types():
    body = {"model": "m", "prompt": "x", "logprobs": False, "max_tokens": "4",
            "temperature": 1, "nvext": {"annotations": ["a"]}}
    ref = R.CompletionRequest.model_validate(body)
    port = P.CompletionRequest.model_validate(body)
    for name in ("logprobs", "max_tokens", "temperature"):
        assert type(getattr(port, name)) is type(getattr(ref, name)), name
    assert port.nvext.annotations == ref.nvext.annotations
    extra = P.ChatCompletionRequest.model_validate(
        {"model": "m", "messages": [], "custom": {"k": 1}})
    assert extra.custom == {"k": 1}  # extras read as attributes, as pydantic's


def _responses(mod):
    """The same response and chunk objects built in either package."""
    lp = [{"token": "a", "logprob": -1.2e-05,
           "top_logprobs": [{"token": "a", "logprob": -1.2e-05}, {"token": "é", "logprob": -3.5}]},
          {"token": "\n", "logprob": -0.5}]
    return {
        "chat_chunk": mod.ChatCompletionChunk(
            id="chatcmpl-1", created=1, model="m",
            choices=[mod.StreamChoice(index=1, delta=mod.ChoiceDelta(role="assistant", content="é\"\n"),
                                      logprobs=mod.chat_logprobs(lp))]),
        "tool_chunk": mod.ChatCompletionChunk(
            id="chatcmpl-2", created=2, model="m",
            choices=[mod.StreamChoice(delta=mod.ChoiceDelta(tool_calls=[mod.ToolCall.model_validate(
                {"id": "call_1", "type": "function", "function": {"name": "f", "arguments": "{\"x\": 1}"},
                 "index": 0})]))]),
        "usage_chunk": mod.ChatCompletionChunk(id="c", created=3, model="m", choices=[],
                                               usage=mod.Usage(prompt_tokens=5, completion_tokens=7,
                                                               total_tokens=12)),
        "chat_response": mod.ChatCompletionResponse(
            id="chatcmpl-3", created=4, model="m",
            choices=[mod.Choice(index=0, message=mod.ChatMessage(role="assistant", content="hi",
                                                                 reasoning_content="r"),
                                finish_reason="stop", logprobs=mod.chat_logprobs(lp))],
            usage=mod.Usage(prompt_tokens=1, completion_tokens=2, total_tokens=3)),
        "completion_chunk": mod.CompletionChunk(
            id="cmpl-1", created=5, model="m",
            choices=[mod.CompletionChoice(index=0, text="x", logprobs=mod.completion_logprobs(lp, 3))]),
        "completion_response": mod.CompletionResponse(
            id="cmpl-2", created=6, model="m",
            choices=[mod.CompletionChoice(text="abc", finish_reason="length")],
            usage=mod.Usage(prompt_tokens=1)),
        "embedding_response": mod.EmbeddingResponse(
            data=[{"object": "embedding", "index": 0, "embedding": [0.1, -2.0, 1e-07, 3e22]}],
            model="m", usage=mod.Usage(prompt_tokens=2, total_tokens=2)),
        "model_list": mod.ModelList(data=[mod.ModelInfo(id="a", created=7), mod.ModelInfo(id="b", created=8)]),
    }


@pytest.mark.parametrize("name", sorted(_responses(R)))
def test_responses_serialize_to_the_same_json(name):
    ref, port = _responses(R)[name], _responses(P)[name]
    assert port.model_dump() == ref.model_dump()
    assert port.model_dump(exclude_none=True) == ref.model_dump(exclude_none=True)
    assert port.model_dump_json(exclude_none=True) == ref.model_dump_json(exclude_none=True)
    assert port.model_dump_json() == ref.model_dump_json()


def test_logprob_helpers_equal():
    entries = [{"token": "ab", "logprob": -0.25, "top_logprobs": [{"token": "ab", "logprob": -0.25}]},
               {"token": "c", "logprob": -1.0}]
    assert P.completion_logprobs(entries, 7) == R.completion_logprobs(entries, 7)
    assert P.completion_logprobs([], 0) is R.completion_logprobs([], 0) is None
    assert P.chat_logprobs(entries).model_dump() == R.chat_logprobs(entries).model_dump()
    assert P.chat_logprobs(None) is None


def test_floats_print_as_pydantic_prints_them():
    rng = random.Random(0)
    values = [0.0, -0.0, 1.0, 0.1, 1e-05, 1.2e-05, 1e16, 1e17, 12345678901234567.0,
              5e-324, 1.7976931348623157e308, float("inf"), float("nan")]
    values += [struct.unpack("<d", struct.pack("<Q", rng.getrandbits(64)))[0] for _ in range(3000)]
    values += [rng.uniform(-9, 9) * 10.0 ** rng.randint(-9, 20) for _ in range(3000)]
    from pydantic import BaseModel

    class F(BaseModel):
        x: float

    for v in values:
        want = F(x=v).model_dump_json()[len('{"x":'):-1]
        assert P._json_float(v) == want, v
        if math.isfinite(v):
            assert float(P._json_float(v)) == v
