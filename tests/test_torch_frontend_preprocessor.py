"""The port's preprocessor, detokenizing backend, delta generators and
output parsers against the reference's on the same inputs: the same prompt
text and token ids from the default chat template and from a card's own,
the same PreprocessedRequest, the same refusals, the same text deltas and
finish reasons from the same engine token stream, the same SSE chunks apart
from `id` and `created`, and the reference's parser test cases passing on
both packages."""

import asyncio
import json
import time
from pathlib import Path

import pytest

import dynamo_tpu.llm.backend as RB
import dynamo_tpu.llm.preprocessor as RP
import dynamo_tpu_torch.llm.backend as PB
import dynamo_tpu_torch.llm.preprocessor as PP
from dynamo_tpu.llm import protocols as RPR
from dynamo_tpu.llm.model_card import ModelDeploymentCard as RCard
from dynamo_tpu.llm.tokenizers import load_tokenizer as r_tok
from dynamo_tpu_torch.llm import protocols as PPR
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard as PCard
from dynamo_tpu_torch.llm.tokenizers import load_tokenizer as p_tok

from . import frontend_parity

SIDES = {
    "ref": (RP, RB, RPR, RCard, r_tok),
    "port": (PP, PB, PPR, PCard, p_tok),
}

# a card's own template: role headers, a system default, tools, a
# raise_exception guard and a chat_template_args switch
CARD_TEMPLATE = """\
{%- if messages[0].role != 'system' %}<|system|>default system<|end|>{% endif -%}
{%- for m in messages -%}
{%- if m.role not in ['system', 'user', 'assistant', 'tool'] -%}{{ raise_exception('bad role ' + m.role) }}{%- endif -%}
<|{{ m.role }}|>{% if m.name %}[{{ m.name }}]{% endif %}{{ m.content }}<|end|>
{% endfor -%}
{%- if tools %}<|tools|>{{ tools | tojson }}<|end|>{% endif -%}
{%- if enable_thinking %}<think>{% endif -%}
{%- if add_generation_prompt %}<|assistant|>{% endif -%}"""

CHATS = [
    {"model": "m", "messages": [{"role": "user", "content": "hi"}]},
    {"model": "m", "messages": [{"role": "system", "content": "sys"},
                                {"role": "user", "content": "héllo wörld", "name": "bob"},
                                {"role": "assistant", "content": "ok"},
                                {"role": "user", "content": [{"type": "text", "text": "a "},
                                                             {"type": "text", "text": "b"}]}],
     "temperature": 0.7, "top_p": 0.9, "top_k": 5, "seed": 3, "stop": "END",
     "max_tokens": 20, "min_tokens": 2, "presence_penalty": 0.1, "frequency_penalty": 0.2,
     "repetition_penalty": 1.1, "n": 2, "logprobs": True, "top_logprobs": 3,
     "nvext": {"ignore_eos": True, "annotations": ["worker_id"], "priority": 2,
               "router_config_override": {"overlap_score_weight": 2.0}}},
    {"model": "m", "messages": [{"role": "user", "content": "tools please"}],
     "tools": [{"type": "function", "function": {"name": "f", "parameters": {"type": "object"}}}],
     "chat_template_args": {"enable_thinking": True}, "max_completion_tokens": 7},
    {"model": "m", "messages": [{"role": "user", "content": "no prompt"}],
     "chat_template_args": {"add_generation_prompt": False}, "stop": ["a", "bc"]},
    {"model": "m", "messages": [{"role": "user", "content": [
        {"type": "text", "text": "see"},
        {"type": "image_url", "image_url": {"url": "data:image/png;base64,iVBO"}},
        {"type": "input_audio", "input_audio": {"data": "x"}}]}]},
    {"model": "m", "messages": [{"role": "user", "content": "json"}],
     "response_format": {"type": "json_object"}},
    {"model": "m", "messages": [{"role": "user", "content": "lora"}], "nvext": {"lora_name": "ad1"}},
    # refusals: both raise ValueError
    {"model": "m", "messages": [{"role": "user", "content": "x"}], "logit_bias": {"1": 1.0}},
    {"model": "m", "messages": [{"role": "user", "content": "x"}], "logprobs": True, "top_logprobs": 6},
    {"model": "m", "messages": [{"role": "user", "content": "x"}], "top_logprobs": 2},
    {"model": "m", "messages": [{"role": "user", "content": "x"}], "nvext": {"priority": 9}},
    {"model": "m", "messages": [{"role": "user", "content": "x"}], "nvext": {"guided_grammar": "a"}},
    {"model": "m", "messages": [{"role": "user", "content": "x"}],
     "nvext": {"lora_name": "a", "guided_regex": "[a-z]+"}},
    {"model": "m", "messages": [{"role": "user", "content": [
        {"type": "image_url", "image_url": {"url": "data:x"}}]}], "response_format": {"type": "json_object"}},
    {"model": "m", "messages": [{"role": "user", "content": "x" * 300}]},
]

COMPLETIONS = [
    {"model": "m", "prompt": "hello there", "max_tokens": 5, "temperature": 0},
    {"model": "m", "prompt": [5, 6, 7, 8], "stop": ["x"], "logprobs": 2, "seed": 1},
    {"model": "m", "prompt": "x", "logprobs": False},
    {"model": "m", "prompt": "x", "logprobs": 0},
    {"model": "m", "prompt": "x", "nvext": {"guided_choice": ["yes", "no"]}},
    # refusals
    {"model": "m", "prompt": "x", "n": 2},
    {"model": "m", "prompt": "x", "echo": True},
    {"model": "m", "prompt": "x", "suffix": "y"},
    {"model": "m", "prompt": ["a", "b"]},
    {"model": "m", "prompt": "x", "logprobs": 6},
]


def _pre(side, template=None):
    pp, _b, pr, card_cls, tok = SIDES[side]
    card = card_cls(name="m", tokenizer="byte", context_length=256, chat_template=template)
    return pp.OpenAIPreprocessor(card, tok("byte")), pr


def _chat(side, body, template=None):
    pre, pr = _pre(side, template)
    req = pr.ChatCompletionRequest.model_validate(body)
    try:
        text = pre.apply_template(req)
        out = pre.preprocess_chat(req).to_dict()
    except ValueError as e:
        return "refused", type(e).__name__
    except Exception as e:  # noqa: BLE001 — a template's raise_exception
        return "template error", type(e).__name__
    out.pop("request_id")
    return text, out


@pytest.mark.parametrize("template", [None, CARD_TEMPLATE], ids=["default", "card"])
@pytest.mark.parametrize("i", range(len(CHATS)))
def test_chat_preprocessing_equal(i, template):
    ref = _chat("ref", CHATS[i], template)
    port = _chat("port", CHATS[i], template)
    assert port == ref
    if i == 0:
        assert ref[1]["token_ids"]  # the prompt tokenized to something


def test_card_template_raise_exception_equal():
    body = {"model": "m", "messages": [{"role": "robot", "content": "x"}]}
    assert _chat("port", body, CARD_TEMPLATE) == _chat("ref", body, CARD_TEMPLATE) \
        == ("template error", "TemplateError")


@pytest.mark.parametrize("i", range(len(COMPLETIONS)))
def test_completion_preprocessing_equal(i):
    outs = []
    for side in ("ref", "port"):
        pre, pr = _pre(side)
        req = pr.CompletionRequest.model_validate(COMPLETIONS[i])
        try:
            d = pre.preprocess_completion(req).to_dict()
            d.pop("request_id")
        except ValueError:
            d = "refused"
        outs.append(d)
    assert outs[0] == outs[1]


def test_async_preprocessing_runs_on_the_compute_pool():
    pre, pr = _pre("port")
    req = pr.ChatCompletionRequest.model_validate(CHATS[1])
    out = asyncio.run(pre.preprocess_chat_async(req))
    ref_pre, rpr = _pre("ref")
    ref = asyncio.run(ref_pre.preprocess_chat_async(rpr.ChatCompletionRequest.model_validate(CHATS[1])))
    assert out.token_ids == ref.token_ids
    from dynamo_tpu_torch.runtime.compute import ComputePool

    assert ComputePool.get().tasks_run >= 1


# ---------------------------------------------------------------------------
# backward path: detokenizer + stop strings + delta generators
# ---------------------------------------------------------------------------

TEXT = "Hello, wörld! STOP here ✓ and more text after the stop."


def _engine_items(side, logprobs: bool, batch: int):
    """An engine's stream: the byte tokenizer's ids of TEXT in batches,
    with logprobs when asked, the last batch finishing with 'length'."""
    pr = SIDES[side][2]
    ids = SIDES[side][4]("byte").encode(TEXT)
    items = []
    for k in range(0, len(ids), batch):
        chunk = ids[k:k + batch]
        out = {"token_ids": chunk}
        if logprobs:
            out["log_probs"] = [-0.5 - j * 0.01 for j in range(len(chunk))]
            out["top_logprobs"] = [{"ids": [t, 65], "logprobs": [-0.5, -2.25]} for t in chunk]
        if k + batch >= len(ids):
            out["finish_reason"] = "length"
        items.append(pr.Annotated(data=pr.LLMEngineOutput.from_dict(out)))
    items.insert(1, pr.Annotated(event="worker_id", comment=["7"]))
    return items


async def _detok(side, stop, logprobs, batch):
    _pp, b, pr, _c, tok = SIDES[side]
    from dynamo_tpu.runtime.engine import Context as RCtx
    from dynamo_tpu_torch.runtime.engine import Context as PCtx

    ctx = (RCtx if side == "ref" else PCtx)()

    async def stream():
        for item in _engine_items(side, logprobs, batch):
            yield item
            await asyncio.sleep(0)

    req = pr.PreprocessedRequest(token_ids=[1], stop_conditions={"stop": stop} if stop else {})
    backend = b.Backend(tokenizer=tok("byte"))
    out = []
    async for ann in backend.backward(stream(), req, ctx):
        d = ann.data.to_dict() if ann.data is not None else None
        out.append({"event": ann.event, "comment": ann.comment, "data": d})
    return out, ctx.is_stopped()


def _summary(items):
    """What a client sees, whatever the batching: text, tokens, finish."""
    datas = [x["data"] for x in items if x["data"] is not None]
    return ("".join(d.get("text") or "" for d in datas),
            sum(len(d["token_ids"]) for d in datas),
            [d.get("finish_reason") for d in datas if d.get("finish_reason")],
            [x["event"] for x in items if x["event"]])


@pytest.mark.parametrize("stop", [None, ["STOP"], ["✓ and", "nomatch"]], ids=["none", "stop", "multibyte"])
@pytest.mark.parametrize("logprobs", [False, True], ids=["plain", "logprobs"])
@pytest.mark.parametrize("batch", [1, 5], ids=["b1", "b5"])
def test_backend_detokenizes_alike(stop, logprobs, batch, monkeypatch):
    # detokenizing inline keeps the batching a pure function of the event
    # loop's order, so both packages must give the same items exactly
    monkeypatch.setenv("DYN_DETOK_POOL", "0")
    ref = asyncio.run(_detok("ref", stop, logprobs, batch))
    port = asyncio.run(_detok("port", stop, logprobs, batch))
    assert port == ref
    assert _summary(ref[0])[0] == (TEXT.split(stop[0])[0] if stop else TEXT)
    # on the compute pool the batches depend on thread timing; what the
    # client reads does not
    monkeypatch.setenv("DYN_DETOK_POOL", "1")
    pooled = asyncio.run(_detok("port", stop, logprobs, batch))
    assert _summary(pooled[0]) == _summary(ref[0]) and pooled[1] == ref[1]


def test_merge_token_deltas_alike():
    async def run(side):
        pr = SIDES[side][2]
        b = SIDES[side][1]
        q = asyncio.Queue()
        items = [{"token_ids": [i]} for i in range(10)] + [
            {"token_ids": [10], "finish_reason": "stop"}]
        for it in items:
            q.put_nowait(pr.Annotated(data=it))

        async def stream():
            while not q.empty():
                yield q.get_nowait()

        return [a.to_dict() for a in [x async for x in b.merge_token_deltas(stream(), max_items=4)]]

    assert asyncio.run(run("port")) == asyncio.run(run("ref"))


def _chunks(side, kind):
    pp = SIDES[side][0]
    if kind == "chat":
        g = pp.ChatDeltaGenerator("m", "rid", include_usage=True, index=1)
        g.prompt_tokens = 4
        out = [g.text_chunk_json("He", 1), g.text_chunk_json("llo ✓\n", 3),
               g.reasoning_chunk("think").model_dump_json(exclude_none=True),
               g.tool_calls_chunk([{"id": "call_1", "type": "function",
                                    "function": {"name": "f", "arguments": "{}"}}]).model_dump_json(exclude_none=True),
               g.text_chunk("x", 1, logprob_entries=[{"token": "x", "logprob": -1.5e-05}]).model_dump_json(exclude_none=True),
               g.finish_chunk_json("eos"), g.finish_chunk("length").model_dump_json(exclude_none=True),
               g.usage_chunk().model_dump_json(exclude_none=True),
               g.role_chunk().model_dump_json(exclude_none=True)]
    else:
        g = pp.CompletionDeltaGenerator("m", "rid")
        g.prompt_tokens = 2
        out = [g.text_chunk_json("ab", 2),
               g.text_chunk("c", 1, logprob_entries=[{"token": "c", "logprob": -0.25,
                                                      "top_logprobs": [{"token": "c", "logprob": -0.25}]}]
                            ).model_dump_json(exclude_none=True),
               g.finish_chunk_json("stop"), g.finish_chunk("eos").model_dump_json(exclude_none=True),
               g.usage_chunk().model_dump_json(exclude_none=True)]
    return out


@pytest.mark.parametrize("kind", ["chat", "completion"])
def test_delta_chunks_equal(kind, monkeypatch):
    # the same request id and clock on both sides: `id` and `created` are
    # the only fields a chunk takes from outside its inputs
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.0)
    ref, port = _chunks("ref", kind), _chunks("port", kind)
    assert port == ref
    for chunk in ref:
        json.loads(chunk)


# ---------------------------------------------------------------------------
# the reference's parser cases, on both packages
# ---------------------------------------------------------------------------

PARSER_TESTS = Path(__file__).resolve().parent / "test_parsers.py"
_PARSER_CASES = frontend_parity.cases(frontend_parity.load_as(PARSER_TESTS, "dynamo_tpu"))


@pytest.mark.parametrize("pkg", frontend_parity.PACKAGES)
@pytest.mark.parametrize("case", _PARSER_CASES)
def test_reference_parser_cases(pkg, case):
    frontend_parity.run(frontend_parity.load_as(PARSER_TESTS, pkg), case)
