"""Tool-call parsing per model family.

Port of `dynamo_tpu/llm/parsers/tool_calling.py`, unchanged.

Role of reference lib/parsers/src/tool_calling/ (parsers.rs registry,
config.rs token configs, json/ + pythonic/ + harmony/ strategies): given a
model's complete text output, split it into (tool_calls, normal_content).
Named configs cover the same families the reference registers
(parsers.rs:180-189): hermes, llama3_json, mistral, nemotron_deci, phi4,
deepseek_v3_1, pythonic, harmony, default.
"""

from __future__ import annotations

import ast
import json
import re
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple


@dataclass
class ToolCallResult:
    name: str
    arguments: str  # JSON-encoded argument object
    id: str = field(default_factory=lambda: f"call-{uuid.uuid4().hex[:16]}")


@dataclass(frozen=True)
class JsonToolConfig:
    """Token-delimited JSON tool-call format (config.rs JsonParserConfig)."""

    start_tokens: Tuple[str, ...] = ()
    end_tokens: Tuple[str, ...] = ()
    name_keys: Tuple[str, ...] = ("name",)
    args_keys: Tuple[str, ...] = ("arguments", "parameters")
    # accept bare JSON (no start token) that looks like a tool call
    allow_bare_json: bool = True


PARSER_CONFIGS: Dict[str, JsonToolConfig] = {
    "default": JsonToolConfig(
        start_tokens=("<TOOLCALL>", "<|python_tag|>"), end_tokens=("</TOOLCALL>",)
    ),
    "hermes": JsonToolConfig(
        start_tokens=("<tool_call>",), end_tokens=("</tool_call>",)
    ),
    "llama3_json": JsonToolConfig(
        start_tokens=("<|python_tag|>",), end_tokens=("<|eom_id|>",)
    ),
    "mistral": JsonToolConfig(
        start_tokens=("[TOOL_CALLS]",), end_tokens=()
    ),
    "nemotron_deci": JsonToolConfig(
        start_tokens=("<TOOLCALL>",), end_tokens=("</TOOLCALL>",),
        allow_bare_json=False,
    ),
    "phi4": JsonToolConfig(
        start_tokens=("functools",), end_tokens=(), allow_bare_json=False
    ),
    "deepseek_v3_1": JsonToolConfig(
        start_tokens=("<｜tool▁calls▁begin｜>",),
        end_tokens=("<｜tool▁calls▁end｜>",),
        allow_bare_json=False,
    ),
}


def get_available_tool_parsers() -> List[str]:
    return sorted(list(PARSER_CONFIGS) + ["pythonic", "harmony"])


def _start_tokens_for(parser: str) -> Tuple[Tuple[str, ...], bool]:
    """(start tokens, bare-json-allowed) for a parser name; raises
    ValueError on unknown names."""
    if parser == "pythonic":
        return ("[",), False
    if parser == "harmony":
        return ("<|channel|>", "<|start|>"), False
    if parser not in PARSER_CONFIGS:
        raise ValueError(
            f"unknown tool parser {parser!r}; available: {get_available_tool_parsers()}"
        )
    cfg = PARSER_CONFIGS[parser]
    return cfg.start_tokens, cfg.allow_bare_json


def held_suffix_len(text: str, markers: Sequence[str]) -> int:
    """Length of the longest suffix of `text` that is a PROPER prefix of any
    marker (a complete marker would have been found by search, so the scan
    is bounded at max marker length - 1). Shared by the streaming reasoning
    parsers and the tool-call jail."""
    max_len = max((len(m) for m in markers), default=0)
    for n in range(min(len(text), max_len - 1), 0, -1):
        suf = text[-n:]
        if any(m.startswith(suf) for m in markers):
            return n
    return 0


def find_tool_call_start(
    text: str, parser: Optional[str] = None, allow_bare: bool = True
) -> Tuple[Optional[int], int]:
    """Scan accumulated text for a tool-call region start. Returns
    (start_index or None, held_suffix_len): `start_index` is the earliest
    position of a complete start marker (everything from there must be
    jailed); `held_suffix_len` is the length of a trailing partial marker
    that must be held back until the next delta disambiguates it.
    `allow_bare=False` disables the bare-JSON heuristic (callers pass False
    once mid-message — a quoted JSON example must not become a tool call)."""
    parser = parser or "default"
    starts, cfg_allow_bare = _start_tokens_for(parser)
    idx: Optional[int] = None
    for tok in starts:
        i = text.find(tok)
        if i >= 0 and (idx is None or i < idx):
            idx = i
    if cfg_allow_bare and allow_bare and idx is None:
        stripped = text.lstrip()
        if stripped[:1] in ("{", "["):
            idx = len(text) - len(stripped)
    if idx is not None:
        return idx, 0
    return None, held_suffix_len(text, starts)


def detect_tool_call_start(text: str, parser: Optional[str] = None) -> bool:
    """True if `text` contains or could be the beginning of a tool-call
    region (parsers.rs detect_tool_call_start)."""
    idx, held = find_tool_call_start(text, parser)
    return idx is not None or held > 0


def _extract_call(obj: Any, cfg: JsonToolConfig) -> Optional[ToolCallResult]:
    if not isinstance(obj, dict):
        return None
    name = next((obj[k] for k in cfg.name_keys if k in obj), None)
    if not isinstance(name, str):
        # nested {"function": {...}} / {"type":"function","function":{...}}
        inner = obj.get("function")
        if isinstance(inner, dict):
            return _extract_call(inner, cfg)
        return None
    args = next((obj[k] for k in cfg.args_keys if k in obj), {})
    if isinstance(args, str):
        args_str = args
    else:
        args_str = json.dumps(args)
    return ToolCallResult(name=name, arguments=args_str)


def _parse_json_region(region: str, cfg: JsonToolConfig) -> List[ToolCallResult]:
    region = region.strip()
    calls: List[ToolCallResult] = []
    # try whole-region parse first (object or array)
    for candidate in _json_candidates(region):
        try:
            obj = json.loads(candidate)
        except json.JSONDecodeError:
            continue
        objs = obj if isinstance(obj, list) else [obj]
        for o in objs:
            c = _extract_call(o, cfg)
            if c:
                calls.append(c)
        if calls:
            return calls
    return calls


def _json_candidates(region: str) -> List[str]:
    """The region itself, plus `;`-separated chunks (llama3 parallel style)."""
    out = [region]
    if ";" in region:
        out.extend(part for part in region.split(";") if part.strip())
    return out


def _parse_token_delimited(
    text: str, cfg: JsonToolConfig
) -> Tuple[List[ToolCallResult], str]:
    calls: List[ToolCallResult] = []
    content = text
    for start in cfg.start_tokens:
        if start not in content:
            continue
        while start in content:
            pre, rest = content.split(start, 1)
            for end in cfg.end_tokens:
                if end and end in rest:
                    region, rest = rest.split(end, 1)
                    break
            else:
                region, rest = rest, ""
            calls.extend(_parse_json_region(region, cfg))
            content = pre + rest
        if calls:
            return calls, content.strip()
    if cfg.allow_bare_json:
        stripped = text.strip()
        if stripped[:1] in ("{", "["):
            calls = _parse_json_region(stripped, cfg)
            if calls:
                return calls, ""
    return [], text


def _parse_pythonic(text: str) -> Tuple[List[ToolCallResult], str]:
    """`[get_weather(city="SF"), f2(x=1)]` (pythonic/ in the reference)."""
    stripped = text.strip()
    m = re.search(r"\[.*\]", stripped, re.DOTALL)
    if not m:
        return [], text
    try:
        tree = ast.parse(m.group(0), mode="eval")
    except SyntaxError:
        return [], text
    if not isinstance(tree.body, ast.List):
        return [], text
    calls: List[ToolCallResult] = []
    for el in tree.body.elts:
        if not isinstance(el, ast.Call):
            return [], text
        if isinstance(el.func, ast.Name):
            name = el.func.id
        elif isinstance(el.func, ast.Attribute):
            name = el.func.attr
        else:
            return [], text
        args: Dict[str, Any] = {}
        try:
            for kw in el.keywords:
                args[kw.arg] = ast.literal_eval(kw.value)
        except (ValueError, SyntaxError):
            return [], text
        calls.append(ToolCallResult(name=name, arguments=json.dumps(args)))
    content = (stripped[: m.start()] + stripped[m.end():]).strip()
    return calls, content


_HARMONY_CALL = re.compile(
    r"<\|channel\|>commentary\s+to=(?:functions\.)?([\w.\-]+)"
    r".*?<\|message\|>(.*?)(?:<\|call\|>|$)",
    re.DOTALL,
)
_HARMONY_FINAL = re.compile(
    r"<\|channel\|>final<\|message\|>(.*?)(?:<\|end\|>|<\|return\|>|$)", re.DOTALL
)


def _parse_harmony(text: str) -> Tuple[List[ToolCallResult], str]:
    """GPT-OSS harmony channel format (harmony/ in the reference):
    `<|channel|>commentary to=functions.NAME ...<|message|>{args}<|call|>`."""
    calls = [
        ToolCallResult(name=m.group(1), arguments=m.group(2).strip())
        for m in _HARMONY_CALL.finditer(text)
    ]
    final = _HARMONY_FINAL.search(text)
    content = final.group(1).strip() if final else ""
    if not calls and not final:
        return [], text
    return calls, content


def try_tool_call_parse(
    text: str, parser: Optional[str] = None
) -> Tuple[List[ToolCallResult], str]:
    """Parse complete model output; returns (tool_calls, remaining_content).
    Unparseable input comes back as ([], text) — never raises."""
    parser = parser or "default"
    if parser == "pythonic":
        return _parse_pythonic(text)
    if parser == "harmony":
        return _parse_harmony(text)
    if parser not in PARSER_CONFIGS:
        raise ValueError(
            f"unknown tool parser {parser!r}; available: {get_available_tool_parsers()}"
        )
    return _parse_token_delimited(text, PARSER_CONFIGS[parser])
