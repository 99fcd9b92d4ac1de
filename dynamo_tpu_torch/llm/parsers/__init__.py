"""Model-output parsers: tool calls + reasoning content + jailed stream.

Port of `dynamo_tpu/llm/parsers/`, unchanged (standard library only).

Role of the reference's lib/parsers crate (tool_calling/parsers.rs,
reasoning/mod.rs) and the JailedStream operator
(lib/llm/src/protocols/openai/chat_completions/jail.rs): per-model-family
extraction of structured tool calls and reasoning ("thinking") segments
from generated text, both batch and streaming.
"""

from .jail import JailedStream
from .reasoning import (
    BasicReasoningParser,
    GptOssReasoningParser,
    GraniteReasoningParser,
    get_reasoning_parser,
)
from .tool_calling import (
    ToolCallResult,
    detect_tool_call_start,
    get_available_tool_parsers,
    try_tool_call_parse,
)

__all__ = [
    "BasicReasoningParser",
    "GptOssReasoningParser",
    "GraniteReasoningParser",
    "JailedStream",
    "ToolCallResult",
    "detect_tool_call_start",
    "get_available_tool_parsers",
    "get_reasoning_parser",
    "try_tool_call_parse",
]
