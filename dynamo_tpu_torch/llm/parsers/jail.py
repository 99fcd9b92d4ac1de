"""JailedStream: hold structured-output tokens out of the delta stream.

Port of `dynamo_tpu/llm/parsers/jail.py`, unchanged.

Role of the reference's jail operator
(lib/llm/src/protocols/openai/chat_completions/jail.rs, see
JAILED_STREAM_README.md): while the model is emitting a tool call (or
reasoning span), the raw text must NOT stream to the client as content —
it is accumulated ("jailed"), parsed when the span completes or the stream
ends, and released as structured `tool_calls` / `reasoning_content` fields
on the output.

Wraps an async iterator of Annotated[LLMEngineOutput]; text deltas are
routed through the reasoning parser first (incremental), then watched for
tool-call starts. Non-text emissions (annotations, errors, finish) pass
through.
"""

from __future__ import annotations

import dataclasses
from typing import AsyncIterator, List, Optional

import logging

from ..protocols.common import Annotated, LLMEngineOutput
from .reasoning import get_reasoning_parser
from .tool_calling import (
    ToolCallResult,
    find_tool_call_start,
    try_tool_call_parse,
)

logger = logging.getLogger(__name__)


class JailedStream:
    def __init__(
        self,
        stream: AsyncIterator[Annotated],
        tool_parser: Optional[str] = None,
        reasoning_parser: Optional[str] = None,
    ):
        self.stream = stream
        self.tool_parser = tool_parser
        if tool_parser is not None:
            try:
                find_tool_call_start("", tool_parser)
            except ValueError:
                # a typo'd model card must not abort live SSE streams —
                # degrade to plain text and say so
                logger.error("unknown tool parser %r; tool parsing disabled",
                             tool_parser)
                self.tool_parser = None
        try:
            self.reasoning = get_reasoning_parser(reasoning_parser)
        except ValueError:
            logger.error("unknown reasoning parser %r; reasoning parsing disabled",
                         reasoning_parser)
            self.reasoning = None
        self._jailed: List[str] = []
        self._jailing = False
        self._pending = ""  # tail that may be a split start marker
        self._released_any = False  # past message start: bare-JSON is content

    def _route_text(self, text: str) -> tuple[str, str]:
        """-> (reasoning_delta, content_delta) after the reasoning parser."""
        if self.reasoning is None:
            return "", text
        d = self.reasoning.feed(text)
        return d.reasoning, d.content

    def _check_jail(self, content: str) -> str:
        """Returns content safe to release now; jails the rest (including a
        trailing partial start marker, held in _pending)."""
        if self.tool_parser is None:
            return content
        if self._jailing:
            self._jailed.append(content)
            return ""
        text = self._pending + content
        self._pending = ""
        if not text:
            return ""
        idx, held = find_tool_call_start(
            text, self.tool_parser, allow_bare=not self._released_any
        )
        if idx is not None:
            self._jailing = True
            self._jailed.append(text[idx:])
            safe = text[:idx]
        elif held:
            self._pending = text[-held:]
            safe = text[:-held]
        else:
            safe = text
        if safe.strip():
            self._released_any = True
        return safe

    def _release(self) -> tuple[List[dict], str]:
        """Parse jailed text -> (tool_call dicts, leftover content)."""
        if not self._jailed:
            return [], ""
        text = "".join(self._jailed)
        self._jailed = []
        self._jailing = False
        calls, content = try_tool_call_parse(text, self.tool_parser)
        return (
            [
                {
                    "id": c.id,
                    "type": "function",
                    "function": {"name": c.name, "arguments": c.arguments},
                }
                for c in calls
            ],
            content,
        )

    def _drain(self) -> tuple[str, str, List[dict]]:
        """Release everything still held — reasoning tail, pending marker
        prefix, jailed tool-call text. -> (content, reasoning, tool_calls).
        Used by both the finish tick and the end-of-stream fallback."""
        content = ""
        reasoning = ""
        if self.reasoning is not None:
            tail = self.reasoning.flush()
            reasoning = tail.reasoning
            content += self._check_jail(tail.content)
        content += self._pending
        self._pending = ""
        calls, leftover = self._release()
        return content + leftover, reasoning, calls

    def _flush_end_of_stream(self) -> Optional[LLMEngineOutput]:
        """The stream ended without a finish tick: release held state."""
        content, reasoning, calls = self._drain()
        if not (content or reasoning or calls):
            return None
        return LLMEngineOutput(
            text=content or None,
            reasoning_content=reasoning or None,
            tool_calls=calls or None,
            finish_reason="tool_calls" if calls else None,
        )

    async def __aiter__(self):
        saw_finish = False
        async for ann in self.stream:
            if ann.data is None or ann.event is not None or ann.is_error():
                yield ann
                continue
            out: LLMEngineOutput = ann.data
            if out.text is None and not out.finish_reason:
                yield ann
                continue

            reasoning_delta, content = ("", "")
            if out.text:
                reasoning_delta, content = self._route_text(out.text)
            content = self._check_jail(content)

            if out.finish_reason:
                saw_finish = True
                d_content, d_reasoning, calls = self._drain()
                new = dataclasses.replace(
                    out,
                    text=(content + d_content) or None,
                    reasoning_content=(reasoning_delta + d_reasoning) or None,
                    tool_calls=calls or None,
                    finish_reason="tool_calls" if calls else out.finish_reason,
                )
                yield dataclasses.replace(ann, data=new)
                continue

            # always emit ticks that carry token_ids — downstream usage and
            # ITL accounting must see every token even when its text is jailed
            new = dataclasses.replace(
                out,
                text=content or None,
                reasoning_content=reasoning_delta or None,
            )
            if new.token_ids or new.text or new.reasoning_content:
                yield dataclasses.replace(ann, data=new)

        if not saw_finish:
            final = self._flush_end_of_stream()
            if final is not None:
                yield Annotated(data=final)
