"""Reasoning-content ("thinking") parsers, batch and streaming.

Port of `dynamo_tpu/llm/parsers/reasoning.py`, unchanged.

Role of reference lib/parsers/src/reasoning/ (base_parser.rs tag-pair
parser, granite_parser.rs marker phrases, gpt_oss_parser.rs harmony
analysis channel): split model output into (reasoning_content, content).
Streaming parsers are incremental — feed text deltas, get
(reasoning_delta, content_delta) back, with partial markers held until
disambiguated.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass
class ParsedDelta:
    reasoning: str = ""
    content: str = ""


class BasicReasoningParser:
    """Tag-pair reasoning (`<think> ... </think>`), the reference's
    base_parser.rs with configurable tokens (deepseek-r1, qwen3, nemotron
    families). `starts_inside` models checkpoints that open mid-thought."""

    def __init__(
        self,
        start_token: str = "<think>",
        end_token: str = "</think>",
        starts_inside: bool = False,
    ):
        self.start_token = start_token
        self.end_token = end_token
        self.in_reasoning = starts_inside
        self._buf = ""

    # -- batch --------------------------------------------------------------
    def parse(self, text: str) -> Tuple[str, str]:
        """Complete-output split -> (reasoning, content)."""
        reasoning: list[str] = []
        content: list[str] = []
        rest = text
        inside = self.in_reasoning
        while rest:
            if inside:
                if self.end_token in rest:
                    seg, rest = rest.split(self.end_token, 1)
                    reasoning.append(seg)
                    inside = False
                else:
                    reasoning.append(rest)
                    rest = ""
            else:
                if self.start_token in rest:
                    seg, rest = rest.split(self.start_token, 1)
                    content.append(seg)
                    inside = True
                else:
                    content.append(rest)
                    rest = ""
        return "".join(reasoning).strip(), "".join(content).strip()

    # -- streaming ------------------------------------------------------------
    def _could_be_marker_prefix(self, tail: str) -> int:
        from .tool_calling import held_suffix_len

        return held_suffix_len(tail, (self.start_token, self.end_token))

    def feed(self, delta: str) -> ParsedDelta:
        self._buf += delta
        out = ParsedDelta()
        while True:
            marker = self.end_token if self.in_reasoning else self.start_token
            idx = self._buf.find(marker)
            if idx >= 0:
                seg = self._buf[:idx]
                if self.in_reasoning:
                    out.reasoning += seg
                else:
                    out.content += seg
                self._buf = self._buf[idx + len(marker):]
                self.in_reasoning = not self.in_reasoning
                continue
            hold = self._could_be_marker_prefix(self._buf)
            emit = self._buf[: len(self._buf) - hold]
            self._buf = self._buf[len(self._buf) - hold:]
            if self.in_reasoning:
                out.reasoning += emit
            else:
                out.content += emit
            return out

    def flush(self) -> ParsedDelta:
        out = ParsedDelta()
        if self._buf:
            if self.in_reasoning:
                out.reasoning = self._buf
            else:
                out.content = self._buf
            self._buf = ""
        return out


class GraniteReasoningParser(BasicReasoningParser):
    """IBM Granite phrase markers (reference granite_parser.rs):
    'Here is my thought process:' ... 'Here is my response:'."""

    def __init__(self):
        super().__init__(
            start_token="Here is my thought process:",
            end_token="Here is my response:",
        )


class GptOssReasoningParser(BasicReasoningParser):
    """GPT-OSS harmony channels (reference gpt_oss_parser.rs): the analysis
    channel is reasoning, the final channel is content; channel markers
    never reach the client in either mode."""

    _ANALYSIS = "<|channel|>analysis<|message|>"
    _FINAL = "<|channel|>final<|message|>"
    _ENDS = ("<|end|>", "<|return|>")
    # role headers are stripped, never shown (harmony message framing)
    _ROLES = ("<|start|>assistant", "<|start|>user", "<|start|>system")

    def __init__(self):
        super().__init__(start_token=self._ANALYSIS, end_token="<|end|>")
        self._markers = (self._ANALYSIS, self._FINAL) + self._ENDS + self._ROLES

    # -- streaming: marker-driven channel switch ---------------------------
    def feed(self, delta: str) -> ParsedDelta:
        from .tool_calling import held_suffix_len

        self._buf += delta
        out = ParsedDelta()
        while True:
            hit = None  # (index, marker); at equal index prefer the longest
            for m in self._markers:
                i = self._buf.find(m)
                if i >= 0 and (
                    hit is None or i < hit[0] or (i == hit[0] and len(m) > len(hit[1]))
                ):
                    hit = (i, m)
            if hit is not None:
                i, m = hit
                seg = self._buf[:i]
                if self.in_reasoning:
                    out.reasoning += seg
                else:
                    out.content += seg
                self._buf = self._buf[i + len(m):]
                if m == self._ANALYSIS:
                    self.in_reasoning = True
                elif m == self._FINAL or m in self._ENDS:
                    self.in_reasoning = False
                # role headers: no state change, just stripped
                continue
            hold = held_suffix_len(self._buf, self._markers)
            emit = self._buf[: len(self._buf) - hold]
            self._buf = self._buf[len(self._buf) - hold:]
            if self.in_reasoning:
                out.reasoning += emit
            else:
                out.content += emit
            return out

    def parse(self, text: str) -> Tuple[str, str]:
        reasoning = "".join(
            m.group(1)
            for m in re.finditer(
                r"<\|channel\|>analysis<\|message\|>(.*?)(?:<\|end\|>|$)",
                text,
                re.DOTALL,
            )
        )
        final = re.search(
            r"<\|channel\|>final<\|message\|>(.*?)(?:<\|end\|>|<\|return\|>|$)",
            text,
            re.DOTALL,
        )
        content = final.group(1) if final else ""
        if not reasoning and not final:
            return "", text
        return reasoning.strip(), content.strip()


REASONING_PARSERS = {
    "basic": BasicReasoningParser,
    "deepseek_r1": lambda: BasicReasoningParser(starts_inside=True),
    "granite": GraniteReasoningParser,
    "gpt_oss": GptOssReasoningParser,
}


def get_reasoning_parser(name: Optional[str]) -> Optional[BasicReasoningParser]:
    if name is None:
        return None
    if name not in REASONING_PARSERS:
        raise ValueError(
            f"unknown reasoning parser {name!r}; available: {sorted(REASONING_PARSERS)}"
        )
    return REASONING_PARSERS[name]()
