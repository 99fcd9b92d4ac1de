"""Structured logging + W3C trace-context propagation.

Port of `dynamo_tpu/runtime/logging.py`, unchanged.

Mirrors reference lib/runtime/src/logging.rs: env-filtered subscriber
(`DYN_LOG`, like RUST_LOG), optional JSON line output (`DYN_LOGGING_JSONL`),
and `traceparent` propagation across process hops
(DistributedTraceContext logging.rs:138, parse_traceparent :168).
"""

from __future__ import annotations

import contextvars
import dataclasses
import json
import logging
import os
import secrets
import sys
import time
from typing import Optional

_TRACE_CTX: contextvars.ContextVar[Optional["DistributedTraceContext"]] = (
    contextvars.ContextVar("dyn_trace_ctx", default=None)
)


@dataclasses.dataclass(frozen=True)
class DistributedTraceContext:
    """W3C trace-context carried across NATS/TCP hops (reference logging.rs:138)."""

    trace_id: str  # 32 hex chars
    span_id: str  # 16 hex chars
    flags: str = "01"

    def traceparent(self) -> str:
        return f"00-{self.trace_id}-{self.span_id}-{self.flags}"

    def child(self) -> "DistributedTraceContext":
        return DistributedTraceContext(self.trace_id, secrets.token_hex(8), self.flags)

    @classmethod
    def new_root(cls) -> "DistributedTraceContext":
        return cls(secrets.token_hex(16), secrets.token_hex(8))


def parse_traceparent(header: str) -> Optional[DistributedTraceContext]:
    """Parse `00-<trace_id>-<span_id>-<flags>` (reference logging.rs:168)."""
    parts = header.strip().split("-")
    if len(parts) != 4 or parts[0] != "00":
        return None
    _, trace_id, span_id, flags = parts
    if len(trace_id) != 32 or len(span_id) != 16:
        return None
    try:
        int(trace_id, 16), int(span_id, 16)
    except ValueError:
        return None
    return DistributedTraceContext(trace_id, span_id, flags)


def current_trace() -> Optional[DistributedTraceContext]:
    return _TRACE_CTX.get()


def set_trace(ctx: Optional[DistributedTraceContext]):
    _TRACE_CTX.set(ctx)


class _JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        entry = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S", time.gmtime(record.created))
            + f".{int(record.msecs):03d}Z",
            "level": record.levelname,
            "target": record.name,
            "message": record.getMessage(),
        }
        trace = current_trace()
        if trace is not None:
            entry["trace_id"] = trace.trace_id
            entry["span_id"] = trace.span_id
        if record.exc_info:
            entry["exception"] = self.formatException(record.exc_info)
        return json.dumps(entry)


class _TextFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        base = super().format(record)
        trace = current_trace()
        if trace is not None:
            base += f" trace_id={trace.trace_id[:8]}"
        return base


_INITIALIZED = False


def init_logging(level: Optional[str] = None, jsonl: Optional[bool] = None):
    """Install the root handler once. `DYN_LOG` sets the filter (like RUST_LOG);
    `DYN_LOGGING_JSONL=1` switches to JSON-lines output."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    _INITIALIZED = True
    level = level or os.environ.get("DYN_LOG", "info")
    if jsonl is None:
        from .config import env_bool

        jsonl = env_bool("DYN_LOGGING_JSONL")
    handler = logging.StreamHandler(sys.stderr)
    if jsonl:
        handler.setFormatter(_JsonFormatter())
    else:
        handler.setFormatter(
            _TextFormatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s")
        )
    root = logging.getLogger()
    root.addHandler(handler)
    base_level = level.split(",")[0].strip().upper()
    try:
        root.setLevel(base_level)
    except ValueError:
        root.setLevel(logging.INFO)
    # per-target directives: "info,dynamo_tpu.runtime=debug"
    for directive in level.split(",")[1:]:
        if "=" in directive:
            target, lvl = directive.split("=", 1)
            logging.getLogger(target.strip()).setLevel(lvl.strip().upper())
