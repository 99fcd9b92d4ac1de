"""Engine-facing wire protocol types (the OpenAI request/response types of
the reference's `llm/protocols/openai.py` belong to the frontend slice)."""

from .common import (
    Annotated,
    FinishReason,
    LLMEngineOutput,
    PreprocessedRequest,
    SamplingOptions,
    StopConditions,
)

__all__ = [
    "Annotated",
    "FinishReason",
    "LLMEngineOutput",
    "PreprocessedRequest",
    "SamplingOptions",
    "StopConditions",
]
