"""Wire protocols for the LLM serving pipeline.

Port of `dynamo_tpu/llm/protocols/`: the OpenAI request/response types
(chat, completions, embeddings; standard-library classes in place of
pydantic), the engine-facing PreprocessedRequest / LLMEngineOutput pair and
the Annotated<T> SSE event wrapper.
"""

from .openai import (
    ChatCompletionChunk,
    ChatCompletionRequest,
    ChatCompletionResponse,
    ChatMessage,
    Choice,
    ChoiceDelta,
    CompletionChoice,
    CompletionChunk,
    CompletionRequest,
    CompletionResponse,
    EmbeddingRequest,
    EmbeddingResponse,
    ModelInfo,
    ModelList,
    NvExt,
    Usage,
)
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
    "ChatCompletionChunk",
    "ChatCompletionRequest",
    "ChatCompletionResponse",
    "ChatMessage",
    "Choice",
    "ChoiceDelta",
    "CompletionChoice",
    "CompletionChunk",
    "CompletionRequest",
    "CompletionResponse",
    "EmbeddingRequest",
    "EmbeddingResponse",
    "FinishReason",
    "LLMEngineOutput",
    "ModelInfo",
    "ModelList",
    "NvExt",
    "PreprocessedRequest",
    "SamplingOptions",
    "StopConditions",
    "Usage",
]
