"""The port's OpenAI HTTP service (`dynamo_tpu/llm/http/`)."""

from .service import HttpService

__all__ = ["HttpService"]
