"""ModelDeploymentCard (MDC) — what a model IS for the serving plane.

Port of `dynamo_tpu/llm/model_card.py`: the same fields in the same order,
so a card serializes to the same JSON bytes and a reference frontend's
ModelWatcher reads a port worker's card. Mirrors reference
lib/llm/src/model_card.rs:93: name, tokenizer, prompt
formatter/chat template, context length, kv block size, migration limit,
runtime config. Cards are published to discovery under `v1/mdc/...` by
workers (`register_llm`) and watched by frontends (ModelWatcher).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ..runtime.component import MODEL_ROOT, Endpoint


class ModelInput:
    TOKENS = "tokens"  # worker takes PreprocessedRequest (frontend tokenizes)
    TEXT = "text"  # worker takes raw OpenAI request


class ModelType:
    CHAT = "chat"
    COMPLETIONS = "completions"
    EMBEDDINGS = "embeddings"
    CHAT_AND_COMPLETIONS = "chat+completions"


@dataclass
class ModelDeploymentCard:
    """Reference model_card.rs:93 — stored as JSON in discovery."""

    name: str
    tokenizer: str = "byte"  # spec for tokenizers.load_tokenizer
    model_input: str = ModelInput.TOKENS
    model_type: str = ModelType.CHAT_AND_COMPLETIONS
    context_length: int = 8192
    kv_cache_block_size: int = 64
    migration_limit: int = 3
    chat_template: Optional[str] = None  # jinja2 source; None = default
    runtime_config: Dict[str, Any] = field(default_factory=dict)
    checksum: Optional[str] = None
    # LoRA adapters this worker serves (select via nvext.lora_name;
    # reference lora_id in kv_router/protocols.rs:110-115)
    lora_adapters: List[str] = field(default_factory=list)

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "ModelDeploymentCard":
        d = json.loads(raw)
        known = cls.__dataclass_fields__.keys()
        return cls(**{k: v for k, v in d.items() if k in known})

    def slug(self) -> str:
        return self.name.replace("/", "--")


def card_tokenizer(gguf_path: Optional[str] = None) -> str:
    """The tokenizer spec a worker's card advertises: a GGUF checkpoint's
    embedded vocabulary, else the byte tokenizer. It is the serving
    contract: the frontend tokenizes with it and the engine's ids must
    mean the same text."""
    return f"gguf:{gguf_path}" if gguf_path is not None else "byte"


def mdc_key(endpoint: Endpoint, card: ModelDeploymentCard) -> str:
    """Discovery key for a card published by an endpoint's worker
    (reference MODEL_ROOT_PATH v1/mdc/).

    The key is PER-INSTANCE: without the instance-id suffix, N replicas of
    the same model share one key whose lease belongs to whichever replica
    registered LAST — when that replica drains (planner scale-down kills
    newest-first), its lease revoke deletes the shared card and the
    frontend 404s the model while live replicas still serve it. With
    per-instance keys the ModelWatcher's existing refcount keeps the model
    up until the LAST replica leaves."""
    return (
        f"{MODEL_ROOT}{endpoint.component.namespace}/"
        f"{endpoint.component.name}/{endpoint.name}/{card.slug()}/"
        f"{endpoint.drt.instance_id:x}"
    )


async def register_llm(
    endpoint: Endpoint,
    card: ModelDeploymentCard,
) -> str:
    """Publish the model card under the worker's primary lease
    (reference register_llm bindings lib.rs:211). Returns the key."""
    drt = endpoint.drt
    key = mdc_key(endpoint, card)
    payload = dict(json.loads(card.to_json()))
    payload["endpoint"] = {
        "namespace": endpoint.component.namespace,
        "component": endpoint.component.name,
        "endpoint": endpoint.name,
        "instance_id": drt.instance_id,
    }
    await drt.put_leased(key, json.dumps(payload).encode())
    return key
