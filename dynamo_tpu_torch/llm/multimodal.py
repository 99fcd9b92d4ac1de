"""Multimodal E/P/D support: the encode hop.

Port of `dynamo_tpu/llm/multimodal.py`. An ENCODE worker turns image
content parts into embedding rows; the processor appends placeholder
tokens to the prompt for each part; the prefill engine replaces the
placeholders' embedding rows with the encoder's (the `emb_override`
operand of `models/llama.prefill_forward_batched`); decode proceeds as for
any request.

  * Two encoders behind the same endpoint: `ViTEncoder`, a ViT
    (models/vit.py, HF-checkpoint loadable) with a LLaVA-style projector,
    run on the card, and `MockVisionEncoder`, a deterministic content-hash
    projection the tests use. `encode_parts` takes either.
  * Placeholder token ids are CONTENT-DERIVED pseudo-tokens: two
    different images give different placeholder ids, so KV block hashes
    (the KV router's prefix scoring, the engine's prefix cache) tell
    images apart, while the same image reuses cached KV.
  * Images are decoded by `llm/image_io.py` (PNG on the standard library;
    other formats are refused), where the reference uses PIL.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import logging
from dataclasses import replace
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..runtime import StreamLost
from .image_io import load_rgb

logger = logging.getLogger(__name__)

__all__ = [
    "EncodeOperator",
    "MockVisionEncoder",
    "ViTEncoder",
    "encode_parts",
    "part_content_key",
    "placeholder_tokens",
    "splice_placeholders",
]

DEFAULT_MM_TOKENS = 4


def part_content_key(part: Dict[str, Any]) -> bytes:
    """Stable identity of a content part (url or inline payload)."""
    ident = part.get("url") or part.get("data") or part.get("input_audio") or ""
    return hashlib.sha256(
        f"{part.get('type')}:{ident}".encode("utf-8", "replace")
    ).digest()


class MockVisionEncoder:
    """Deterministic stand-in encoder: the content hash seeds a fixed random
    projection to [n_tokens, hidden]. The same image gives the same
    embeddings on every host (no weights to distribute)."""

    def __init__(self, hidden_size: int, n_tokens: int = DEFAULT_MM_TOKENS):
        self.hidden_size = hidden_size
        self.n_tokens = n_tokens

    def encode(self, part: Dict[str, Any]) -> np.ndarray:
        seed = int.from_bytes(part_content_key(part)[:4], "little")
        rng = np.random.RandomState(seed)
        # small magnitude: comparable to embedding-table rows, so the splice
        # does not blow out activation scales
        return (rng.randn(self.n_tokens, self.hidden_size) * 0.02).astype(np.float32)


class ViTEncoder:
    """The vision encoder (models/vit.py): image content part -> ViT ->
    LLaVA-style projector -> [n_patches, llm_hidden] rows for the engine's
    splice. Accepts data: URLs, inline base64 payloads, or raw pixel arrays;
    plain http(s) URLs are refused (a deployment without egress must not
    hang on a fetch).

    `device` (default cuda) holds the weights and runs the forward; with no
    CUDA device it raises unless the caller asks for the CPU. Without
    `params` or `checkpoint` the weights are `vit.init_params` drawn from a
    CPU `torch.Generator` seeded with `seed` (0), so every device and
    process gets the same encoder. The forward is a plain call under
    `torch.inference_mode()`, in f32 with TF32 off on the card."""

    def __init__(self, config=None, params=None, llm_hidden: int = None,
                 checkpoint: str = None, device="cuda", seed: int = 0):
        from ..models import vit

        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ViTEncoder(device='cuda') needs a CUDA device and none is present; "
                    "pass device='cpu' to run on the CPU")
            if torch.get_float32_matmul_precision() != "highest":
                raise RuntimeError(
                    "the ViT encoder's f32 products need TF32 off "
                    "(torch.set_float32_matmul_precision('highest'))")
        if config is None:
            config = vit.ViTConfig.tiny(out_hidden=llm_hidden or vit.ViTConfig.tiny().out_hidden)
        elif llm_hidden and config.out_hidden != llm_hidden:
            config = replace(config, out_hidden=llm_hidden)
        self.config = config
        if params is None:
            if checkpoint:
                params = vit.load_vit_params(checkpoint, config, device=self.device)
            else:
                params = vit.init_params(config, torch.Generator().manual_seed(seed),
                                         device=self.device)
        self.params = params
        self.hidden_size = config.out_hidden
        self.n_tokens = config.n_patches
        self._vit = vit

    @torch.inference_mode()
    def _fwd(self, px: torch.Tensor) -> torch.Tensor:
        return self._vit.encode_tokens(self.params, self.config, px)

    def _pixels(self, part: Dict[str, Any]) -> np.ndarray:
        """Content part -> normalized [C, H, W] float32 (HF layout, mean and
        std 0.5: the ViTImageProcessor default)."""
        c = self.config
        raw = part.get("pixels")
        if raw is not None:
            arr = np.asarray(raw, np.float32)
            if arr.shape != (c.num_channels, c.image_size, c.image_size):
                raise ValueError(
                    f"pixels shape {arr.shape} != "
                    f"[{c.num_channels}, {c.image_size}, {c.image_size}]"
                )
            return arr
        url = part.get("url") or ""
        data = part.get("data")
        if url.startswith("data:"):
            b64 = url.split(",", 1)[1] if "," in url else ""
            data = base64.b64decode(b64)
        elif isinstance(data, str):
            data = base64.b64decode(data)
        if not data:
            raise ValueError(
                "image part carries no decodable payload (data: URL, "
                "inline base64 `data`, or `pixels`); remote fetch is "
                "disabled on zero-egress deployments"
            )
        arr = load_rgb(data, c.image_size).astype(np.float32) / 255.0  # [H, W, C]
        arr = (arr - 0.5) / 0.5
        return arr.transpose(2, 0, 1)

    def encode(self, part: Dict[str, Any]) -> np.ndarray:
        px = torch.from_numpy(np.ascontiguousarray(self._pixels(part)[None])).to(self.device)
        return self._fwd(px)[0].float().cpu().numpy()


def placeholder_tokens(part: Dict[str, Any], n_tokens: int, vocab_size: int) -> List[int]:
    """Content-derived pseudo-token ids for one part (see the module
    docstring). Ids land in [2, vocab) to dodge special tokens at 0/1."""
    key = part_content_key(part)
    stretched = hashlib.sha256(key + b"tokens").digest()
    span = max(vocab_size - 2, 1)
    return [
        2 + int.from_bytes(stretched[(2 * i) % 30 : (2 * i) % 30 + 2], "little") % span
        for i in range(n_tokens)
    ]


def splice_placeholders(
    token_ids: List[int],
    parts: List[Dict[str, Any]],
    n_tokens: int,
    vocab_size: int,
) -> Tuple[List[int], List[Dict[str, Any]]]:
    """Append each part's placeholder span to the prompt and record its
    position on the part (the chat template flattens text parts, so parts
    anchor after the rendered prompt, in request order)."""
    out = list(token_ids)
    stamped = []
    for part in parts:
        p = dict(part)
        p["position"] = len(out)
        p["n_tokens"] = n_tokens
        out.extend(placeholder_tokens(part, n_tokens, vocab_size))
        stamped.append(p)
    return out, stamped


def encode_parts(parts: List[Dict[str, Any]], encoder) -> List[Dict[str, Any]]:
    """Worker side: attach embeddings to each part (wire format: nested
    lists of floats, msgpack-clean; the engine turns them back into
    arrays)."""
    out = []
    for part in parts:
        p = dict(part)
        p["embedding"] = encoder.encode(part).tolist()
        p["n_tokens"] = encoder.n_tokens
        out.append(p)
    return out


class EncodeOperator:
    """Pipeline forward hop: the processor side of E/P/D. For requests
    carrying multimodal parts, calls the encode worker, then splices
    placeholder tokens + embeddings into the request BEFORE the router hop,
    so KV-aware routing and the engine's prefix cache see the
    content-derived placeholder ids."""

    def __init__(self, router, vocab_size: int, max_attempts: int = 3,
                 retry_delay_s: float = 2.0):
        self.router = router  # PushRouter over the encode endpoint
        self.vocab_size = vocab_size
        self.max_attempts = max_attempts
        self.retry_delay_s = retry_delay_s

    @property
    def name(self) -> str:
        return "Encode"

    async def forward(self, request: Any, context) -> Any:
        is_dict = isinstance(request, dict)
        mm = request.get("multimodal") if is_dict else request.multimodal
        if not mm:
            return request
        if all(p.get("embedding") is not None and p.get("position") is not None
               for p in mm):
            return request  # already encoded (disagg / migration re-entry)
        encoded, n_tokens = None, DEFAULT_MM_TOKENS
        # the engine hop gets retries from the Migration operator; the
        # encode hop sits ABOVE it, so a restarting encode pool (a brief
        # zero-instance window) must be ridden out here
        last_exc: Exception | None = None
        for attempt in range(self.max_attempts):
            if attempt:
                await asyncio.sleep(self.retry_delay_s)
                # a cancelled or killed request must not keep hammering a
                # recovering encode pool (llm/migration.py's guard)
                if context is not None and (context.is_stopped() or context.is_killed()):
                    raise last_exc
            try:
                stream = await self.router.generate({"multimodal": list(mm)}, context)
                async for item in stream:
                    d = item.get("data") if isinstance(item, dict) else None
                    if d and "multimodal" in d:
                        encoded = d["multimodal"]
                        n_tokens = int(d.get("n_tokens") or n_tokens)
                last_exc = None
                break
            except StreamLost as e:
                last_exc = e
                logger.warning("encode hop attempt %d/%d failed: %s",
                               attempt + 1, self.max_attempts, e)
        if last_exc is not None:
            raise last_exc
        if encoded is None:
            raise RuntimeError("encode worker returned no embeddings")
        token_ids = request["token_ids"] if is_dict else request.token_ids
        new_ids, stamped = splice_placeholders(token_ids, encoded, n_tokens, self.vocab_size)
        if is_dict:
            request = dict(request, token_ids=new_ids, multimodal=stamped)
        else:
            request.token_ids = new_ids
            request.multimodal = stamped
        return request

    # Operator protocol: pass-through backward, no around
    def backward(self, stream, request, context):
        return stream

    def around(self, next_engine, request, context):
        return None
