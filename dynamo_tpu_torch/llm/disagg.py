"""Disaggregated prefill/decode serving: the routing decision and the inline
KV payload.

Port of `dynamo_tpu/llm/disagg.py`. The DECODE worker orchestrates: it
decides per request whether to prefill remotely (conditional
disaggregation, `DisaggregatedRouter.prefill_remote`), calls a prefill
worker with max_tokens=1 and disagg params, and continues decoding from the
transferred KV (`worker/disagg_handler.py`). The KV rides the data plane
(`llm/kv_transfer.py`) as a descriptor; a prefill worker without a data
plane answers inline instead, with the payload of `pack_kv_payload` on the
response stream.

The payload's dtype names are the reference's (numpy's names, "bfloat16"
as `ml_dtypes` spells it); bf16 pages are read here without `ml_dtypes`,
through the wire dtype table of `llm/kv_transfer.py`.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from .kv_transfer import host_bytes, dtype_name, tensor_from_bytes

logger = logging.getLogger(__name__)


@dataclass
class DisaggConfig:
    """Conditional-disagg thresholds (the reference's field names and
    defaults)."""

    enabled: bool = True
    # remote prefill iff (prompt_len - prefix_hit_tokens) > threshold
    remote_prefill_threshold_tokens: int = 64
    # skip remote if the prefill pool is this backed up
    max_prefill_queue: int = 64
    # a published queue depth older than this is unknown, not gospel
    queue_depth_ttl_s: float = 5.0
    # prompts with at most this many uncached tokens never go remote on the
    # TTFT estimate (the KV transfer would cost more than the prefill)
    min_remote_tokens: int = 16
    # offload when the estimated LOCAL prefill wait exceeds this fraction
    # of the TTFT target
    ttft_headroom: float = 0.5


class DisaggregatedRouter:
    """Decide local vs remote prefill from the prefill pool's published
    queue depth (with a staleness TTL), the static token threshold and,
    when the caller passes one, the local engine's estimated prefill wait
    (`TorchEngine.estimated_prefill_wait_ms`): a prompt under the threshold
    still goes remote when the local queue would spend the TTFT budget."""

    def __init__(self, config: Optional[DisaggConfig] = None):
        self.config = config or DisaggConfig()
        self.prefill_queue_depth = 0  # updated from prefill worker metrics
        self._depth_at: Optional[float] = None  # monotonic publish time

    def update_queue_depth(self, depth: int, now: Optional[float] = None):
        self.prefill_queue_depth = depth
        self._depth_at = time.monotonic() if now is None else now

    def queue_depth_known(self, now: Optional[float] = None) -> bool:
        """True while the last published depth is fresh enough to act on."""
        if self._depth_at is None:
            return False
        now = time.monotonic() if now is None else now
        return (now - self._depth_at) <= self.config.queue_depth_ttl_s

    def invalidate(self, reason: str = "") -> None:
        """Forget the published queue depth now (the prefill instance set
        changed: a departed worker's depth says nothing about the rest)."""
        self.prefill_queue_depth = 0
        self._depth_at = None
        if reason:
            logger.info("disagg: prefill queue depth invalidated (%s)", reason)

    def prefill_remote(
        self,
        prompt_len: int,
        prefix_hit_tokens: int,
        have_prefill_workers: bool,
        *,
        local_ttft_est_ms: Optional[float] = None,
        ttft_target_ms: Optional[float] = None,
        now: Optional[float] = None,
    ) -> bool:
        if not self.config.enabled or not have_prefill_workers:
            return False
        if self.queue_depth_known(now) and (
            self.prefill_queue_depth > self.config.max_prefill_queue
        ):
            return False
        uncached = prompt_len - prefix_hit_tokens
        if local_ttft_est_ms is not None and ttft_target_ms:
            # the TTFT trigger: a tiny remainder stays local, a queue that
            # would spend the budget sends the prompt remote; otherwise the
            # static threshold decides
            if uncached <= self.config.min_remote_tokens:
                return False
            if local_ttft_est_ms > self.config.ttft_headroom * ttft_target_ms:
                return True
        return uncached > self.config.remote_prefill_threshold_tokens


# ---------------------------------------------------------------------- #
# inline KV payload (a prefill worker without a data plane)
# ---------------------------------------------------------------------- #


def pack_kv_payload(
    kv_k: torch.Tensor, kv_v: torch.Tensor, n_tokens: int, page_size: int,
    kv_format: str = "none",
) -> Dict[str, Any]:
    """Serialize extracted host pages for the response stream: raw bytes +
    shape/dtype header. fp pages are [L, n_pages, page_size, KH, D]; a
    quantized pool's pages are the packed uint8 [L, n_pages, PAGE_BYTES]
    rows, and `kv_format` names the layout so the decode side verifies it
    before injecting."""
    name = dtype_name(kv_k.dtype)
    return {
        "k": bytes(host_bytes(kv_k, name)),
        "v": bytes(host_bytes(kv_v, name)),
        "shape": list(kv_k.shape),
        "dtype": name,
        "fmt": str(kv_format),
        "n_tokens": n_tokens,
        "page_size": page_size,
    }


def unpack_kv_payload(payload: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor, int]:
    shape = tuple(payload["shape"])
    kv_k = tensor_from_bytes(payload["k"], payload["dtype"], shape)
    kv_v = tensor_from_bytes(payload["v"], payload["dtype"], shape)
    return kv_k, kv_v, int(payload["n_tokens"])
