"""KV page store: allocation, per-layer views and page writes.

Port of the full-precision path of `dynamo_tpu/ops/kv_quant.py`
(`alloc_kv_store`, `kv_layer`, `kv_page_size`, `kv_write`). The int8/int4
quantize-on-write path and the in-kernel dequant are not ported yet;
asking for them raises.

Unlike the reference's functional scatter, `kv_write` updates the store IN
PLACE (`index_put_`) and returns the same tensor, so the pool is never
copied. Physical page 0 is the engine's scratch page: callers route
padding tokens, inactive lanes and positions past the page table there.
"""

from __future__ import annotations

import torch

KV_QUANT_MODES = ("none", "int8", "int4")


def resolve_kv_quant(mode) -> str:
    """Normalise the configured KV format; only "none" is supported."""
    mode = (mode or "none").strip().lower()
    if mode not in KV_QUANT_MODES:
        raise ValueError(f"unknown kv_quant mode {mode!r} (want one of {KV_QUANT_MODES})")
    if mode != "none":
        raise NotImplementedError(
            f"kv_quant={mode!r}: the quantized KV cache is not ported yet"
        )
    return mode


def alloc_kv_store(num_layers: int, num_pages: int, page_size: int,
                   num_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   mode: str = "none", device="cuda") -> torch.Tensor:
    """One zeroed KV store (K or V): [L, pages, page_size, KH, D]."""
    resolve_kv_quant(mode)
    return torch.zeros(
        (num_layers, num_pages, page_size, num_kv_heads, head_dim),
        dtype=dtype, device=device,
    )


def kv_page_size(store: torch.Tensor) -> int:
    """Tokens per page of a KV store."""
    return store.shape[2]


def kv_layer(store: torch.Tensor, li: int) -> torch.Tensor:
    """Per-layer view [pages, page_size, KH, D] for the attention ops."""
    return store[li]


def kv_write(store: torch.Tensor, li: int, phys: torch.Tensor,
             offs: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Write `vals` [..., KH, D] at (li, phys[...], offs[...]) in place —
    the one KV page-write spelling for every model forward. Returns the
    store (the same tensor) so call sites read like the reference's."""
    if phys.dtype != torch.int64:
        phys, offs = phys.long(), offs.long()
    store[li].index_put_((phys, offs), vals.to(store.dtype))
    return store
