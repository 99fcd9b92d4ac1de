"""Paged attention ops: dispatchers and their plain PyTorch versions.

Port of `dynamo_tpu/ops/paged_attention.py`. Each op has a hand-written
Hopper kernel (ops/hopper_*.py) and, beside it, a plain PyTorch version
(`*_plain`: gather the page table, mask, softmax) that repeats the
kernel's arithmetic. The dispatch rule is the tensor's device and nothing
else: a CUDA tensor goes to the kernel (which launches or raises), a CPU
tensor to the plain version. There is no environment knob and no fallback.

Layouts:
  kv_k / kv_v (per layer): [num_pages, page_size, kv_heads, head_dim], or a
      per-layer `QuantKV` (ops/kv_quant.py) whose pages the plain versions
      dequantize through `gather_dequant` and the kernels while staging
  page_table: logical page index -> physical page id
"""

from __future__ import annotations

import torch

from . import (
    hopper_paged_attention,
    hopper_paged_attention_local,
    hopper_prefill_attention,
    hopper_ragged_attention,
)
from .hopper_paged_attention import paged_attention_decode_hopper
from .hopper_paged_attention_local import paged_attention_decode_local_hopper
from .hopper_prefill_attention import prefill_attention_batched_hopper
from .hopper_ragged_attention import ragged_attention_hopper, ragged_tile_q
from .kv_quant import QuantKV, gather_dequant

__all__ = [
    "paged_attention_decode", "paged_attention_decode_plain",
    "paged_attention_decode_mixed", "paged_attention_decode_mixed_plain",
    "prefill_attention", "prefill_attention_plain",
    "prefill_attention_batched", "prefill_attention_batched_plain",
    "ragged_attention", "ragged_attention_plain", "ragged_tile_q",
    "plain_calls", "attention_counts",
]

NEG_INF = -1e30

#: calls of each plain version, so a run on the card can show it made none
plain_calls = {"decode": 0, "decode_mixed": 0, "prefill": 0, "ragged": 0}

_KERNELS = {
    "paged_decode": hopper_paged_attention,
    "paged_decode_local": hopper_paged_attention_local,
    "prefill_attention": hopper_prefill_attention,
    "ragged_attention": hopper_ragged_attention,
}


def attention_counts() -> dict:
    """This process's attention calls so far: kernel launches by
    "kernel/format" (nonzero only) and plain-version calls by op — what a
    worker publishes in its stats, so a run shows which path served it."""
    return {
        "kernels": {f"{name}/{fmt}": n for name, mod in _KERNELS.items()
                    for fmt, n in mod.launches_by_format.items() if n},
        "plain": {op: n for op, n in plain_calls.items() if n},
    }


def _ctx_dtype(layer, q: torch.Tensor) -> torch.dtype:
    """The type the context is read in: the pool's own, or the compute
    type for a quantized pool (dequantized values are cast to q's type)."""
    return q.dtype if isinstance(layer, QuantKV) else layer.dtype


def _gather_ctx(layer, tables: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Per-layer pages gathered by tables [..., P] -> [..., P*ps, KH, D] in
    f32, read in `dtype` (dequantized first for a QuantKV). Page ids are
    clamped to the pool, as the kernels clamp them."""
    num_pages = (layer.q if isinstance(layer, QuantKV) else layer).shape[0]
    pages = gather_dequant(layer, tables.long().clamp(0, num_pages - 1), dtype)
    P, ps, KH, D = pages.shape[-4:]
    return pages.reshape(*tables.shape[:-1], P * ps, KH, D).float()


def _softmax_pv(scores: torch.Tensor, mask: torch.Tensor, ctx_v: torch.Tensor,
                eq: str, kv_dtype: torch.dtype) -> torch.Tensor:
    """Masked f32 softmax, probabilities rounded to the KV dtype (as the
    reference does), then the PV product with f32 accumulation."""
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum(eq, probs.to(kv_dtype).float(), ctx_v)


def paged_attention_decode_plain(
    q: torch.Tensor,  # [B, H, D]
    kv_k_layer: torch.Tensor,  # [pages, page_size, KH, D]
    kv_v_layer: torch.Tensor,
    page_tables: torch.Tensor,  # [B, max_pages]
    seq_lens: torch.Tensor,  # [B] (including current token)
) -> torch.Tensor:
    """Plain one-token decode attention over paged KV. Returns [B, H, D]."""
    plain_calls["decode"] += 1
    B, H, D = q.shape
    dt = _ctx_dtype(kv_k_layer, q)
    ctx_k = _gather_ctx(kv_k_layer, page_tables, dt)  # [B, S, KH, D]
    ctx_v = _gather_ctx(kv_v_layer, page_tables, dt)
    S, KH = ctx_k.shape[1], ctx_k.shape[2]
    G = H // KH
    qg = q.reshape(B, KH, G, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ctx_k) / (D ** 0.5)
    key_pos = torch.arange(S, device=q.device)
    # an empty lane behaves as length 1, as in the kernel
    mask = key_pos[None, :] < seq_lens.clamp(min=1)[:, None]  # [B, S]
    out = _softmax_pv(scores, mask[:, None, None, :], ctx_v, "bkgs,bskd->bkgd", dt)
    return out.reshape(B, H, D).to(q.dtype)


def paged_attention_decode_mixed_plain(
    q: torch.Tensor,  # [B, H, D]
    kv_k_layer,  # [pages, page_size, KH, D] or QuantKV — READ-ONLY pool
    kv_v_layer,
    page_tables: torch.Tensor,  # [B, max_pages]
    pool_lens: torch.Tensor,  # [B] positions valid IN THE POOL
    loc_k: torch.Tensor,  # [B, K, KH, D] block-local keys (compute dtype)
    loc_v: torch.Tensor,
    step_idx: torch.Tensor,  # [1] int32: local entries 0..step_idx are valid
) -> torch.Tensor:
    """Plain decode attention over the pool pages plus the block-local
    buffer: one softmax over both. Pool keys are valid below pool_lens[b]
    (none for a lane with pool length 0, as in the reference's oracle);
    local entries j <= step_idx. Returns [B, H, D]."""
    plain_calls["decode_mixed"] += 1
    B, H, D = q.shape
    dt = _ctx_dtype(kv_k_layer, q)
    ctx_k = _gather_ctx(kv_k_layer, page_tables, dt)  # [B, S, KH, D]
    ctx_v = _gather_ctx(kv_v_layer, page_tables, dt)
    S, KH = ctx_k.shape[1], ctx_k.shape[2]
    K = loc_k.shape[1]
    G = H // KH
    cat_k = torch.cat([ctx_k, loc_k.to(dt).float()], dim=1)
    cat_v = torch.cat([ctx_v, loc_v.to(dt).float()], dim=1)
    qg = q.reshape(B, KH, G, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, cat_k) / (D ** 0.5)
    pool_valid = torch.arange(S, device=q.device)[None, :] < pool_lens[:, None]
    loc_valid = (torch.arange(K, device=q.device) <= step_idx.reshape(()))[None, :]
    mask = torch.cat([pool_valid, loc_valid.expand(B, K)], dim=1)  # [B, S+K]
    out = _softmax_pv(scores, mask[:, None, None, :], cat_v, "bkgs,bskd->bkgd", dt)
    return out.reshape(B, H, D).to(q.dtype)


def prefill_attention_plain(
    q: torch.Tensor,  # [T, H, D] (one sequence's chunk, rope applied)
    kv_k_layer: torch.Tensor,  # [pages, page_size, KH, D]
    kv_v_layer: torch.Tensor,
    positions: torch.Tensor,  # [T] absolute positions of the chunk
    page_table: torch.Tensor,  # [max_pages]
) -> torch.Tensor:
    """Plain single-sequence chunked prefill, as the reference's XLA path:
    row t attends to every key at a position <= positions[t] (history pages
    and the chunk, causal). Returns [T, H, D]."""
    plain_calls["prefill"] += 1
    T, H, D = q.shape
    dt = _ctx_dtype(kv_k_layer, q)
    ctx_k = _gather_ctx(kv_k_layer, page_table, dt)  # [S, KH, D]
    ctx_v = _gather_ctx(kv_v_layer, page_table, dt)
    S, KH = ctx_k.shape[0], ctx_k.shape[1]
    G = H // KH
    qg = q.reshape(T, KH, G, D).float()
    scores = torch.einsum("tkgd,skd->tkgs", qg, ctx_k) / (D ** 0.5)
    mask = torch.arange(S, device=q.device)[None, :] <= positions[:, None]  # [T, S]
    out = _softmax_pv(scores, mask[:, None, None, :], ctx_v, "tkgs,skd->tkgd", dt)
    return out.reshape(T, H, D).to(q.dtype)


def prefill_attention_batched_plain(
    q: torch.Tensor,  # [B, T, H, D] (chunks, rope applied)
    kv_k_layer: torch.Tensor,  # [pages, page_size, KH, D]
    kv_v_layer: torch.Tensor,
    positions: torch.Tensor,  # [B, T] absolute positions
    page_tables: torch.Tensor,  # [B, max_pages]
    total_lens: torch.Tensor,  # [B] valid context per seq (history + real chunk)
    starts: torch.Tensor,  # [B] absolute position of each chunk's row 0
) -> torch.Tensor:
    """Plain batched chunked prefill: each sequence's chunk attends to its
    own history pages + itself (causal). Returns [B, T, H, D]. Row i of
    sequence b is taken to sit at starts[b] + i (what the kernel assumes);
    rows past the real chunk give finite values nobody reads."""
    plain_calls["prefill"] += 1
    B, T, H, D = q.shape
    dt = _ctx_dtype(kv_k_layer, q)
    ctx_k = _gather_ctx(kv_k_layer, page_tables, dt)  # [B, S, KH, D]
    ctx_v = _gather_ctx(kv_v_layer, page_tables, dt)
    S, KH = ctx_k.shape[1], ctx_k.shape[2]
    G = H // KH
    qg = q.reshape(B, T, KH, G, D).float()
    scores = torch.einsum("btkgd,bskd->btkgs", qg, ctx_k) / (D ** 0.5)
    key_pos = torch.arange(S, device=q.device)
    row_pos = starts[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = (key_pos[None, None, :] <= row_pos[:, :, None]) & (
        key_pos[None, None, :] < total_lens[:, None, None]
    )  # [B, T, S]
    out = _softmax_pv(scores, mask[:, :, None, None, :], ctx_v,
                      "btkgs,bskd->btkgd", dt)
    return out.reshape(B, T, H, D).to(q.dtype)


def ragged_attention_plain(
    q: torch.Tensor,  # [N, H, D] flat packed tokens (rope applied)
    kv_k_layer: torch.Tensor,  # [pages, page_size, KH, D]
    kv_v_layer: torch.Tensor,
    page_tables: torch.Tensor,  # [R, max_pages]
    row_starts: torch.Tensor,  # [R] flat index of row r's token 0 (ascending;
    # padding rows sit at N)
    row_lens: torch.Tensor,  # [R] real tokens per row (0 for padding rows)
    ctx_lens: torch.Tensor,  # [R] history length before each row's chunk
    token_chunk: int = 256,
) -> torch.Tensor:
    """Plain ragged mixed prefill+decode attention: every flat token
    attends to its OWN row's pages (history + chunk, causal). Returns
    [N, H, D]; tokens outside every row span return zeros, as from the
    kernel. Works through the flat buffer `token_chunk` tokens at a time to
    bound the gathered context."""
    plain_calls["ragged"] += 1
    N, H, D = q.shape
    R = page_tables.shape[0]
    idx = torch.arange(N, device=q.device)
    # owning row per token: the last row whose start <= idx
    row_ids = ((idx[:, None] >= row_starts[None, :]).sum(dim=1) - 1).clamp(0, R - 1)
    local = idx - row_starts[row_ids]
    positions = ctx_lens[row_ids] + local
    totals = ctx_lens[row_ids] + row_lens[row_ids]
    real = (local >= 0) & (local < row_lens[row_ids])
    dt = _ctx_dtype(kv_k_layer, q)
    ctx_k = _gather_ctx(kv_k_layer, page_tables, dt)  # [R, S, KH, D]
    ctx_v = _gather_ctx(kv_v_layer, page_tables, dt)
    S, KH = ctx_k.shape[1], ctx_k.shape[2]
    G = H // KH
    key_pos = torch.arange(S, device=q.device)
    out = torch.zeros_like(q)
    for lo in range(0, N, token_chunk):
        sl = slice(lo, min(lo + token_chunk, N))
        rid = row_ids[sl]
        qg = q[sl].reshape(-1, KH, G, D).float()
        scores = torch.einsum("nkgd,nskd->nkgs", qg, ctx_k[rid]) / (D ** 0.5)
        mask = (
            (key_pos[None, :] <= positions[sl, None])
            & (key_pos[None, :] < totals[sl, None])
            & real[sl, None]
        )  # [n, S]
        o = _softmax_pv(scores, mask[:, None, None, :], ctx_v[rid],
                        "nkgs,nskd->nkgd", dt)
        o = torch.where(real[sl, None, None, None], o, torch.zeros_like(o))
        out[sl] = o.reshape(-1, H, D).to(q.dtype)
    return out


# ---------------------------------------------------------------------- #
# dispatchers (the reference's public signatures)
# ---------------------------------------------------------------------- #


def paged_attention_decode(q, kv_k_layer, kv_v_layer, page_tables, seq_lens):
    """One-token decode attention over paged KV. Returns [B, H, D]."""
    if q.is_cuda:
        return paged_attention_decode_hopper(
            q, kv_k_layer, kv_v_layer, page_tables, seq_lens)
    return paged_attention_decode_plain(
        q, kv_k_layer, kv_v_layer, page_tables, seq_lens)


def paged_attention_decode_mixed(q, kv_k_layer, kv_v_layer, page_tables,
                                 pool_lens, loc_k, loc_v, step_idx):
    """Decode attention over the read-only pool plus the block-local
    buffer (the local decode block's attention). Returns [B, H, D]."""
    if q.is_cuda:
        return paged_attention_decode_local_hopper(
            q, kv_k_layer, kv_v_layer, page_tables, pool_lens, loc_k, loc_v, step_idx)
    return paged_attention_decode_mixed_plain(
        q, kv_k_layer, kv_v_layer, page_tables, pool_lens, loc_k, loc_v, step_idx)


def prefill_attention(q, kv_k_layer, kv_v_layer, positions, page_table,
                      context_len, total_len):
    """Single-sequence chunked prefill attention (q [T, H, D]; the chunk's
    KV already in the pages). Returns [T, H, D]. On the card it is the
    batched kernel at B=1, row 0 at `context_len` and `total_len` keys
    valid, as the reference's single-sequence Pallas wrapper calls its
    batched kernel."""
    if q.is_cuda:
        i32 = dict(dtype=torch.int32, device=q.device)
        return prefill_attention_batched_hopper(
            q[None], kv_k_layer, kv_v_layer, page_table.to(torch.int32)[None],
            torch.as_tensor(context_len, **i32).reshape(1),
            torch.as_tensor(total_len, **i32).reshape(1))[0]
    return prefill_attention_plain(q, kv_k_layer, kv_v_layer, positions, page_table)


def prefill_attention_batched(q, kv_k_layer, kv_v_layer, positions,
                              page_tables, total_lens, starts):
    """Batched chunked prefill attention. Returns [B, T, H, D]. `positions`
    is kept for the reference's signature; row i of sequence b sits at
    starts[b] + i."""
    if q.is_cuda:
        return prefill_attention_batched_hopper(
            q, kv_k_layer, kv_v_layer, page_tables, starts, total_lens)
    return prefill_attention_batched_plain(
        q, kv_k_layer, kv_v_layer, positions, page_tables, total_lens, starts)


def ragged_attention(q, kv_k_layer, kv_v_layer, page_tables, row_starts,
                     row_lens, ctx_lens):
    """Ragged mixed prefill+decode attention over paged KV: one call for a
    flat buffer packing prefill chunks (T>1) and decode slots (T=1).
    Returns [N, H, D]."""
    if q.is_cuda:
        return ragged_attention_hopper(
            q, kv_k_layer, kv_v_layer, page_tables, row_starts, row_lens, ctx_lens)
    return ragged_attention_plain(
        q, kv_k_layer, kv_v_layer, page_tables, row_starts, row_lens, ctx_lens)
