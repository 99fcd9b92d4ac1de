"""Paged attention ops: dispatchers and their plain PyTorch versions.

Port of `dynamo_tpu/ops/paged_attention.py`. Each op has a hand-written
Hopper kernel (ops/hopper_*.py) and, beside it, a plain PyTorch version
(`*_plain`: gather the page table, mask, softmax) that repeats the
kernel's arithmetic. The dispatch rule is the tensor's device and nothing
else: a CUDA tensor goes to the kernel (which launches or raises), a CPU
tensor to the plain version. There is no environment knob and no fallback.

Layouts:
  kv_k / kv_v (per layer): [num_pages, page_size, kv_heads, head_dim]
  page_table: logical page index -> physical page id
"""

from __future__ import annotations

import torch

from .hopper_paged_attention import paged_attention_decode_hopper
from .hopper_prefill_attention import prefill_attention_batched_hopper
from .hopper_ragged_attention import ragged_attention_hopper, ragged_tile_q

__all__ = [
    "paged_attention_decode", "paged_attention_decode_plain",
    "prefill_attention_batched", "prefill_attention_batched_plain",
    "ragged_attention", "ragged_attention_plain", "ragged_tile_q",
    "plain_calls",
]

NEG_INF = -1e30

#: calls of each plain version, so a run on the card can show it made none
plain_calls = {"decode": 0, "prefill": 0, "ragged": 0}


def _gather_ctx(layer: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """[pages, ps, KH, D] gathered by tables [..., P] -> [..., P*ps, KH, D]
    in f32. Page ids are clamped to the pool, as the kernels clamp them."""
    num_pages, page_size, KH, D = layer.shape
    pages = layer[tables.long().clamp(0, num_pages - 1)]
    return pages.reshape(*tables.shape[:-1], tables.shape[-1] * page_size, KH, D).float()


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
    KH = kv_k_layer.shape[2]
    G = H // KH
    ctx_k = _gather_ctx(kv_k_layer, page_tables)  # [B, S, KH, D]
    ctx_v = _gather_ctx(kv_v_layer, page_tables)
    S = ctx_k.shape[1]
    qg = q.reshape(B, KH, G, D).float()
    scores = torch.einsum("bkgd,bskd->bkgs", qg, ctx_k) / (D ** 0.5)
    key_pos = torch.arange(S, device=q.device)
    # an empty lane behaves as length 1, as in the kernel
    mask = key_pos[None, :] < seq_lens.clamp(min=1)[:, None]  # [B, S]
    out = _softmax_pv(scores, mask[:, None, None, :], ctx_v, "bkgs,bskd->bkgd",
                      kv_v_layer.dtype)
    return out.reshape(B, H, D).to(q.dtype)


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
    KH = kv_k_layer.shape[2]
    G = H // KH
    ctx_k = _gather_ctx(kv_k_layer, page_tables)  # [B, S, KH, D]
    ctx_v = _gather_ctx(kv_v_layer, page_tables)
    S = ctx_k.shape[1]
    qg = q.reshape(B, T, KH, G, D).float()
    scores = torch.einsum("btkgd,bskd->btkgs", qg, ctx_k) / (D ** 0.5)
    key_pos = torch.arange(S, device=q.device)
    row_pos = starts[:, None] + torch.arange(T, device=q.device)[None, :]
    mask = (key_pos[None, None, :] <= row_pos[:, :, None]) & (
        key_pos[None, None, :] < total_lens[:, None, None]
    )  # [B, T, S]
    out = _softmax_pv(scores, mask[:, :, None, None, :], ctx_v,
                      "btkgs,bskd->btkgd", kv_v_layer.dtype)
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
    KH = kv_k_layer.shape[2]
    G = H // KH
    idx = torch.arange(N, device=q.device)
    # owning row per token: the last row whose start <= idx
    row_ids = ((idx[:, None] >= row_starts[None, :]).sum(dim=1) - 1).clamp(0, R - 1)
    local = idx - row_starts[row_ids]
    positions = ctx_lens[row_ids] + local
    totals = ctx_lens[row_ids] + row_lens[row_ids]
    real = (local >= 0) & (local < row_lens[row_ids])
    ctx_k = _gather_ctx(kv_k_layer, page_tables)  # [R, S, KH, D]
    ctx_v = _gather_ctx(kv_v_layer, page_tables)
    S = ctx_k.shape[1]
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
                        "nkgs,nskd->nkgd", kv_v_layer.dtype)
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
