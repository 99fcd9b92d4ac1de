"""Llama-family model as plain functions on tensors (parameter dictionaries).

Port of `dynamo_tpu/models/llama.py`: RMSNorm, rotary embeddings, GQA
attention over a PAGED KV cache, SwiGLU MLP. The public functions keep the
reference's argument order and layouts:

  * KV cache: [layers, pages, page_size, kv_heads, head_dim]; the engine
    passes page tables; attention goes through ops/paged_attention.
  * parameters: {"embed" [V, hidden], "layers": {name: [L, in, out]},
    "final_norm", "lm_head" (None when tied)} — the reference's tree;
    projections, embedding and head may be int8 weight-only quantized
    leaves {"q", "s"} (models/quant.py), which every forward accepts.

Unlike the reference, the KV cache is WRITTEN IN PLACE: the forwards return
the same `kv_k`/`kv_v` stores they were given (tensors, or `QuantKV` for an
int8/int4 cache, whose writes quantize and whose reads dequantize: the
attention reads a layer's pages back after that layer's write, so a
quantized prefill attends the quantized copy of its own chunk, as in the
reference). Physical page 0 is the scratch page — padding tokens and
positions past the page table write there (a missed case would corrupt a
shared prefix-cache page silently).

Products: every projection runs `qdot` in the model dtype (bf16 in, f32
accumulation, bf16 out); `silu(gate) * up` is evaluated in f32 from those
outputs; the LM head keeps an f32 output (models/quant.py).

Each forward takes `mlp_fn` ((layer, x, config) -> x, default `_mlp`), the
reference's hook through which models/moe.py swaps in its sparse MoE MLP.

Multi-LoRA: `prefill_forward_batched`, `ragged_forward` and `decode_forward`
take `lora=` — the engine's adapter stack (models/lora.py) with `idx`, the
slot of each lane (each row for the ragged forward). The delta joins the
wq/wk/wv/wo products (`lora.proj`); slot 0 adds an exact zero. Without
`lora` a forward runs no more operations than before.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..ops.kv_quant import kv_layer, kv_page_size, kv_write
from ..ops.paged_attention import (
    paged_attention_decode,
    paged_attention_decode_mixed,
    paged_attention_decode_mixed_plain,
    paged_attention_decode_plain,
    prefill_attention,
    prefill_attention_batched,
    prefill_attention_batched_plain,
    ragged_attention,
    ragged_attention_plain,
)
from .lora import layer_lora, lora_rows, proj
from .quant import embed_rows, empty_quant, head_leaf, is_quant, qdot, quantize_into


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rope_theta: float = 500000.0
    rms_norm_eps: float = 1e-5
    max_position: int = 8192
    dtype: Any = torch.bfloat16
    tie_embeddings: bool = False

    @classmethod
    def llama3_8b(cls, **overrides):
        return cls(
            vocab_size=128256, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            **overrides,
        )

    @classmethod
    def llama3_70b(cls, **overrides):
        return cls(
            vocab_size=128256, hidden_size=8192, intermediate_size=28672,
            num_layers=80, num_heads=64, num_kv_heads=8, head_dim=128,
            **overrides,
        )

    @classmethod
    def llama3_2_3b(cls, **overrides):
        """Llama-3.2-3B: the single-device flagship."""
        kw = dict(
            vocab_size=128256, hidden_size=3072, intermediate_size=8192,
            num_layers=28, num_heads=24, num_kv_heads=8, head_dim=128,
            tie_embeddings=True,
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def tiny(cls, **overrides):
        """CPU-test scale."""
        kw = dict(
            vocab_size=512, hidden_size=64, intermediate_size=128,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=512,
        )
        kw.update(overrides)
        return cls(**kw)


def init_params(config: LlamaConfig, generator: torch.Generator,
                device="cuda", scale: float = 0.02,
                quantize: Optional[str] = None) -> Dict[str, Any]:
    """Random-init parameter dictionary drawn from `generator` (which must
    live on `device`). Leaves are drawn in f32 and cast, one matrix at a
    time, so the transient f32 copy stays small. With quantize="int8" each
    matrix is quantized as soon as it is drawn, so the full-precision tree
    is never resident: the values equal this init followed by
    `quantize_tree`, draw for draw."""
    c = config
    q_dim = c.num_heads * c.head_dim
    kv_dim = c.num_kv_heads * c.head_dim
    dense = dense_draw(c, generator, device, scale)

    def stacked(shape):
        return stack_draws((c.num_layers,), lambda: dense(shape), quantize, device)

    def ones():
        return torch.ones((c.num_layers, c.hidden_size), dtype=c.dtype, device=device)

    layers = {
        "attn_norm": ones(),
        "wq": stacked((c.hidden_size, q_dim)),
        "wk": stacked((c.hidden_size, kv_dim)),
        "wv": stacked((c.hidden_size, kv_dim)),
        "wo": stacked((q_dim, c.hidden_size)),
        "mlp_norm": ones(),
        "w_gate": stacked((c.hidden_size, c.intermediate_size)),
        "w_up": stacked((c.hidden_size, c.intermediate_size)),
        "w_down": stacked((c.intermediate_size, c.hidden_size)),
    }
    return {
        "embed": stack_draws((), lambda: dense((c.vocab_size, c.hidden_size)), quantize,
                             device, contract_axis=-1),
        "layers": layers,
        "final_norm": torch.ones((c.hidden_size,), dtype=c.dtype, device=device),
        "lm_head": None if c.tie_embeddings
        else stack_draws((), lambda: dense((c.hidden_size, c.vocab_size)), quantize, device),
    }


def dense_draw(c: LlamaConfig, generator: torch.Generator, device, scale: float):
    """shape -> one matrix drawn in f32 from `generator`, scaled and cast to
    the model dtype."""
    def dense(shape):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(c.dtype)

    return dense


def stack_draws(lead: tuple, draw, quantize: Optional[str], device,
                contract_axis: int = -2):
    """A leaf [*lead, ...] filled with one `draw()` a matrix, in row-major
    order of `lead`; under quantize="int8" each matrix is quantized into
    the int8 leaf as it is drawn (per channel over `contract_axis`)."""
    if quantize not in (None, "", "int8"):
        raise ValueError(f"unknown quantize mode {quantize!r}")
    out = None
    for idx in itertools.product(*map(range, lead)):
        w = draw()
        if out is None:
            shape = (*lead, *w.shape)
            out = (empty_quant(shape, device, contract_axis) if quantize
                   else torch.empty(shape, dtype=w.dtype, device=device))
        if quantize:
            quantize_into(out["q"][idx], out["s"][idx], w, contract_axis)
        else:
            out[idx].copy_(w)
        del w
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """Normalise in f32, cast to x.dtype, THEN multiply by the weight (the
    reference's rounding order). The weightless `F.rms_norm` does the first
    two steps in one pass with f32 arithmetic."""
    return F.rms_norm(x, (x.shape[-1],), None, eps) * weight


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float):
    """positions [...,] -> cos/sin [..., head_dim//2] (f32)."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    angles = positions.float()[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x [..., heads, head_dim]; cos/sin broadcast over heads. Split-half
    rotation, f32 math."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _layer(params: Dict[str, Any], li: int) -> Dict[str, Any]:
    """Layer `li`'s slice of every stacked leaf (a quantized leaf's ints and
    scales alike)."""
    return {k: {"q": v["q"][li], "s": v["s"][li]} if is_quant(v) else v[li]
            for k, v in params["layers"].items()}


def _mlp(layer, x, c: LlamaConfig):
    h = rms_norm(x, layer["mlp_norm"], c.rms_norm_eps)
    gate = qdot(h, layer["w_gate"])
    up = qdot(h, layer["w_up"])
    act = (F.silu(gate.float()) * up.float()).to(c.dtype)
    return x + qdot(act, layer["w_down"])


def _qkv(layer, x, c: LlamaConfig, cos, sin, ll=None):
    """Projections (+ the LoRA deltas of layer slice `ll`) + rope for any
    leading token shape [..., hidden]."""
    lead = x.shape[:-1]
    h = rms_norm(x, layer["attn_norm"], c.rms_norm_eps)
    q = proj(h, qdot(h, layer["wq"]), ll, "wq").reshape(*lead, c.num_heads, c.head_dim)
    k = proj(h, qdot(h, layer["wk"]), ll, "wk").reshape(*lead, c.num_kv_heads, c.head_dim)
    v = proj(h, qdot(h, layer["wv"]), ll, "wv").reshape(*lead, c.num_kv_heads, c.head_dim)
    # one rotation over the query and key heads together
    qk = apply_rope(torch.cat([q, k], dim=-2), cos, sin)
    return qk[..., : c.num_heads, :].contiguous(), qk[..., c.num_heads :, :], v


def _page_slots(positions: torch.Tensor, tables_tok: torch.Tensor, page_size: int):
    """(phys, offs) of each token's KV slot. `tables_tok` holds each token's
    page-table row ([..., P]); positions past the table go to the scratch
    page (physical page 0), never to the table's last page."""
    P_tab = tables_tok.shape[-1]
    logical = torch.clamp(positions // page_size, max=P_tab - 1)
    phys = torch.gather(tables_tok, -1, logical[..., None].long())[..., 0]
    phys = torch.where(positions < P_tab * page_size, phys, torch.zeros_like(phys))
    return phys.long(), (positions % page_size).long()


def prefill_forward(
    params: Dict[str, Any],
    config: LlamaConfig,
    tokens: torch.Tensor,  # [T] one chunk of one sequence
    positions: torch.Tensor,  # [T] absolute positions
    kv_k,  # [L, pages, page_size, kv_heads, head_dim] or QuantKV
    kv_v,
    page_table: torch.Tensor,  # [max_pages] pages of THIS sequence
    context_len,  # positions below it are valid history (int or 0-d tensor)
    last_idx=None,  # index of the last REAL token of a padded chunk (default T-1)
    mlp_fn=None,  # (layer, x, config) -> x; models/moe.py passes its MoE MLP
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One prompt chunk of a single sequence; returns (logits_last [vocab]
    f32, kv_k, kv_v) with the chunk's KV written into its pages. The chunk
    attends causally to itself and to the history already in the pages.
    The engine serves prefill batched (`prefill_forward_batched`); this is
    the profiler's forward, as in the reference."""
    c = config
    mlp = mlp_fn or _mlp
    T = tokens.shape[0]
    dev = tokens.device
    x = embed_rows(params["embed"], tokens, c.dtype)  # [T, H]
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
    page_size = kv_page_size(kv_k)
    # valid context = history + the real (unpadded) chunk: bounds the
    # kernel's page streaming, as in the reference
    real = T if last_idx is None else torch.as_tensor(last_idx, device=dev) + 1
    start = torch.as_tensor(context_len, dtype=torch.int32, device=dev)
    total = (start + real).to(torch.int32)
    phys, offs = _page_slots(positions, page_table[None, :].expand(T, -1), page_size)

    for li in range(c.num_layers):
        layer = _layer(params, li)
        q, k, v = _qkv(layer, x, c, cos, sin)
        kv_write(kv_k, li, phys, offs, k)
        kv_write(kv_v, li, phys, offs, v)
        attn = prefill_attention(
            q, kv_layer(kv_k, li), kv_layer(kv_v, li), positions, page_table, start, total)
        attn = attn.reshape(T, c.num_heads * c.head_dim)
        x = x + qdot(attn, layer["wo"])
        x = mlp(layer, x, c)

    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    last = x[-1] if last_idx is None else x[torch.as_tensor(last_idx, device=dev).long()]
    logits = qdot(last, head_leaf(params), out_dtype=torch.float32)
    return logits, kv_k, kv_v


def prefill_forward_batched(
    params: Dict[str, Any],
    config: LlamaConfig,
    tokens: torch.Tensor,  # [B, T] one chunk per sequence (padded to bucket)
    positions: torch.Tensor,  # [B, T] absolute positions (pads -> scratch tail)
    kv_k,  # [L, pages, page_size, kv_heads, head_dim] or QuantKV
    kv_v,
    page_tables: torch.Tensor,  # [B, max_pages] per-seq tables (ctx-bounded)
    context_lens: torch.Tensor,  # [B] history length per seq
    last_idx: torch.Tensor,  # [B] index of last REAL token per chunk
    plain_attention: bool = False,  # tests: force the plain attention version
    all_logits: bool = False,  # True: [B, T, vocab] (the speculative verify)
    lora=None,  # models/lora.py stack + per-lane "idx" [B]
    mlp_fn=None,  # (layer, x, config) -> x; models/moe.py passes its MoE MLP
    emb_override: Optional[torch.Tensor] = None,  # [B, T, H] multimodal rows (f32)
    emb_mask: Optional[torch.Tensor] = None,  # [B, T] True where the override applies
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Batched chunked prefill: one call processes chunks of SEVERAL
    sequences. Returns (logits_last [B, vocab] f32, kv_k, kv_v) with the
    chunks' KV written into the pages — or every position's logits
    [B, T, vocab] under `all_logits` (engine/spec.py's verify pass).

    `emb_override` / `emb_mask`: the multimodal splice — encoder rows,
    cast to the model dtype, replace the placeholder tokens' embeddings
    where the mask is set (llm/multimodal.py)."""
    c = config
    mlp = mlp_fn or _mlp
    B, T = tokens.shape
    x = embed_rows(params["embed"], tokens, c.dtype)  # [B, T, H]
    if emb_override is not None:
        x = torch.where(emb_mask[..., None], emb_override.to(c.dtype), x)
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
    page_size = kv_page_size(kv_k)
    total_lens = (context_lens + last_idx + 1).to(torch.int32)  # [B]
    starts = context_lens.to(torch.int32)
    phys, offs = _page_slots(
        positions, page_tables[:, None, :].expand(B, T, -1), page_size)
    attend = prefill_attention_batched_plain if plain_attention else prefill_attention_batched
    rows = None if lora is None else lora_rows(lora, lora["idx"][:, None].expand(B, T))

    for li in range(c.num_layers):
        layer = _layer(params, li)
        ll = layer_lora(rows, li)
        q, k, v = _qkv(layer, x, c, cos, sin, ll)
        kv_write(kv_k, li, phys, offs, k)
        kv_write(kv_v, li, phys, offs, v)
        attn = attend(
            q, kv_layer(kv_k, li), kv_layer(kv_v, li), positions, page_tables,
            total_lens, starts,
        ).reshape(B, T, c.num_heads * c.head_dim)
        x = x + proj(attn, qdot(attn, layer["wo"]), ll, "wo")
        x = mlp(layer, x, c)

    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    if all_logits:
        return qdot(x, head_leaf(params), out_dtype=torch.float32), kv_k, kv_v
    last = x[torch.arange(B, device=x.device), last_idx.long()]  # [B, hidden]
    logits = qdot(last, head_leaf(params), out_dtype=torch.float32)
    return logits, kv_k, kv_v


def ragged_forward(
    params: Dict[str, Any],
    config: LlamaConfig,
    tokens: torch.Tensor,  # [N] flat packed: prefill chunks + decode singletons
    positions: torch.Tensor,  # [N] absolute positions (pads -> scratch tail)
    row_ids: torch.Tensor,  # [N] owning row per flat token
    kv_k,  # [L, pages, page_size, kv_heads, head_dim] or QuantKV
    kv_v,
    page_tables: torch.Tensor,  # [R, max_pages] per-row tables (ctx-bounded)
    row_starts: torch.Tensor,  # [R] flat index of each row's token 0
    row_lens: torch.Tensor,  # [R] real tokens per row (1 for decode rows)
    ctx_lens: torch.Tensor,  # [R] history length per row
    last_flat: torch.Tensor,  # [R] flat index of each row's LAST real token
    plain_attention: bool = False,
    lora=None,  # models/lora.py stack + PER-ROW "idx" [R]
    mlp_fn=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The unified mixed-step forward: ONE pass over a flat ragged token
    buffer that packs prefill chunks (row_len > 1) and decode slots
    (row_len == 1, ctx = seq_len - 1). Returns (logits_last [R, vocab] f32,
    kv_k, kv_v) with every row's chunk KV written into its pages; each
    row's last-token logits feed on-device sampling."""
    c = config
    mlp = mlp_fn or _mlp
    x = embed_rows(params["embed"], tokens, c.dtype)  # [N, H]
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
    page_size = kv_page_size(kv_k)
    # per-token physical page through the OWNING row's table
    phys, offs = _page_slots(positions, page_tables[row_ids.long()], page_size)
    attend = ragged_attention_plain if plain_attention else ragged_attention
    # the per-row adapter slot becomes per flat token through row_ids
    rows = None if lora is None else lora_rows(lora, lora["idx"][row_ids.long()])

    for li in range(c.num_layers):
        layer = _layer(params, li)
        ll = layer_lora(rows, li)
        q, k, v = _qkv(layer, x, c, cos, sin, ll)
        kv_write(kv_k, li, phys, offs, k)
        kv_write(kv_v, li, phys, offs, v)
        attn = attend(
            q, kv_layer(kv_k, li), kv_layer(kv_v, li), page_tables,
            row_starts, row_lens, ctx_lens,
        ).reshape(-1, c.num_heads * c.head_dim)
        x = x + proj(attn, qdot(attn, layer["wo"]), ll, "wo")
        x = mlp(layer, x, c)

    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    last = x[last_flat.long()]  # [R, hidden]
    logits = qdot(last, head_leaf(params), out_dtype=torch.float32)
    return logits, kv_k, kv_v


def decode_forward(
    params: Dict[str, Any],
    config: LlamaConfig,
    tokens: torch.Tensor,  # [B] one new token per slot
    positions: torch.Tensor,  # [B]
    kv_k,
    kv_v,
    page_tables: torch.Tensor,  # [B, max_pages]
    seq_lens: torch.Tensor,  # [B] lengths INCLUDING the new token
    plain_attention: bool = False,
    lora=None,  # models/lora.py stack + per-lane "idx" [B]
    mlp_fn=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for the whole slot batch; returns
    (logits [B, vocab] f32, kv_k, kv_v)."""
    c = config
    mlp = mlp_fn or _mlp
    x = embed_rows(params["embed"], tokens, c.dtype)  # [B, H]
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
    page_size = kv_page_size(kv_k)
    # positions past the table (a fused block speculating past
    # max_model_len) route to the scratch page, never to a real page
    phys, offs = _page_slots(positions, page_tables, page_size)
    attend = paged_attention_decode_plain if plain_attention else paged_attention_decode
    rows = None if lora is None else lora_rows(lora, lora["idx"])

    for li in range(c.num_layers):
        layer = _layer(params, li)
        ll = layer_lora(rows, li)
        q, k, v = _qkv(layer, x, c, cos, sin, ll)
        kv_write(kv_k, li, phys, offs, k)
        kv_write(kv_v, li, phys, offs, v)
        attn = attend(q, kv_layer(kv_k, li), kv_layer(kv_v, li), page_tables, seq_lens)
        attn = attn.reshape(-1, c.num_heads * c.head_dim)
        x = x + proj(attn, qdot(attn, layer["wo"]), ll, "wo")
        x = mlp(layer, x, c)

    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    logits = qdot(x, head_leaf(params), out_dtype=torch.float32)
    return logits, kv_k, kv_v


def decode_forward_local(
    params: Dict[str, Any],
    config: LlamaConfig,
    tokens: torch.Tensor,  # [B] one new token per slot
    positions: torch.Tensor,  # [B]
    loc_k,  # [L, B, K, KH, D] (or L tensors [B, K, KH, D]) block-local KV
    loc_v,  # in the compute dtype, written in place
    step_idx: torch.Tensor,  # [1] int32 on the device: this step's local slot
    kv_k,  # READ-ONLY pool (the engine commits the local buffer once per block)
    kv_v,
    page_tables: torch.Tensor,  # [B, max_pages]
    pool_lens: torch.Tensor,  # [B] positions valid in the pool (block-start len)
    plain_attention: bool = False,
    mlp_fn=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step that does NOT write the KV pool: each layer's new
    K/V go into its block-local buffer at `step_idx` (in place), and
    attention reads pool + local through paged_attention_decode_mixed.
    `step_idx` stays on the device, so no step needs a host value. Returns
    (logits [B, vocab] f32, loc_k, loc_v)."""
    c = config
    mlp = mlp_fn or _mlp
    x = embed_rows(params["embed"], tokens, c.dtype)  # [B, H]
    cos, sin = rope_cos_sin(positions, c.head_dim, c.rope_theta)
    slot = step_idx.reshape(1).long()
    attend = (paged_attention_decode_mixed_plain if plain_attention
              else paged_attention_decode_mixed)

    for li in range(c.num_layers):
        layer = _layer(params, li)
        q, k, v = _qkv(layer, x, c, cos, sin)
        loc_k[li].index_copy_(1, slot, k[:, None].to(loc_k[li].dtype))
        loc_v[li].index_copy_(1, slot, v[:, None].to(loc_v[li].dtype))
        attn = attend(
            q, kv_layer(kv_k, li), kv_layer(kv_v, li), page_tables, pool_lens,
            loc_k[li], loc_v[li], step_idx,
        )
        x = x + qdot(attn.reshape(-1, c.num_heads * c.head_dim), layer["wo"])
        x = mlp(layer, x, c)

    x = rms_norm(x, params["final_norm"], c.rms_norm_eps)
    logits = qdot(x, head_leaf(params), out_dtype=torch.float32)
    return logits, loc_k, loc_v


def param_count(params) -> int:
    """Elements of every leaf (a quantized leaf counts its ints and its
    scales, as the reference's count of pytree leaves does)."""
    def count(leaf):
        if leaf is None:
            return 0
        return leaf["q"].numel() + leaf["s"].numel() if is_quant(leaf) else leaf.numel()

    return sum(count(v) for v in (params["embed"], params["final_norm"],
                                  params.get("lm_head"), *params["layers"].values()))

