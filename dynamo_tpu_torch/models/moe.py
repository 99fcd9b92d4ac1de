"""Mixtral-family sparse-MoE model: llama attention + top-k expert MLP.

Port of `dynamo_tpu/models/moe.py` for one device. The forwards are the
llama forwards (models/llama.py) with the MLP swapped through their
`mlp_fn` hook, so every attention kernel of the dense path serves these
models too, at their own head geometry.

The expert MLP keeps the reference's semantics exactly:

  * the router is an f32 product of `rms_norm(x)` cast to f32 with the f32
    router weights; the top k logits are chosen with ties broken toward the
    lower expert index (jax.lax.top_k's rule: torch.topk promises no order
    on ties, so a stable descending sort takes its place), and softmaxed
    over the chosen ones;
  * a token is routed to an expert where its combine weight is > 0 (a
    weight that underflows to 0 routes nothing), and takes the expert's
    next slot in flat token order (cumsum over tokens; a batched prefill's
    [B, T] flattens row-major); tokens past the static capacity
    C = expert_capacity(T) are dropped. Every row of the dispatch is
    routed, pads included: padded T sizes C, and a pad earlier in token
    order can take a real token's slot, as in the reference;
  * `gate` and `up` leave `qeinsum` in f32, `silu(gate) * up` is cast to
    the model dtype, `w_down`'s output stays f32 through the combine, and
    the residual adds it after the cast.

Where it differs in form: the reference contracts a one-hot [T, E, C]
dispatch tensor; here the kept (token, expert, slot) triples index the
token rows into [E, C, H] directly and the expert rows gather back with
the combine weights. Every (expert, slot) holds at most one token, so the
values are the reference's: the contraction copies rows exactly, and a
token's output sums its k weighted expert rows in f32. Everything stays
static-shaped (no host sync), so the decode block's K fused steps keep
running without a host read.

Every expert runs on its C slots every step, whether tokens came or not,
as in the reference's dense dispatch. Not ported: expert parallelism
(`--ep-size`), the `_pp` / `_ring` forwards and the single-sequence
`prefill_forward`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from . import llama
from .llama import LlamaConfig, rms_norm
from .quant import qeinsum


@dataclass(frozen=True)
class MoeConfig(LlamaConfig):
    num_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25

    @classmethod
    def mixtral_8x7b(cls, **overrides):
        kw = dict(
            vocab_size=32000, hidden_size=4096, intermediate_size=14336,
            num_layers=32, num_heads=32, num_kv_heads=8, head_dim=128,
            rope_theta=1e6, num_experts=8, num_experts_per_tok=2,
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def gptoss_120b(cls, **overrides):
        """gpt-oss-120b-shaped wide MoE (36 layers, 128 experts top-4) with
        GQA attention at its head geometry."""
        kw = dict(
            vocab_size=201088, hidden_size=2880, intermediate_size=2880,
            num_layers=36, num_heads=64, num_kv_heads=8, head_dim=64,
            rope_theta=150e3, num_experts=128, num_experts_per_tok=4,
        )
        kw.update(overrides)
        return cls(**kw)

    @classmethod
    def tiny_moe(cls, **overrides):
        """CPU-test scale."""
        kw = dict(
            vocab_size=512, hidden_size=64, intermediate_size=96,
            num_layers=2, num_heads=4, num_kv_heads=2, head_dim=16,
            max_position=512, num_experts=4, num_experts_per_tok=2,
        )
        kw.update(overrides)
        return cls(**kw)


def init_params(config: MoeConfig, generator: torch.Generator, device="cuda",
                scale: float = 0.02, quantize: Optional[str] = None) -> Dict[str, Any]:
    """Random-init MoE tree drawn from `generator` (on `device`): llama's
    attention leaves, an f32 router [L, hidden, E] and expert stacks
    [L, E, in, out], each matrix drawn in f32 and cast. With
    quantize="int8" every matrix (one (layer, expert) matrix of a stack)
    is quantized as it is drawn, so the full-precision tree is never
    resident; the values equal this init followed by `quantize_tree`."""
    c = config
    L, E, H, I = c.num_layers, c.num_experts, c.hidden_size, c.intermediate_size
    q_dim = c.num_heads * c.head_dim
    kv_dim = c.num_kv_heads * c.head_dim
    dense = llama.dense_draw(c, generator, device, scale)

    def stacked(shape, lead=(L,)):
        return llama.stack_draws(lead, lambda: dense(shape), quantize, device)

    def router():
        # kept f32: routing decisions are numerically sensitive
        return torch.randn((H, E), generator=generator, device=device,
                           dtype=torch.float32) * scale

    def ones():
        return torch.ones((L, H), dtype=c.dtype, device=device)

    layers = {
        "attn_norm": ones(),
        "wq": stacked((H, q_dim)),
        "wk": stacked((H, kv_dim)),
        "wv": stacked((H, kv_dim)),
        "wo": stacked((q_dim, H)),
        "mlp_norm": ones(),
        "router": llama.stack_draws((L,), router, None, device),
        "w_gate": stacked((H, I), (L, E)),
        "w_up": stacked((H, I), (L, E)),
        "w_down": stacked((I, H), (L, E)),
    }
    return {
        "embed": llama.stack_draws((), lambda: dense((c.vocab_size, H)), quantize, device,
                                   contract_axis=-1),
        "layers": layers,
        "final_norm": torch.ones((H,), dtype=c.dtype, device=device),
        "lm_head": None if c.tie_embeddings
        else llama.stack_draws((), lambda: dense((H, c.vocab_size)), quantize, device),
    }


def _constrain_ep(x: torch.Tensor) -> torch.Tensor:
    """The reference pins the expert axis to its `ep` mesh axis here; on
    one device the expert axis is never sharded, so this is the identity."""
    return x


def expert_capacity(num_tokens: int, config: MoeConfig) -> int:
    """Static per-expert token capacity (rounded up to a multiple of 4)."""
    c = math.ceil(
        num_tokens * config.num_experts_per_tok / config.num_experts
        * config.capacity_factor
    )
    return max(4, (c + 3) // 4 * 4)


def top_k(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties toward the lower index."""
    v, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(h: torch.Tensor, router: torch.Tensor, c: MoeConfig):
    """Routing of the normed tokens h [T, H]: (choices [T, K] expert ids,
    weights [T, K] f32 softmax over the chosen logits, kept [T, K] whether
    the choice holds a slot, slot [T, K] its flat slot e * C + position
    in the expert's buffer)."""
    T = h.shape[0]
    E, K = c.num_experts, c.num_experts_per_tok
    C = expert_capacity(T, c)
    logits = torch.matmul(h.float(), router)  # [T, E]
    topv, topi = top_k(logits, K)
    probs = torch.softmax(topv, dim=-1)  # renormalised over the chosen experts
    combine = torch.zeros((T, E), dtype=torch.float32, device=h.device)
    combine.scatter_add_(1, topi, probs)
    routed = combine > 0.0
    # slot within the expert's buffer: tokens claim slots in order; overflow drops
    pos = torch.cumsum(routed.to(torch.int32), dim=0) - 1
    keep = routed & (pos < C)
    kept = keep.gather(1, topi)
    slot = topi * C + pos.gather(1, topi)
    return topi, probs, kept, slot


def moe_mlp(layer: Dict[str, Any], x: torch.Tensor, c: MoeConfig) -> torch.Tensor:
    """Sparse MoE block for x [T, H]: top-k routing -> capacity-bounded
    dispatch into [E, C, H] -> batched expert SwiGLU -> weighted combine."""
    T, H = x.shape
    E, K = c.num_experts, c.num_experts_per_tok
    C = expert_capacity(T, c)
    h = rms_norm(x, layer["mlp_norm"], c.rms_norm_eps)
    _, probs, kept, slot = route(h, layer["router"], c)

    # each slot's source token (T: the zero row); dropped choices all go
    # to the spare slot E * C, which is never read
    dest = torch.where(kept, slot, E * C).reshape(-1)
    src = torch.full((E * C + 1,), T, dtype=torch.long, device=x.device)
    src.scatter_(0, dest, torch.arange(T, device=x.device).repeat_interleave(K))
    rows = torch.cat([h, h.new_zeros((1, H))])
    expert_in = _constrain_ep(rows[src[: E * C]].view(E, C, H))
    # qeinsum: the stacks may be int8 (models/quant.py) — scale [E, 1, out]
    # applies to the f32 result
    gate = qeinsum("ech,ehi->eci", expert_in, layer["w_gate"])
    up = qeinsum("ech,ehi->eci", expert_in, layer["w_up"])
    act = (F.silu(gate) * up).to(c.dtype)
    expert_out = _constrain_ep(qeinsum("eci,eih->ech", act, layer["w_down"]))

    # each choice's expert row, weighted (0 where dropped), summed in f32
    picked = expert_out.reshape(E * C, H)[torch.where(kept, slot, 0)]  # [T, K, H]
    out = (picked * probs.masked_fill(~kept, 0.0)[..., None]).sum(dim=1)
    return x + out.to(c.dtype)


def _moe_mlp_nd(layer, x, c):
    """moe_mlp over [B, T, H] (batched prefill flattens the token dims:
    expert dispatch is position-independent)."""
    if x.dim() == 3:
        B, T, H = x.shape
        return moe_mlp(layer, x.reshape(B * T, H), c).reshape(B, T, H)
    return moe_mlp(layer, x, c)


def decode_forward(params, config: MoeConfig, tokens, positions, kv_k, kv_v,
                   page_tables, seq_lens, **kw):
    """One decode step for the slot batch, MoE MLP; `kw` as
    llama.decode_forward's. Returns (logits [B, vocab] f32, kv_k, kv_v)."""
    return llama.decode_forward(params, config, tokens, positions, kv_k, kv_v,
                                page_tables, seq_lens, mlp_fn=moe_mlp, **kw)


def decode_forward_local(params, config: MoeConfig, tokens, positions, loc_k, loc_v,
                         step_idx, kv_k, kv_v, page_tables, pool_lens, **kw):
    """Pool-read-only decode step (block-local KV), MoE MLP."""
    return llama.decode_forward_local(params, config, tokens, positions, loc_k, loc_v,
                                      step_idx, kv_k, kv_v, page_tables, pool_lens,
                                      mlp_fn=moe_mlp, **kw)


def ragged_forward(params, config: MoeConfig, tokens, positions, row_ids, kv_k, kv_v,
                   page_tables, row_starts, row_lens, ctx_lens, last_flat, **kw):
    """Unified mixed-step forward, MoE MLP: the flat buffer is already
    [tokens, H], the shape expert dispatch wants."""
    return llama.ragged_forward(params, config, tokens, positions, row_ids, kv_k, kv_v,
                                page_tables, row_starts, row_lens, ctx_lens, last_flat,
                                mlp_fn=moe_mlp, **kw)


def prefill_forward_batched(params, config: MoeConfig, tokens, positions, kv_k, kv_v,
                            page_tables, context_lens, last_idx, **kw):
    """Batched chunked prefill (several sequences a dispatch), MoE MLP.
    `**kw` carries llama's options through, the multimodal splice
    (`emb_override`, `emb_mask`) among them."""
    return llama.prefill_forward_batched(params, config, tokens, positions, kv_k, kv_v,
                                         page_tables, context_lens, last_idx,
                                         mlp_fn=_moe_mlp_nd, **kw)
