"""Multi-LoRA: per-request low-rank adapters served side by side.

Port of `dynamo_tpu/models/lora.py`. Every registered adapter lives in one
device STACK per target projection (wq, wk, wv, wo); slot 0 is the
all-zero base adapter, so a base-model lane adds an exact zero and a mixed
batch needs no masking of its own. The adapter name salts the KV block
hashes (llm/tokens.py `salt_hash`), so the prefix cache, the KVBM tiers and
the router tell adapters apart by their keys.

The stack's layout differs from the reference's `[N, L, in, r]` /
`[N, L, r, out]`: this port keeps A as `[L, in, N, r]` and B as
`[L, N, r, out]`, so one layer's slots read as two plain matrices,
`A_l = [in, N*r]` and `B_l = [N*r, out]` (views, no copy). The delta of a
token row is then ONE product with every slot's A, the columns outside the
row's slot zeroed, and ONE product with every slot's B: each resident slot
is read once a layer, where the reference's per-lane gather of `A[idx]`,
`B[idx]` moves a copy of an adapter for every lane. The zeroed columns
contribute exact zeros, so the result is the reference's per-lane product.

Rounding points are the reference's: `h @ A` comes out in the model dtype,
the `@ B` product too; it is scaled by `alpha / r` in f32 and cast to the
model dtype; that delta is added to the base projection's output.

Checkpoint format: HF PEFT exports (adapter_config.json +
adapter_model.safetensors, or adapter_model*.bin) with q/k/v/o_proj
targets, read through models/safetensors_io.py.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

TARGETS = ("wq", "wk", "wv", "wo")
_PEFT_NAMES = {"q_proj": "wq", "k_proj": "wk", "v_proj": "wv", "o_proj": "wo"}


@dataclass
class LoraAdapter:
    """One adapter: per-target (A [L, in, r], B [L, r, out]) host tensors
    in the model dtype, and its scaling alpha / r."""

    name: str
    rank: int
    scale: float  # alpha / rank
    a: Dict[str, torch.Tensor] = field(default_factory=dict)
    b: Dict[str, torch.Tensor] = field(default_factory=dict)


def target_dims(config) -> Dict[str, Tuple[int, int]]:
    """(in, out) widths per projection for a llama-family config."""
    q_dim = config.num_heads * config.head_dim
    kv_dim = config.num_kv_heads * config.head_dim
    H = config.hidden_size
    return {"wq": (H, q_dim), "wk": (H, kv_dim), "wv": (H, kv_dim),
            "wo": (q_dim, H)}


def init_adapter(config, name: str, generator: torch.Generator, rank: int = 8,
                 scale: float = 1.0, targets: Sequence[str] = TARGETS) -> LoraAdapter:
    """Random adapter with a non-zero delta (tests, `--lora NAME=random:SEED`):
    A and B drawn from `generator` (a CPU generator, so the same seed gives
    the same adapter on every device) as N(0, 1) * 0.05 in f32, then cast.
    Draw order: A then B of each target in `targets` order."""
    c = config
    dims = target_dims(c)
    ad = LoraAdapter(name=name, rank=rank, scale=scale)
    for t in targets:
        din, dout = dims[t]
        ad.a[t] = (torch.randn((c.num_layers, din, rank), generator=generator)
                   * 0.05).to(c.dtype)
        ad.b[t] = (torch.randn((c.num_layers, rank, dout), generator=generator)
                   * 0.05).to(c.dtype)
    return ad


def _read_state(d: Path, path: str) -> Dict[str, torch.Tensor]:
    st = d / "adapter_model.safetensors"
    if st.exists():
        from .safetensors_io import SafetensorsFile

        f = SafetensorsFile(st)
        return {k: f.get(k) for k in f.keys()}
    bins = sorted(d.glob("adapter_model*.bin"))
    if not bins:
        raise FileNotFoundError(f"no adapter weights under {path}")
    return dict(torch.load(str(bins[0]), map_location="cpu", weights_only=True))


def load_peft_adapter(path: str, config, name: Optional[str] = None) -> LoraAdapter:
    """Load an HF PEFT export directory. PEFT stores per layer lora_A.weight
    [r, in] and lora_B.weight [out, r]; delta = (alpha / r) * B @ A. The
    tensors are transposed to [in, r] / [r, out] and cast to the model
    dtype (through f32)."""
    d = Path(path)
    cfg = json.loads((d / "adapter_config.json").read_text())
    rank = int(cfg.get("r", 8))
    alpha = float(cfg.get("lora_alpha", rank))
    state = _read_state(d, path)
    c = config
    ad = LoraAdapter(name=name or d.name, rank=rank, scale=alpha / rank)
    dims = target_dims(c)
    for peft_t, t in _PEFT_NAMES.items():
        a_rows, b_rows = [], []
        for li in range(c.num_layers):
            a_key = next(
                (k for k in state
                 if f"layers.{li}." in k and peft_t in k and "lora_A" in k),
                None,
            )
            if a_key is None:
                break
            b_key = a_key.replace("lora_A", "lora_B")
            # PEFT A [r, in] -> ours [in, r]; B [out, r] -> [r, out]
            a_rows.append(state[a_key].float().T)
            b_rows.append(state[b_key].float().T)
        if not a_rows:
            continue
        if len(a_rows) != c.num_layers:
            raise ValueError(
                f"adapter {ad.name!r}: target {peft_t} present for "
                f"{len(a_rows)}/{c.num_layers} layers"
            )
        din, dout = dims[t]
        a = torch.stack(a_rows)
        b = torch.stack(b_rows)
        if tuple(a.shape) != (c.num_layers, din, rank) or tuple(b.shape) != (
            c.num_layers, rank, dout
        ):
            raise ValueError(
                f"adapter {ad.name!r} target {t}: shapes {tuple(a.shape)}/"
                f"{tuple(b.shape)} do not match model dims ({din}/{dout}, r={rank})"
            )
        ad.a[t] = a.to(c.dtype)
        ad.b[t] = b.to(c.dtype)
    if not ad.a:
        raise ValueError(f"adapter {ad.name!r} has no supported targets")
    return ad


def empty_stack(config, n_slots: int, rank: int, device="cpu") -> Dict[str, Any]:
    """An all-zero stack of `n_slots` slots (slot 0 included) at `rank`:
    {"a": {t: [L, in, N, r]}, "b": {t: [L, N, r, out]}, "scale": [N] f32
    (ones), "names": {}}."""
    c = config
    dims = target_dims(c)
    L = c.num_layers
    return {
        "a": {t: torch.zeros((L, dims[t][0], n_slots, rank), dtype=c.dtype, device=device)
              for t in TARGETS},
        "b": {t: torch.zeros((L, n_slots, rank, dims[t][1]), dtype=c.dtype, device=device)
              for t in TARGETS},
        "scale": torch.ones((n_slots,), dtype=torch.float32, device=device),
        "names": {},
    }


def padded(ad: LoraAdapter, t: str, rank: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Target `t` of `ad` zero-padded to `rank` (zero ranks are exact
    no-ops): (A [L, in, rank], B [L, rank, out]) on the host."""
    A, B = ad.a[t], ad.b[t]
    if ad.rank == rank:
        return A, B
    L, din, _ = A.shape
    Ap = torch.zeros((L, din, rank), dtype=A.dtype)
    Bp = torch.zeros((L, rank, B.shape[-1]), dtype=B.dtype)
    Ap[:, :, : ad.rank] = A
    Bp[:, : ad.rank, :] = B
    return Ap, Bp


def stack_adapters(config, adapters: List[LoraAdapter], device="cpu") -> Dict[str, Any]:
    """Adapters -> a device stack. Slot 0 is the all-zero base adapter;
    slot i+1 = adapters[i]. Ranks are zero-padded to the largest; a target
    an adapter lacks stays zero. Returns {"a": {t: [L, in, N, r]}, "b":
    {t: [L, N, r, out]}, "scale": [N] f32, "names": {name: slot}}."""
    r_max = max([a.rank for a in adapters], default=1)
    stack = empty_stack(config, len(adapters) + 1, r_max, device)
    for i, ad in enumerate(adapters):
        for t in ad.a:
            A, B = padded(ad, t, r_max)
            stack["a"][t][:, :, i + 1, :] = A.to(device)
            stack["b"][t][:, i + 1, :, :] = B.to(device)
        stack["scale"][i + 1] = ad.scale
        stack["names"][ad.name] = i + 1
    return stack


def _bind(idx: torch.Tensor, n_slots: int, rank: int, dtype, scale: torch.Tensor):
    """(column mask [T, N*r] in `dtype`: 1 on the r columns of each row's
    slot; row scale [T, 1] f32) for the slot index `idx` of each row."""
    col_slot = torch.arange(n_slots, device=idx.device).repeat_interleave(rank)
    idx = idx.reshape(-1).long()
    return (col_slot[None, :] == idx[:, None]).to(dtype), scale[idx][:, None]


def lora_rows(lora: Dict[str, Any], idx: torch.Tensor) -> Dict[str, Any]:
    """Bind a stack to the slot index of each token row `idx` [T]: the
    column mask and the row scale are computed once a forward, and every
    layer reuses them."""
    A0 = next(iter(lora["a"].values()))
    mask, srow = _bind(idx, A0.shape[-2], A0.shape[-1], A0.dtype, lora["scale"])
    return {"a": lora["a"], "b": lora["b"], "mask": mask, "srow": srow}


def layer_lora(rows: Optional[Dict[str, Any]], li: int) -> Optional[Dict[str, Any]]:
    """Layer `li` of a bound stack: {"a": {t: [in, N*r]}, "b": {t: [N*r,
    out]}, "mask", "srow"} (views of the stack)."""
    if rows is None:
        return None
    return {
        "a": {t: v[li].reshape(v.shape[1], -1) for t, v in rows["a"].items()},
        "b": {t: v[li].reshape(-1, v.shape[-1]) for t, v in rows["b"].items()},
        "mask": rows["mask"],
        "srow": rows["srow"],
    }


def _delta(h2: torch.Tensor, A: torch.Tensor, B: torch.Tensor, mask: torch.Tensor,
           srow: torch.Tensor) -> torch.Tensor:
    """[T, in] -> [T, out] in h2's dtype: ((h2 @ A) * mask) @ B, scaled in
    f32 and cast."""
    d = torch.mm(h2, A)
    d.mul_(mask)
    e = torch.mm(d, B)
    return torch.mul(e, srow, out=torch.empty_like(e))


def lora_delta(h: torch.Tensor, stack_a: torch.Tensor, stack_b: torch.Tensor,
               idx: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Per-lane low-rank delta of one layer's projection:
    scale[idx] * (h @ A[idx]) @ B[idx], in h's dtype.

    h [B, in] or [B, T, in]; stack_a [in, N, r] and stack_b [N, r, out]
    (one layer of the stack); idx [B] lane -> slot; scale [N] f32."""
    lead = h.shape[:-1]
    tok_idx = idx.reshape(-1, *([1] * (h.dim() - 2))).expand(lead)
    mask, srow = _bind(tok_idx, stack_a.shape[1], stack_a.shape[2], stack_a.dtype, scale)
    out = _delta(h.reshape(-1, h.shape[-1]), stack_a.reshape(stack_a.shape[0], -1),
                 stack_b.reshape(-1, stack_b.shape[-1]), mask, srow)
    return out.reshape(*lead, -1)


def proj(h: torch.Tensor, y: torch.Tensor, lora_layer: Optional[Dict[str, Any]],
         target: str) -> torch.Tensor:
    """Add the per-row LoRA delta of `target` to the base projection's
    output `y` (= h @ w) in place; `y` as it is without a bound stack."""
    if lora_layer is None or target not in lora_layer["a"]:
        return y
    delta = _delta(h.reshape(-1, h.shape[-1]), lora_layer["a"][target],
                   lora_layer["b"][target], lora_layer["mask"], lora_layer["srow"])
    return y.add_(delta.view(y.shape))
