"""Matrix products over raw or int8 weight-only quantized weights.

Port of `dynamo_tpu/models/quant.py` (all but the mesh-only
`scale_sharding`): the symmetric-range primitives the quantized KV cache
shares (`QMAX`, `pack_int4`, `unpack_int4`), and int8 weight-only
quantization of the llama and MoE trees, expert stacks included.

A quantized leaf is the reference's pytree node
    {"q": int8 [..., in, out], "s": float32 [..., 1, out]}
(per-output-channel symmetric scale over the contraction axis, kept as a
singleton so it broadcasts against the product for any leading layer
dims). The embedding is quantized per ROW (`s` [V, 1]): rows gather as
output vectors, and its transpose is the tied LM head with a per-out-
channel scale [1, V] (`head_leaf`).

Where the two frameworks differ: the reference's `qdot` returns f32 from
bf16 operands (f32 accumulation AND f32 output) and the caller casts.
`torch.matmul` on bf16 accumulates in f32 but rounds its OUTPUT to bf16.
So `qdot` takes the output type explicitly: the default is the operands'
type (the same value as the reference's product followed by its cast),
and `out_dtype=torch.float32` keeps an f32 output — used for the LM head,
whose logits the reference keeps in f32. In f32 models the two coincide.
For a quantized leaf the product is taken with an f32 output, multiplied
by the scale, and only then cast: the scale multiplies the f32 accumulator
before any rounding, as in the reference. The int8 operand is widened to
the activations' type (exact: |q| <= 127) ahead of an ordinary GEMM, in
eager torch ops; a fused weight-only int8 GEMM is future work.

The MoE expert product `qeinsum` keeps the reference's f32 output in both
branches (its `preferred_element_type=f32`): a batched product over the
expert axis whose quantized stack's scale `[E, 1, out]` multiplies the f32
result. On the card a bf16 `bmm` writes that f32 output straight from its
f32 accumulator (`out_dtype`), as XLA does; on the CPU the bf16 operands
are widened to f32 first, which is exact.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

QMAX = {8: 127, 4: 7}  # symmetric ranges: int8 [-127,127], int4 [-7,7]

# leaves of the llama tree that quantize per out-channel over the
# contraction axis -2; embed is special-cased (per-row scale, axis -1)
_LAYER_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# f32 elements quantized at once when a leaf is quantized slice by slice
_CHUNK_ELEMS = 1 << 26


def symmetric_scale(amax, bits: int = 8, eps: float = 1e-8):
    """Scale s such that clip(round(x/s)) covers [-amax, amax] in the
    `bits`-bit symmetric range (numpy or torch, as given)."""
    if isinstance(amax, np.ndarray):
        return np.maximum(amax, eps) / QMAX[bits]
    return torch.clamp(amax, min=eps) / QMAX[bits]


def quantize_symmetric(x, s, bits: int = 8):
    """round(x/s) clipped to the symmetric `bits`-bit range, as int8 values
    (round half to even, as numpy and XLA round). `s` broadcasts."""
    if isinstance(x, np.ndarray):
        return np.clip(np.round(x / s), -QMAX[bits], QMAX[bits]).astype(np.int8)
    return torch.clamp(torch.round(x / s), -QMAX[bits], QMAX[bits]).to(torch.int8)


def dequantize_symmetric(q: torch.Tensor, s: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """q * s in f32, cast to `dtype`."""
    return (q.to(torch.float32) * s).to(dtype)


def pack_int4(q: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Pack int4 values (int8 storage, range [-7,7]) two to a byte along
    `axis`, pairing index i with i + n/2: byte = (q[i] & 0xF) | (q[i+n/2]
    << 4), so unpack_int4's concat(lo, hi) restores the original order.
    `axis` length must be even."""
    n = q.shape[axis]
    lo, hi = torch.split(q, n // 2, dim=axis)
    return (lo & 0x0F) | (hi << 4)


def unpack_int4(packed: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """Inverse of pack_int4: sign-extend both nibbles (arithmetic shifts on
    int8) and concatenate along `axis`, low half first."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.cat([lo, hi], dim=axis)


def is_quant(leaf: Any) -> bool:
    return isinstance(leaf, dict) and "q" in leaf and "s" in leaf


def quantize_array(w, contract_axis: int = -2) -> Dict[str, Any]:
    """Symmetric int8 with a per-channel f32 scale over `contract_axis`
    (kept as a singleton dim). numpy in, numpy out; torch in, torch out on
    the tensor's device."""
    if isinstance(w, np.ndarray):
        wf = np.asarray(w, dtype=np.float32)
        amax = np.max(np.abs(wf), axis=contract_axis, keepdims=True)
    else:
        wf = w.to(torch.float32)
        amax = wf.abs().amax(dim=contract_axis, keepdim=True)
    s = symmetric_scale(amax, bits=8)
    q = quantize_symmetric(wf, s, bits=8)
    if isinstance(w, np.ndarray):
        return {"q": q, "s": s.astype(np.float32)}
    return {"q": q, "s": s.to(torch.float32)}


def quantize_into(q_out: torch.Tensor, s_out: torch.Tensor, w: torch.Tensor,
                  contract_axis: int = -2) -> None:
    """`quantize_array(w)` written into preallocated `q_out` / `s_out`, in
    slices along a kept axis of a 2-D `w`, so the f32 transient stays near
    `_CHUNK_ELEMS` elements whatever the matrix's size (the values equal
    the whole-matrix call's: each channel's amax lies inside one slice)."""
    keep = 1 if contract_axis in (-2, 0) else 0  # the axis the scales run along
    n = w.shape[keep]
    step = max(1, _CHUNK_ELEMS // max(1, w.shape[1 - keep]))
    for a in range(0, n, step):
        part = w.narrow(keep, a, min(step, n - a))
        ql = quantize_array(part, contract_axis=contract_axis)
        q_out.narrow(keep, a, part.shape[keep]).copy_(ql["q"])
        s_out.narrow(keep, a, part.shape[keep]).copy_(ql["s"])


def empty_quant(shape, device, contract_axis: int = -2) -> Dict[str, torch.Tensor]:
    """An uninitialised quantized leaf of `shape`: int8 ints and f32 scales
    with `contract_axis` kept as a singleton."""
    s_shape = list(shape)
    s_shape[contract_axis] = 1
    return {"q": torch.empty(tuple(shape), dtype=torch.int8, device=device),
            "s": torch.empty(tuple(s_shape), dtype=torch.float32, device=device)}


def _quantize_leaf(w: torch.Tensor, contract_axis: int = -2) -> Dict[str, torch.Tensor]:
    """A torch leaf ([in, out], layer-stacked [L, in, out], or an expert
    stack [L, E, in, out]) quantized one matrix at a time into int8 and f32
    leaves on its device."""
    out = empty_quant(w.shape, w.device, contract_axis)
    for idx in np.ndindex(*w.shape[:-2]):
        quantize_into(out["q"][idx], out["s"][idx], w[idx], contract_axis)
    return out


def dequantize_leaf(leaf, dtype=torch.bfloat16):
    """A quantized leaf as q * s in `dtype`; any other leaf as it is."""
    if not is_quant(leaf):
        return leaf
    return dequantize_symmetric(leaf["q"], leaf["s"], dtype)


def qdot(x: torch.Tensor, w, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] with f32 accumulation; `w` a tensor or a
    quantized leaf. The output has x's dtype, or `out_dtype` when given."""
    out_dtype = out_dtype or x.dtype
    if is_quant(w):
        # s [..., 1, out] loses its contraction singleton to broadcast
        return (_mm_f32(x, w["q"].to(x.dtype)) * w["s"].squeeze(-2)).to(out_dtype)
    if out_dtype == x.dtype:
        return torch.matmul(x, w)
    return _mm_f32(x, w).to(out_dtype)


# the expert products of models/moe.py: x [E, C, in] @ w [E, in, out]
_BMM_SPECS = ("ech,ehi->eci", "eci,eih->ech")


def qeinsum(spec: str, x: torch.Tensor, w) -> torch.Tensor:
    """The reference's `qeinsum` for the expert products (`spec` one of
    _BMM_SPECS): a batched product over the expert axis with an f32 output,
    `w` a tensor or a quantized stack whose scale [E, 1, out] multiplies
    the f32 result."""
    if spec not in _BMM_SPECS:
        raise ValueError(f"qeinsum takes the expert products {_BMM_SPECS}, not {spec!r}")
    if is_quant(w):
        return _bmm_f32(x, w["q"].to(x.dtype)) * w["s"]
    return _bmm_f32(x, w)


def _bmm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, in] @ w [E, in, out] with an f32 output."""
    if x.dtype == torch.float32:
        return torch.bmm(x, w.float())
    if x.is_cuda:
        return torch.bmm(x, w, out_dtype=torch.float32)
    return torch.bmm(x.float(), w.float())


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., in] @ w [in, out] with an f32 output."""
    if x.dtype == torch.float32:
        return torch.matmul(x, w)
    if x.is_cuda:
        # one GEMM with a wider output (cuBLAS accumulates in f32 anyway)
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        return y.reshape(*lead, w.shape[-1])
    return torch.matmul(x.float(), w.float())


def embed_rows(embed, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding gather; a quantized table gathers its rows and their
    per-row scales and dequantizes them to `dtype`. Ids past the table are
    clamped to its last row, as XLA's gather clamps them in the reference:
    a multimodal placeholder id drawn from a frontend tokenizer's larger
    vocabulary reads a row the splice then replaces."""
    rows = (embed["q"] if is_quant(embed) else embed).shape[0]
    idx = tokens.long().clamp(max=rows - 1)
    if not is_quant(embed):
        return embed[idx]
    return (embed["q"][idx].to(torch.float32) * embed["s"][idx]).to(dtype)


def head_leaf(params: Dict[str, Any]):
    """The LM head operand for qdot: lm_head when present, else the tied
    (possibly quantized) embedding transposed (views) — a per-row embed
    scale [V, 1] transposes into a per-out-channel head scale [1, V]."""
    lm = params.get("lm_head")
    if lm is not None:
        return lm
    e = params["embed"]
    if not is_quant(e):
        return e.t()
    return {"q": e["q"].t(), "s": e["s"].t()}


def quantize_tree(params: Dict[str, Any], consume: bool = False) -> Dict[str, Any]:
    """Quantize a built (e.g. random-init) llama or MoE tree: projections
    and the MoE expert stacks [L, E, in, out] per out-channel (an expert
    stack's scale is [L, E, 1, out]), the embedding per row, lm_head per
    out-channel; norms and the f32 MoE router keep their dtype. Leaves are
    quantized one matrix at a time on their own device (numpy leaves stay
    numpy, whole).

    consume=True MUTATES `params`, dropping each source leaf as soon as its
    quantized form exists, so the full-precision tree is never resident
    beside the whole quantized one."""
    def quant(w, contract_axis=-2):
        if isinstance(w, np.ndarray):
            return quantize_array(w, contract_axis)
        return _quantize_leaf(w, contract_axis)

    out = dict(params)
    emb = params["embed"]
    if consume:
        params["embed"] = None
    out["embed"] = quant(emb, contract_axis=-1)
    del emb
    if params.get("lm_head") is not None:
        lm = params["lm_head"]
        if consume:
            params["lm_head"] = None
        out["lm_head"] = quant(lm)
        del lm
    src = params["layers"]
    layers = dict(src)
    for name in _LAYER_LEAVES:
        if name in layers and not is_quant(layers[name]) and layers[name].ndim in (3, 4):
            w = layers[name]
            if consume:
                src[name] = None
            layers[name] = quant(w)
            del w
    out["layers"] = layers
    return out


def leaf_bytes(leaf) -> int:
    """Bytes of a tensor, array or quantized leaf (ints plus scales)."""
    if leaf is None:
        return 0
    if is_quant(leaf):
        return leaf_bytes(leaf["q"]) + leaf_bytes(leaf["s"])
    if isinstance(leaf, np.ndarray):
        return int(leaf.nbytes)
    return leaf.numel() * leaf.element_size()


def param_bytes(params: Dict[str, Any]) -> int:
    """Bytes of a llama parameter tree as stored (quantized leaves count
    their ints and their scales)."""
    return sum(leaf_bytes(v) for v in (params["embed"], params["final_norm"],
                                       params.get("lm_head"), *params["layers"].values()))
