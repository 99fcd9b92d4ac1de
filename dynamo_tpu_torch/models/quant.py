"""Matrix-product helpers shared by the model code.

Port of the unquantized form of `dynamo_tpu/models/quant.py` (`qdot`,
`embed_rows`, `head_leaf`) and of the symmetric-range primitives the
quantized KV cache shares with it (`QMAX`, `pack_int4`, `unpack_int4`);
int8 weight-only quantization is not ported.

Where the two frameworks differ: the reference's `qdot` returns f32 from
bf16 operands (f32 accumulation AND f32 output) and the caller casts.
`torch.matmul` on bf16 accumulates in f32 but rounds its OUTPUT to bf16.
So `qdot` takes the output type explicitly: the default is the operands'
type (the same value as the reference's product followed by its cast),
and `out_dtype=torch.float32` keeps an f32 output — used for the LM head,
whose logits the reference keeps in f32. In f32 models the two coincide.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch


def qdot(x: torch.Tensor, w: torch.Tensor,
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x [..., in] @ w [in, out] with f32 accumulation; the output has
    x's dtype, or `out_dtype` when given."""
    if out_dtype is None or out_dtype == x.dtype:
        return torch.matmul(x, w)
    if x.is_cuda:
        # one GEMM with a wider output (cuBLAS accumulates in f32 anyway)
        lead = x.shape[:-1]
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=out_dtype)
        return y.reshape(*lead, w.shape[-1])
    return torch.matmul(x.to(out_dtype), w.to(out_dtype))


QMAX = {8: 127, 4: 7}  # symmetric ranges: int8 [-127,127], int4 [-7,7]


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


def embed_rows(embed: torch.Tensor, tokens: torch.Tensor, dtype=None) -> torch.Tensor:
    """Embedding gather."""
    return embed[tokens.long()]


def head_leaf(params: Dict[str, Any]) -> torch.Tensor:
    """The LM head operand for qdot: lm_head when present, else the tied
    embedding transposed (a view)."""
    lm = params.get("lm_head")
    if lm is not None:
        return lm
    return params["embed"].t()
