"""Matrix-product helpers shared by the model code.

Port of the unquantized form of `dynamo_tpu/models/quant.py` (`qdot`,
`embed_rows`, `head_leaf`); int8 weight-only quantization is not ported.

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
