"""Hopper kernel wrapper: one-token flash decode over paged KV.

The kernel (csrc/paged_decode.cu) replaces the TPU kernel
`dynamo_tpu/ops/pallas_paged_attention.py:_decode_kernel`. It is bound by
bytes on this card — each lane's real context K and V read once — so the
design gives every (lane, KV head) one block that reads only that lane's
real pages and shares them among the G query heads of the group. An
int8/int4 pool (a per-layer `QuantKV`) is dequantized while each tile is
staged, in place of the TPU kernel's `_window_dequant`.
The plain PyTorch version is `ops.paged_attention.paged_attention_decode_plain`.
"""

from __future__ import annotations

import torch

from . import _build

launch_count = 0  # kernel launches made through this wrapper
launches_by_format = dict.fromkeys(_build.KV_FORMATS, 0)  # the same, by KV format


def paged_attention_decode_hopper(
    q: torch.Tensor,  # [B, H, D]
    kv_k_layer,  # [pages, page_size, KH, D] tensor, or per-layer QuantKV
    kv_v_layer,
    page_tables: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B] int32 (including the current token)
) -> torch.Tensor:
    """Launch the decode kernel on the current stream; returns [B, H, D]."""
    global launch_count
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], is {tuple(q.shape)}")
    B, H, D = q.shape
    code = _build.dtype_code(q)
    kv, KH, page_size, fmt = _build.kv_args(q, kv_k_layer, kv_v_layer, page_tables, B)
    _build.check_index_vector("seq_lens", seq_lens, B, q.device)
    lib = _build.load_library()
    out = torch.empty_like(q)
    rc = lib.dyn_paged_decode(
        out.data_ptr(), q.data_ptr(), *kv, seq_lens.data_ptr(),
        B, H, KH, D, page_size, code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_status(lib, rc, "paged decode")
    launch_count += 1
    launches_by_format[fmt] += 1
    return out
