"""Hopper kernel wrapper: batched chunked-prefill flash attention.

The kernel (csrc/prefill_attention.cu) replaces the TPU kernel
`dynamo_tpu/ops/pallas_prefill_attention.py:_prefill_kernel`. It is bound
by its products at the engine's chunk sizes. bf16 queries run the
tensor-core body (csrc/flash_mma.cuh: mma.sync with cp.async
double-buffered K/V tiles, floor(64 / G) query tokens x G heads a block);
f32 queries the FMA body (csrc/flash_paged.cuh, 16 tokens a block). Each
block stops at its own causal limit and never reads pages past it. An
int8/int4 pool is dequantized after each tile is staged (the TPU reference
had no quantized prefill kernel). The plain PyTorch version is
`ops.paged_attention.prefill_attention_batched_plain`.
"""

from __future__ import annotations

import torch

from . import _build

launch_count = 0  # kernel launches made through this wrapper
launches_by_format = dict.fromkeys(_build.KV_FORMATS, 0)  # the same, by KV format


def prefill_attention_batched_hopper(
    q: torch.Tensor,  # [B, T, H, D] (rope applied; chunk KV already in pages)
    kv_k_layer,  # [pages, page_size, KH, D] tensor, or per-layer QuantKV
    kv_v_layer,
    page_tables: torch.Tensor,  # [B, max_pages] int32
    starts: torch.Tensor,  # [B] int32 absolute position of each chunk's row 0
    total_lens: torch.Tensor,  # [B] int32 valid context (history + real chunk)
) -> torch.Tensor:
    """Launch the prefill kernel on the current stream; returns [B, T, H, D]."""
    global launch_count
    if q.dim() != 4:
        raise ValueError(f"q must be [B, T, H, D], is {tuple(q.shape)}")
    B, T, H, D = q.shape
    code = _build.dtype_code(q)
    kv, KH, page_size, fmt = _build.kv_args(q, kv_k_layer, kv_v_layer, page_tables, B)
    _build.check_index_vector("starts", starts, B, q.device)
    _build.check_index_vector("total_lens", total_lens, B, q.device)
    lib = _build.load_library()
    out = torch.empty_like(q)
    rc = lib.dyn_prefill_attention(
        out.data_ptr(), q.data_ptr(), *kv, starts.data_ptr(),
        total_lens.data_ptr(), B, T, H, KH, D, page_size, code,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_status(lib, rc, "prefill attention")
    launch_count += 1
    launches_by_format[fmt] += 1
    return out
