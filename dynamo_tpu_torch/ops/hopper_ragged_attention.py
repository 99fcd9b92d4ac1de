"""Hopper kernel wrapper: ragged paged attention over mixed prefill+decode rows.

The kernel (csrc/ragged_attention.cu) replaces the TPU kernel
`dynamo_tpu/ops/pallas_ragged_attention.py:_ragged_kernel`. Chunk rows are
bound by their products, one-token rows by the bytes of their context.
bf16 queries run the tensor-core body (csrc/flash_mma.cuh), f32 queries
the FMA body (csrc/flash_paged.cuh). Each block finds its own row from the
row lengths, so rows need no alignment in the flat buffer:
`ragged_tile_q()` is 1 and the engine's mixed packer packs densely. An
int8/int4 pool is dequantized after each tile is staged, in place of the
TPU kernel's `dequant_window`. The plain PyTorch version is
`ops.paged_attention.ragged_attention_plain`.
"""

from __future__ import annotations

import torch

from . import _build

launch_count = 0  # kernel launches made through this wrapper
launches_by_format = dict.fromkeys(_build.KV_FORMATS, 0)  # the same, by KV format


def ragged_tile_q(dtype=None) -> int:
    """Row-start alignment the mixed packer must honour for this kernel."""
    return 1


def ragged_attention_hopper(
    q: torch.Tensor,  # [N, H, D] flat packed tokens (rope applied)
    kv_k_layer,  # [pages, page_size, KH, D] tensor, or per-layer QuantKV
    kv_v_layer,
    page_tables: torch.Tensor,  # [R, max_pages] int32
    row_starts: torch.Tensor,  # [R] int32 flat index of each row's token 0
    row_lens: torch.Tensor,  # [R] int32 real tokens per row (0 = padding row)
    ctx_lens: torch.Tensor,  # [R] int32 history length before each row
) -> torch.Tensor:
    """Launch the ragged kernel on the current stream; returns [N, H, D].
    Flat tokens outside every row come back as zeros."""
    global launch_count
    if q.dim() != 3:
        raise ValueError(f"q must be [N, H, D], is {tuple(q.shape)}")
    N, H, D = q.shape
    R = page_tables.shape[0]
    code = _build.dtype_code(q)
    kv, KH, page_size, fmt = _build.kv_args(q, kv_k_layer, kv_v_layer, page_tables, R)
    for name, t in (("row_starts", row_starts), ("row_lens", row_lens),
                    ("ctx_lens", ctx_lens)):
        _build.check_index_vector(name, t, R, q.device)
    lib = _build.load_library()
    # zeros, not empty: the kernel writes only tokens that belong to a row,
    # and padding tokens must stay finite (they flow on through the layer)
    out = torch.zeros_like(q)
    rc = lib.dyn_ragged_attention(
        out.data_ptr(), q.data_ptr(), *kv, row_starts.data_ptr(),
        row_lens.data_ptr(), ctx_lens.data_ptr(), N, R, H, KH, D, page_size,
        code, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check_status(lib, rc, "ragged attention")
    launch_count += 1
    launches_by_format[fmt] += 1
    return out
