"""Hopper kernel wrapper: decode over a read-only pool plus a block-local buffer.

The kernel (csrc/paged_decode_local.cu) replaces the TPU kernel
`dynamo_tpu/ops/pallas_paged_attention.py:_decode_local_kernel`. It is
bound by bytes on this card, as the decode kernel, and runs the same
split-KV body (csrc/flash_decode.cuh): a lane's pool pages are cut into
splits that a grid sized to the card walks (dequantized in registers for
an int8/int4 pool), and its K block-local rows are one more tile of its
last split, all in one online softmax and one launch. The split plan and
the scratch come from `hopper_paged_attention.split_args`, from shapes
alone: `step_idx` and `pool_lens` stay on the device, so the launch needs
no host value that changes from step to step, and a call allocates only its
output. The plain PyTorch version is
`ops.paged_attention.paged_attention_decode_mixed_plain`.
"""

from __future__ import annotations

import torch

from . import _build
from .hopper_paged_attention import split_args

launch_count = 0  # kernel launches made through this wrapper
launches_by_format = dict.fromkeys(_build.KV_FORMATS, 0)  # the same, by KV format
last_splits = 0  # splits per (lane, KV head) of the last launch


def paged_attention_decode_local_hopper(
    q: torch.Tensor,  # [B, H, D]
    kv_k_layer,  # [pages, page_size, KH, D] tensor, or per-layer QuantKV
    kv_v_layer,
    page_tables: torch.Tensor,  # [B, max_pages] int32
    pool_lens: torch.Tensor,  # [B] int32 positions valid in the pool
    loc_k: torch.Tensor,  # [B, K, KH, D] block-local keys, q's dtype
    loc_v: torch.Tensor,
    step_idx: torch.Tensor,  # [1] int32 on the device: entries 0..step_idx valid
) -> torch.Tensor:
    """Launch the local decode kernel on the current stream; returns [B, H, D]."""
    global launch_count, last_splits
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], is {tuple(q.shape)}")
    B, H, D = q.shape
    code = _build.dtype_code(q)
    kv, KH, page_size, fmt = _build.kv_args(q, kv_k_layer, kv_v_layer, page_tables, B)
    _build.check_index_vector("pool_lens", pool_lens, B, q.device)
    K = loc_k.shape[1] if loc_k.dim() == 4 else 0
    for name, t in (("loc_k", loc_k), ("loc_v", loc_v)):
        _build.check_dense(name, t, q.dtype)
        if t.shape != (B, K, KH, D) or t.device != q.device:
            raise ValueError(f"{name} must be [{B}, K, {KH}, {D}] on {q.device}, "
                             f"is {tuple(t.shape)}")
    if not 1 <= K <= 64:
        raise ValueError(f"block-local length K={K}: want 1..64")
    if not (step_idx.is_cuda and step_idx.dtype == torch.int32 and step_idx.numel() == 1
            and step_idx.device == q.device):
        raise ValueError("step_idx must be a one-element int32 tensor on q's device")
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    plan = split_args(q.device, stream, B, H, KH, D, page_tables.shape[1], page_size)
    out = torch.empty_like(q)
    rc = lib.dyn_paged_decode_local(
        out.data_ptr(), q.data_ptr(), *kv, pool_lens.data_ptr(),
        loc_k.data_ptr(), loc_v.data_ptr(), K, step_idx.data_ptr(),
        B, H, KH, D, page_size, code, *plan, stream,
    )
    _build.check_status(lib, rc, "paged decode local")
    launch_count += 1
    launches_by_format[fmt] += 1
    last_splits = plan[0]
    return out
