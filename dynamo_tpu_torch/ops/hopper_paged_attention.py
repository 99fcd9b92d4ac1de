"""Hopper kernel wrapper: one-token flash decode over paged KV, split over the grid.

The kernel (csrc/paged_decode.cu, body csrc/flash_decode.cuh) replaces the
TPU kernel `dynamo_tpu/ops/pallas_paged_attention.py:_decode_kernel`. It
is bound by bytes on this card — each lane's real context K and V read
once — so each lane's pages are cut into splits of a fixed run of pages,
and a grid sized to what the card holds at once walks the live (split,
KV head, lane) items, which every block lists from `seq_lens` on the card:
a few long lanes still fill the SMs, and short lanes cost no block. Raw
tiles (bf16/f32, or int8/int4 bytes dequantized in registers, in place of
the TPU kernel's `_window_dequant`) stream through a cp.async ring; lanes
that used more than one split are combined, in the same launch, by the
last of their splits' blocks to finish. The split plan comes from shapes
the host holds (never from `seq_lens`), and is kept per shape; the scratch
for partial results and the arrival counters come from torch's caching
allocator, once per stream (a stream's calls run in order, and every
launch leaves the counters at zero), so a call allocates nothing but its
output. The local decode kernel (`hopper_paged_attention_local`) runs the
same body and plans, and takes its scratch, through `split_args` here.
The plain PyTorch version is `ops.paged_attention.paged_attention_decode_plain`.
"""

from __future__ import annotations

import torch

from . import _build

launch_count = 0  # kernel launches made through this wrapper
launches_by_format = dict.fromkeys(_build.KV_FORMATS, 0)  # the same, by KV format
last_splits = 0  # splits per (lane, KV head) of the last launch

SPLIT_MIN_KEYS = 512  # a split covers at least this many keys
ITEMS_PER_SM = 64  # and B * KH splits of the whole table at most about this many an SM

_sm_count: dict = {}
_plans: dict = {}  # (device, B, KH, max_pages, page_size) -> (split_pages, n_splits, sms)
_scratch: dict = {}  # (device, stream) -> (f32 partials, int32 arrival counters)


def split_plan(B: int, KH: int, max_pages: int, page_size: int, sms: int) -> tuple:
    """(split_pages, n_splits): runs of whole pages of at least
    SPLIT_MIN_KEYS keys, grown until B * KH full tables' splits (the most
    items, and partial results, a launch can have) come to at most
    ITEMS_PER_SM an SM before rounding up to whole splits."""
    pages = max(1, -(-SPLIT_MIN_KEYS // page_size),
                -(-(B * KH * max_pages) // (ITEMS_PER_SM * sms)))
    pages = min(pages, max_pages)
    return pages, -(-max_pages // pages)


def _sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def _plan(device: torch.device, B: int, KH: int, max_pages: int, page_size: int) -> tuple:
    key = (device.index, B, KH, max_pages, page_size)
    plan = _plans.get(key)
    if plan is None:
        sms = _sms(device)
        plan = _plans[key] = (*split_plan(B, KH, max_pages, page_size, sms), sms)
    return plan


def _scratch_for(device: torch.device, stream: int, n_ws: int, n_counters: int) -> tuple:
    """This stream's scratch, grown to n_ws floats and n_counters zeros."""
    ws, counters = _scratch.get((device.index, stream), (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty(n_ws, dtype=torch.float32, device=device)
    if counters is None or counters.numel() < n_counters:
        counters = torch.zeros(n_counters, dtype=torch.int32, device=device)
    _scratch[(device.index, stream)] = (ws, counters)
    return ws, counters


def split_args(device: torch.device, stream: int, B: int, H: int, KH: int, D: int,
               max_pages: int, page_size: int) -> tuple:
    """The split plan and scratch of one launch of a split-KV decode
    kernel: (n_splits, split_pages, ws_o, ws_ml, counters, sms), the three
    scratch pointers None when one split covers the table. Only shapes go
    in, so nothing depends on a value held on the card."""
    if max_pages < 1:
        raise ValueError("page_tables must have at least one column")
    split_pages, n_splits, sms = _plan(device, B, KH, max_pages, page_size)
    ws_o = ws_ml = counters = None
    if n_splits > 1:
        # partial O [B, KH, n_splits, G, D], then (m, l) [B, KH, n_splits, G, 2]
        rows = B * H * n_splits
        ws, cnt = _scratch_for(device, stream, rows * (D + 2), B * KH)
        ws_o = ws.data_ptr()
        ws_ml = ws_o + 4 * rows * D
        counters = cnt.data_ptr()
    return n_splits, split_pages, ws_o, ws_ml, counters, sms


def paged_attention_decode_hopper(
    q: torch.Tensor,  # [B, H, D]
    kv_k_layer,  # [pages, page_size, KH, D] tensor, or per-layer QuantKV
    kv_v_layer,
    page_tables: torch.Tensor,  # [B, max_pages] int32
    seq_lens: torch.Tensor,  # [B] int32 (including the current token)
) -> torch.Tensor:
    """Launch the decode kernel on the current stream; returns [B, H, D]."""
    global launch_count, last_splits
    if q.dim() != 3:
        raise ValueError(f"q must be [B, H, D], is {tuple(q.shape)}")
    B, H, D = q.shape
    code = _build.dtype_code(q)
    kv, KH, page_size, fmt = _build.kv_args(q, kv_k_layer, kv_v_layer, page_tables, B)
    _build.check_index_vector("seq_lens", seq_lens, B, q.device)
    lib = _build.load_library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    plan = split_args(q.device, stream, B, H, KH, D, page_tables.shape[1], page_size)
    out = torch.empty_like(q)
    rc = lib.dyn_paged_decode(
        out.data_ptr(), q.data_ptr(), *kv, seq_lens.data_ptr(),
        B, H, KH, D, page_size, code, *plan, stream,
    )
    _build.check_status(lib, rc, "paged decode")
    launch_count += 1
    launches_by_format[fmt] += 1
    last_splits = plan[0]
    return out
