"""KV page store: allocation, per-layer views, page writes and the
quantized (int8/int4) page format.

Port of `dynamo_tpu/ops/kv_quant.py` (`resolve_kv_quant`, `QuantKV`,
`alloc_kv_store`, `kv_layer`, `kv_page_size`, `kernel_operands`,
`kv_write`, `kv_write_all_layers`, `gather_dequant`, and the host/wire
packing `host_pack_pages`, `host_unpack_pages`, `device_pages`), with the
engine's page gather and scatter (`extract_pages` / `inject_pages`, jitted
in the reference's `engine/engine.py`) beside them.

A full-precision store is one tensor [L, pages, page_size, KH, D]. A
quantized store is a `QuantKV`:

    q: int8 [L, pages, ps_eff, KH, D]  int4 packs two tokens per byte along
                                       the page axis (ps_eff = ps // 2),
                                       token o beside token o + ps/2: low
                                       nibble first half, high nibble second
    s: f32  [L, pages, KH]             one scale per page and KV head

Unlike the reference's functional scatter, every write here updates the
store IN PLACE and returns the same object, so the pool is never copied.
Physical page 0 is the engine's scratch page: callers route padding tokens,
inactive lanes and positions past the page table there.

Quantize-on-write (`kv_write`, the reference's discipline bit for bit):
  * a write at in-page offset 0 starts the page: its stale scale is dropped;
  * the page scale is the running max of amax / qmax over every write;
  * when the scale grows, the page's existing ints are requantized by
    round(q * old / new) (a started page's ratio is 0: its stale ints go);
  * the new values land through an int8 delta-add at their own byte, so
    duplicate pages within one write compose exactly (two's-complement
    wraparound is linear).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..models.quant import QMAX, pack_int4, unpack_int4

KV_QUANT_MODES = ("none", "int8", "int4")


def resolve_kv_quant(mode: Optional[str]) -> str:
    """EngineConfig.kv_quant (explicit) else DYN_KV_QUANT else "none"."""
    if mode is None:
        mode = os.environ.get("DYN_KV_QUANT") or "none"
    mode = str(mode).strip().lower() or "none"
    if mode not in KV_QUANT_MODES:
        raise ValueError(
            f"unknown KV quant mode {mode!r} (DYN_KV_QUANT / kv_quant); "
            f"expected one of {KV_QUANT_MODES}"
        )
    return mode


def kv_quant_bits(mode: str) -> int:
    """Bits per stored KV value; 0 = full precision."""
    return {"none": 0, "int8": 8, "int4": 4}[mode]


class QuantKV:
    """Quantized KV store (see the module docstring): int8 `q`, f32 `s`,
    and the format (`bits`, logical `page_size`)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, bits: int, page_size: int):
        self.q = q
        self.s = s
        self.bits = int(bits)
        self.page_size = int(page_size)

    @property
    def mode(self) -> str:
        return {8: "int8", 4: "int4"}[self.bits]

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.s.numel() * self.s.element_size()

    def __repr__(self):
        return f"QuantKV(bits={self.bits}, q={tuple(self.q.shape)}, s={tuple(self.s.shape)})"


def _ps_eff(page_size: int, bits: int) -> int:
    if bits == 4:
        if page_size % 2:
            raise ValueError("int4 KV quant requires an even page_size")
        return page_size // 2
    return page_size


def kv_page_bytes(page_size: int, num_kv_heads: int, head_dim: int,
                  dtype: torch.dtype, mode: str) -> int:
    """Bytes ONE K or V page occupies on the device: quantized = q bytes +
    a 4-byte f32 scale per KV head."""
    bits = kv_quant_bits(mode)
    if bits == 0:
        return page_size * num_kv_heads * head_dim * dtype.itemsize
    return _ps_eff(page_size, bits) * num_kv_heads * head_dim + 4 * num_kv_heads


def alloc_kv_store(num_layers: int, num_pages: int, page_size: int,
                   num_kv_heads: int, head_dim: int, dtype: torch.dtype,
                   mode: str = "none", device="cuda"):
    """One zeroed KV store (K or V): a [L, pages, page_size, KH, D] tensor
    for mode "none", else a QuantKV with zero ints and zero scales (scale 0
    marks a fresh page, which dequantizes to zeros)."""
    bits = kv_quant_bits(resolve_kv_quant(mode))
    if bits == 0:
        return torch.zeros(
            (num_layers, num_pages, page_size, num_kv_heads, head_dim),
            dtype=dtype, device=device,
        )
    q = torch.zeros(
        (num_layers, num_pages, _ps_eff(page_size, bits), num_kv_heads, head_dim),
        dtype=torch.int8, device=device,
    )
    s = torch.zeros((num_layers, num_pages, num_kv_heads), dtype=torch.float32,
                    device=device)
    return QuantKV(q, s, bits, page_size)


def kv_page_size(store) -> int:
    """Tokens per page of a KV store."""
    if isinstance(store, QuantKV):
        return store.page_size
    return store.shape[2]


def kv_layer(store, li: int):
    """Per-layer view for the attention ops: store[li] for a tensor, a
    per-layer QuantKV (q [pages, ps_eff, KH, D], s [pages, KH]) otherwise.
    Both share the store's memory."""
    if not isinstance(store, QuantKV):
        return store[li]
    return QuantKV(store.q[li], store.s[li], store.bits, store.page_size)


def kernel_operands(kv_k_layer, kv_v_layer):
    """Per-layer KV operands as the kernels take them: (k_raw, v_raw, rows,
    page_size, kv_bits, k_scale, v_scale). rows = page_size, or
    page_size // 2 for int4; kv_bits 0 = full precision, with no scales."""
    if isinstance(kv_k_layer, QuantKV):
        return (kv_k_layer.q, kv_v_layer.q, kv_k_layer.q.shape[1],
                kv_k_layer.page_size, kv_k_layer.bits, kv_k_layer.s, kv_v_layer.s)
    return (kv_k_layer, kv_v_layer, kv_k_layer.shape[1], kv_k_layer.shape[1],
            0, None, None)


# ---------------------------------------------------------------------- #
# quantize-on-write
# ---------------------------------------------------------------------- #


def _write_layers(q: torch.Tensor, s: torch.Tensor, phys: torch.Tensor,
                  offs: torch.Tensor, vals: torch.Tensor, bits: int,
                  page_size: int) -> None:
    """Quantize-on-write of vals [L', T, KH, D] at (phys[t], offs[t]) into
    q [L', P, ps_eff, KH, D] and s [L', P, KH], in place, every layer of the
    stack in one batched set of ops. The reference's `_write_one_layer`
    (per layer, whole pages per copy) computes the same ints and scales;
    here only the byte row each copy writes carries a delta."""
    qmax = QMAX[bits]
    L, T = vals.shape[0], phys.shape[0]
    vals32 = vals.float()
    amax = vals32.abs().amax(dim=-1)  # [L, T, KH]
    # page-start reset: offset 0 is a page's earliest slot, so a write
    # there means any existing content belongs to a dead sequence. (Python
    # scalars throughout: a tensor made from one would be a synchronous
    # host-to-device copy on every write.)
    starts = torch.where(offs == 0, 0.0, float("inf"))
    s.index_reduce_(1, phys, starts[None, :, None].expand_as(amax), "amin")
    old_s = s[:, phys]  # [L, T, KH] (post-reset, pre-grow)
    # amax * f32(1 / qmax), not amax / qmax: XLA folds a division by a
    # constant into this product when the reference runs under jit (as its
    # engine does), and the two differ in the last bit. (The double 1/qmax
    # rounds to the same f32 as 1.0f / qmax for qmax 127 and 7.)
    s.index_reduce_(1, phys, amax * (1.0 / qmax), "amax")
    eff_s = s[:, phys]  # final page scales (duplicates agree)
    # requantize the touched pages for grown scales; duplicates write
    # identical content
    nib = q[:, phys]  # [L, T, ps_eff, KH, D]
    if bits == 4:
        nib = unpack_int4(nib, axis=2)  # [L, T, ps, KH, D]
    ratio = torch.where(eff_s > 0, old_s / eff_s.clamp(min=1e-30), 0.0)
    x = nib.float().mul_(ratio[:, :, None, :, None])
    nib = x.round_().clamp_(-qmax, qmax).to(torch.int8)
    del x
    repacked = pack_int4(nib, axis=2) if bits == 4 else nib
    q[:, phys] = repacked
    # each copy's new value at the final page scale, landed as a delta on
    # its own byte: int8 wraparound makes duplicate deltas compose exactly
    qv = torch.round(vals32 / eff_s.clamp(min=1e-30)[..., None]).clamp_(-qmax, qmax)
    qv = qv.to(torch.int8)  # [L, T, KH, D]
    t_idx = torch.arange(T, device=vals.device)
    if bits == 4:
        half = page_size // 2
        row = offs % half
        old = repacked[:, t_idx, row]
        high = (offs >= half)[None, :, None, None]
        lo = torch.where(high, nib[:, t_idx, row], qv)
        hi = torch.where(high, qv, nib[:, t_idx, row + half])
        new = (lo & 0x0F) | (hi << 4)
    else:
        row = offs
        old = repacked[:, t_idx, row]
        new = qv
    l_idx = torch.arange(L, device=vals.device)[:, None]
    q.index_put_((l_idx, phys[None, :], row[None, :]), new - old, accumulate=True)


def kv_write(store, li: int, phys: torch.Tensor, offs: torch.Tensor,
             vals: torch.Tensor):
    """Write `vals` [..., KH, D] at (li, phys[...], offs[...]) in place —
    the one KV page-write spelling for every model forward. Returns the
    store (the same object) so call sites read like the reference's."""
    if not isinstance(store, QuantKV):
        if phys.dtype != torch.int64:
            phys, offs = phys.long(), offs.long()
        store[li].index_put_((phys, offs), vals.to(store.dtype))
        return store
    T = phys.numel()
    vals_f = vals.reshape(1, T, *vals.shape[-2:])
    _write_layers(store.q[li:li + 1], store.s[li:li + 1], phys.reshape(T).long(),
                  offs.reshape(T).long(), vals_f, store.bits, store.page_size)
    return store


def kv_write_all_layers(store, phys: torch.Tensor, offs: torch.Tensor,
                        vals: torch.Tensor):
    """All-layer write (the local decode block's once-per-block commit):
    vals [L, ...lead, KH, D] at (phys[...lead], offs[...lead]), in place."""
    if not isinstance(store, QuantKV):
        store[:, phys.long(), offs.long()] = vals.to(store.dtype)
        return store
    T = phys.numel()
    vals_f = vals.reshape(vals.shape[0], T, *vals.shape[-2:])
    _write_layers(store.q, store.s, phys.reshape(T).long(), offs.reshape(T).long(),
                  vals_f, store.bits, store.page_size)
    return store


# ---------------------------------------------------------------------- #
# dequantizing gather (the plain attention versions)
# ---------------------------------------------------------------------- #


def gather_dequant(layer, tables: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Gather pages for a per-layer KV operand and return full-precision
    context [..., n_pages, page_size, KH, D] in `dtype`: a plain gather of
    a tensor layer, or unpack + (float(q) * scale) cast to `dtype` for a
    QuantKV — the formula the kernels apply while staging a tile."""
    idx = tables.long()
    if not isinstance(layer, QuantKV):
        return layer[idx].to(dtype)
    q = layer.q[idx]  # [..., P, ps_eff, KH, D]
    if layer.bits == 4:
        q = unpack_int4(q, axis=-3)
    s = layer.s[idx]  # [..., P, KH]
    return (q.float() * s[..., None, :, None]).to(dtype)


# ---------------------------------------------------------------------- #
# page gather / scatter and the host/wire page layout (disagg handoff)
# ---------------------------------------------------------------------- #


def extract_pages(store, page_ids: torch.Tensor):
    """The pages `page_ids` (physical ids) of every layer, as a new store
    of the same kind in the `[L, n, ...]` layout: `store[:, page_ids]`,
    with a QuantKV's scales gathered beside their pages."""
    ids = page_ids.long()
    if isinstance(store, QuantKV):
        return QuantKV(store.q.index_select(1, ids), store.s.index_select(1, ids),
                       store.bits, store.page_size)
    return store.index_select(1, ids)


def inject_pages(store, page_ids: torch.Tensor, data) -> None:
    """In place: `store[:, page_ids] = data` for every layer (the inverse of
    extract_pages; `data` on the store's device)."""
    ids = page_ids.long()
    if isinstance(store, QuantKV):
        store.q.index_copy_(1, ids, data.q)
        store.s.index_copy_(1, ids, data.s)
    else:
        store.index_copy_(1, ids, data.to(store.dtype))


def pack_pages(x) -> torch.Tensor:
    """Extracted pages in their wire layout, on x's device: a fp tensor
    unchanged; a QuantKV as one uint8 row per (layer, page): q bytes then
    the f32 scale bytes, shape [L, n, PB] (PB = kv_page_bytes)."""
    if not isinstance(x, QuantKV):
        return x
    L, n = x.q.shape[0], x.q.shape[1]
    qb = x.q.contiguous().view(torch.uint8).reshape(L, n, -1)
    sb = x.s.to(torch.float32).contiguous().view(torch.uint8).reshape(L, n, -1)
    return torch.cat([qb, sb], dim=-1)


def host_pack_pages(x) -> torch.Tensor:
    """Device->host for extracted pages in the `[L, n, ...]` layout: the
    rows of pack_pages on the CPU. The reference returns numpy; a bf16
    page has no numpy type here, so this returns a CPU tensor holding the
    same bytes."""
    return pack_pages(x).cpu()


def host_unpack_pages(arr: torch.Tensor, mode: str, page_size: int,
                      num_kv_heads: int, head_dim: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inverse of host_pack_pages for a packed [..., PB] uint8 tensor (any
    device): returns (q [..., ps_eff, KH, D] int8, s [..., KH] f32)."""
    bits = kv_quant_bits(mode)
    ps_eff = _ps_eff(page_size, bits)
    qbytes = ps_eff * num_kv_heads * head_dim
    lead = tuple(arr.shape[:-1])
    if arr.shape[-1] != qbytes + 4 * num_kv_heads:
        raise ValueError(
            f"packed KV page has {arr.shape[-1]} bytes; {mode} layout "
            f"expects {qbytes + 4 * num_kv_heads}"
        )
    q = arr[..., :qbytes].contiguous().view(torch.int8).reshape(
        *lead, ps_eff, num_kv_heads, head_dim)
    s = arr[..., qbytes:].contiguous().view(torch.float32).reshape(*lead, num_kv_heads)
    return q, s


def device_pages(arr: torch.Tensor, mode: str, page_size: int, num_kv_heads: int,
                 head_dim: int, device=None):
    """Wire pages -> the inject operand on `device` (default: arr's): a fp
    tensor as it is; packed uint8 rows unpacked into a QuantKV in the same
    `[L, n, ...]` layout extract_pages produced."""
    if device is not None and arr.device != torch.device(device):
        if arr.device.type == "cpu" and torch.device(device).type == "cuda":
            # staged through pinned memory so the copy runs asynchronously
            arr = arr.pin_memory().to(device, non_blocking=True)
        else:
            arr = arr.to(device)
    bits = kv_quant_bits(mode)
    if bits == 0:
        return arr
    q, s = host_unpack_pages(arr, mode, page_size, num_kv_heads, head_dim)
    return QuantKV(q, s, bits, page_size)
