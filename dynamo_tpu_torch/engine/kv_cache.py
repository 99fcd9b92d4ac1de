"""Paged KV cache: device tensors + host-side page allocator with prefix reuse.

Port of `dynamo_tpu/engine/kv_cache.py`:
  * device side: kv_k/kv_v [layers, num_pages, page_size, kv_heads, head_dim]
  * host side: free-list page allocator; pages keyed by chained block hash
    for prefix reuse (llm/tokens.py), with LRU eviction of unreferenced
    cached pages and KV stored/removed events. The allocator follows the
    reference line for line (free-list order, LRU order, event runs), so
    the same request trace yields the same page ids in both.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from ..llm.mocker.kv_manager import KvEvent, stored_event_runs

logger = logging.getLogger(__name__)


def alloc_kv_arrays(
    num_layers: int,
    num_pages: int,
    page_size: int,
    num_kv_heads: int,
    head_dim: int,
    dtype: torch.dtype = torch.bfloat16,
    device="cuda",
    kv_quant: str = "none",
) -> Tuple[Any, Any]:
    """Allocate the zeroed K and V stores: tensors for kv_quant="none",
    `QuantKV` stores for "int8"/"int4" (ops/kv_quant.py). The engine
    writes them in place."""
    from ..ops.kv_quant import alloc_kv_store

    kv_k = alloc_kv_store(
        num_layers, num_pages, page_size, num_kv_heads, head_dim, dtype,
        kv_quant, device=device,
    )
    kv_v = alloc_kv_store(
        num_layers, num_pages, page_size, num_kv_heads, head_dim, dtype,
        kv_quant, device=device,
    )
    return kv_k, kv_v


@dataclass
class _CachedPage:
    page_id: int
    seq_hash: int
    ref_count: int = 0


class PageAllocator:
    """Host-side page pool with hash-keyed prefix cache
    (engine counterpart of mocker KvManager; emits the same KV events)."""

    def __init__(
        self,
        num_pages: int,
        page_size: int,
        event_sink: Optional[Callable[[KvEvent], None]] = None,
    ):
        self.num_pages = num_pages
        self.page_size = page_size
        self.event_sink = event_sink
        self._free: List[int] = list(range(num_pages - 1, -1, -1))
        self._by_hash: Dict[int, _CachedPage] = {}
        self._lru: OrderedDict[int, None] = OrderedDict()  # seq_hash -> None
        # cumulative prefix-cache hits (blocks re-referenced instead of
        # recomputed) — the KV router-benefit benchmark reads this
        self.prefix_hit_blocks_total = 0

    @property
    def free_pages(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    @property
    def active_pages(self) -> int:
        """Pages referenced by live sequences (excludes LRU-cached)."""
        return self.used_pages - len(self._lru)

    def cached_prefix(self, seq_hashes: List[int]) -> List[int]:
        """Physical pages of the longest cached prefix."""
        pages = []
        for h in seq_hashes:
            page = self._by_hash.get(h)
            if page is None:
                break
            pages.append(page.page_id)
        return pages

    def can_allocate(self, n_new_pages: int) -> bool:
        return n_new_pages <= self.free_pages

    def acquire_cached(self, seq_hashes: List[int]) -> List[int]:
        """Reference the cached prefix pages; returns physical page ids."""
        out = []
        for h in seq_hashes:
            page = self._by_hash.get(h)
            if page is None:
                break
            if page.ref_count == 0:
                self._lru.pop(h, None)
            page.ref_count += 1
            out.append(page.page_id)
        self.prefix_hit_blocks_total += len(out)
        return out

    def alloc_fresh(self, n: int) -> Optional[List[int]]:
        """Allocate n un-hashed (in-flight) pages, evicting cached pages as
        needed."""
        while len(self._free) < n and self._lru:
            self._evict_one()
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def commit_hashes(self, pages: List[int], seq_hashes: List[int], token_blocks=None, parent_hash=None):
        """Bind freshly filled pages to their block hashes (after prefill or
        after a generation block completes) -> emits `stored`.

        Hashes already cached by a concurrent sequence are skipped, which
        can leave GAPS in the committed subsequence — `stored_event_runs`
        (the shared producer contract, llm/mocker/kv_manager.py) splits
        the emission into one event per contiguous run with true chain
        parents and aligned token_blocks, so the router's bounded index
        never links across a gap (the seed's single gapped event also
        misaligned token_blocks with the stored subset)."""
        created = set()
        for page_id, h in zip(pages, seq_hashes):
            if h in self._by_hash:
                continue  # already cached by a concurrent sequence
            self._by_hash[h] = _CachedPage(page_id, h, ref_count=1)
            created.add(h)
        if created and self.event_sink:
            for ev in stored_event_runs(
                seq_hashes, created, token_blocks, parent_hash
            ):
                self.event_sink(ev)

    def release(self, pages: List[int], seq_hashes: List[int]):
        """Release a sequence's pages. Hashed pages go to LRU cache;
        un-hashed (partial) pages return to the free list."""
        hashed_pages = {}
        for h in seq_hashes:
            p = self._by_hash.get(h)
            if p is not None:
                hashed_pages[p.page_id] = p
        for page_id in pages:
            page = hashed_pages.get(page_id)
            if page is None:
                self._free.append(page_id)
            else:
                page.ref_count -= 1
                if page.ref_count <= 0:
                    page.ref_count = 0
                    self._lru[page.seq_hash] = None
                    self._lru.move_to_end(page.seq_hash)

    def _evict_one(self):
        h, _ = self._lru.popitem(last=False)
        page = self._by_hash.pop(h)
        self._free.append(page.page_id)
        if self.event_sink:
            self.event_sink(KvEvent("removed", [h]))

    def clear_cache(self) -> int:
        n = 0
        while self._lru:
            self._evict_one()
            n += 1
        return n

    def stats(self) -> dict:
        return {
            "kv_active_blocks": self.used_pages - len(self._lru),
            "kv_total_blocks": self.num_pages,
            "kv_cached_blocks": len(self._lru),
            "kv_prefix_hit_blocks_total": self.prefix_hit_blocks_total,
        }
