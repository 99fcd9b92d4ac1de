"""Block-level KV accounting for the mock engine, and the KV events
(stored/removed) every engine emits so a router's radix index sees its
prefix-cache contents.

Port of `dynamo_tpu/llm/mocker/kv_manager.py`, which mirrors reference
lib/llm/src/mocker/kv_manager.rs (KvManager :45): a fixed pool of KV blocks
with prefix caching (sequence-hash keyed), reference counting, LRU eviction
of unreferenced blocks at a watermark, and KV events emitted exactly like
a real engine's.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set


@dataclass
class KvEvent:
    """BlockStored/BlockRemoved event (reference kv_router/protocols.rs)."""

    event_type: str  # "stored" | "removed"
    block_hashes: List[int]
    parent_hash: Optional[int] = None
    token_blocks: Optional[List[List[int]]] = None  # stored only
    ts: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        d = {"event_type": self.event_type, "block_hashes": self.block_hashes}
        if self.parent_hash is not None:
            d["parent_hash"] = self.parent_hash
        if self.token_blocks is not None:
            d["token_blocks"] = self.token_blocks
        return d


def stored_event_runs(
    seq_hashes: List[int],
    new_hashes: Set[int],
    token_blocks: Optional[List[List[int]]] = None,
    parent_of_first: Optional[int] = None,
) -> List[KvEvent]:
    """Split the newly stored subset of a chained sequence into one
    `stored` event per CONTIGUOUS run, each carrying the run's true chain
    parent (the seq_hashes element just before it) and its aligned
    token_blocks slice. A commit can skip hashes a concurrent sequence
    already cached, and a single gapped event would make the router's
    bounded index fabricate parent links across the gap — this is the
    single spelling of the contract for BOTH producers (the engine's
    PageAllocator.commit_hashes and the mocker's KvManager.acquire)."""
    runs: List[dict] = []
    run: Optional[dict] = None
    prev = parent_of_first
    for i, h in enumerate(seq_hashes):
        if h in new_hashes:
            if run is None:
                run = {"parent": prev, "hashes": [], "tb": []}
                runs.append(run)
            run["hashes"].append(h)
            if token_blocks is not None and i < len(token_blocks):
                run["tb"].append(token_blocks[i])
        else:
            run = None
        prev = h
    return [
        KvEvent("stored", r["hashes"], parent_hash=r["parent"],
                token_blocks=r["tb"] or None)
        for r in runs
    ]


@dataclass
class _Block:
    seq_hash: int
    ref_count: int = 0


class KvManager:
    """Fixed-capacity block pool with prefix reuse (reference kv_manager.rs:45)."""

    def __init__(
        self,
        num_blocks: int,
        block_size: int,
        event_sink: Optional[Callable[[KvEvent], None]] = None,
        watermark: float = 0.01,
    ):
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.event_sink = event_sink
        self.watermark_blocks = max(1, int(num_blocks * watermark))
        self._active: Dict[int, _Block] = {}  # seq_hash -> block (ref'd or cached)
        self._lru: OrderedDict[int, None] = OrderedDict()  # unreferenced, evictable
        self._used = 0

    # -- capacity ----------------------------------------------------------- #

    @property
    def used_blocks(self) -> int:
        return self._used

    @property
    def free_blocks(self) -> int:
        """Blocks allocatable right now (free + evictable)."""
        return self.num_blocks - self._used + len(self._lru)

    @property
    def active_blocks(self) -> int:
        return self._used - len(self._lru)

    def usage_perc(self) -> float:
        return self.active_blocks / self.num_blocks

    # -- queries ------------------------------------------------------------ #

    def cached_prefix_blocks(self, seq_hashes: List[int]) -> int:
        """How many leading blocks of this sequence are already resident."""
        n = 0
        for h in seq_hashes:
            if h in self._active:
                n += 1
            else:
                break
        return n

    def can_allocate(self, seq_hashes: List[int], extra_blocks: int = 0) -> bool:
        new_needed = sum(1 for h in seq_hashes if h not in self._active) + extra_blocks
        return new_needed <= self.num_blocks - self._used + len(self._lru) - self.watermark_blocks

    # -- allocation --------------------------------------------------------- #

    def acquire(
        self,
        seq_hashes: List[int],
        token_blocks: Optional[List[List[int]]] = None,
        parent_of_first: Optional[int] = None,
    ) -> bool:
        """Reference (and create if needed) blocks for the given sequence
        hashes. Emits `stored` events for newly created blocks."""
        new_hashes = [h for h in seq_hashes if h not in self._active]
        if len(new_hashes) > self.num_blocks - self._used + len(self._lru):
            return False
        # evict as needed
        while self._used + len(new_hashes) > self.num_blocks and self._lru:
            self._evict_one()
        created: Set[int] = set()
        for h in seq_hashes:
            blk = self._active.get(h)
            if blk is None:
                blk = _Block(seq_hash=h, ref_count=0)
                self._active[h] = blk
                self._used += 1
                created.add(h)
            if blk.ref_count == 0:
                self._lru.pop(h, None)
            blk.ref_count += 1
        if created and self.event_sink:
            for ev in stored_event_runs(
                seq_hashes, created, token_blocks, parent_of_first
            ):
                self.event_sink(ev)
        return True

    def release(self, seq_hashes: List[int]):
        """Drop references; unreferenced blocks go to the LRU (still cached
        for prefix reuse until evicted)."""
        for h in seq_hashes:
            blk = self._active.get(h)
            if blk is None:
                continue
            blk.ref_count -= 1
            if blk.ref_count <= 0:
                blk.ref_count = 0
                self._lru[h] = None
                self._lru.move_to_end(h)

    def _evict_one(self):
        h, _ = self._lru.popitem(last=False)
        self._active.pop(h, None)
        self._used -= 1
        if self.event_sink:
            self.event_sink(KvEvent("removed", [h]))

    def clear_cache(self) -> int:
        """Evict all unreferenced blocks (reference clear-kv-blocks route)."""
        n = 0
        while self._lru:
            self._evict_one()
            n += 1
        return n
