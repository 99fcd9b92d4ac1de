"""KV events (stored/removed) emitted by engines so a router's radix index
sees their prefix-cache contents. Port of `KvEvent` and `stored_event_runs`
of `dynamo_tpu/llm/mocker/kv_manager.py`.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Set


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
