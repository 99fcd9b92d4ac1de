"""KV block index: which worker holds which cached blocks.

Port of `dynamo_tpu/llm/kv_router/indexer.py`: the index is always the
Python `RadixTree` (the reference's optional C++ tree is not ported).

Mirrors reference lib/llm/src/kv_router/indexer.rs (RadixTree :224,
find_matches :276, apply_event :336). Because block hashes are CHAINED
sequence hashes (tokens.py), a hash is globally unique to its exact prefix —
so the radix tree collapses to a flat hash→workers map, with per-worker
continuity enforced during the match walk (a worker that evicted an early
block stops matching at the gap). This is O(1) per block with no tree
rebalancing — cheaper than the reference's pointer tree for the same
semantics.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from collections import OrderedDict, defaultdict
from typing import Dict, List, Optional, Set

from ...runtime.component import DistributedRuntime
from ..tokens import compute_seq_hashes

logger = logging.getLogger(__name__)


def _index_cap_from_env() -> Optional[int]:
    """DYN_ROUTER_INDEX_MAX_BLOCKS: block-count cap per router index
    (0/unset = unbounded, the seed behavior). At a million sessions the
    event stream grows the index without bound — the cap turns that into
    leaf-first eviction instead of a frontend OOM."""
    raw = os.environ.get("DYN_ROUTER_INDEX_MAX_BLOCKS")
    try:
        cap = int(raw) if raw else 0
    except ValueError:
        logger.warning("DYN_ROUTER_INDEX_MAX_BLOCKS=%r invalid; unbounded", raw)
        cap = 0
    return cap if cap > 0 else None


class OverlapScores:
    """Per-worker count of matched prefix blocks (reference indexer.rs
    OverlapScores)."""

    def __init__(self):
        self.scores: Dict[int, int] = {}
        self.frequencies: List[int] = []  # workers matching at each depth

    def __repr__(self):
        return f"OverlapScores({self.scores})"


#: stats() memory-estimate coefficients: rough CPython cost of one hash
#: entry (two dict slots + OrderedDict node + parent/children bookkeeping)
#: and one (hash, worker) set membership, measured-once constants, not
#: precise accounting — the point is that the estimate SCALES with the
#: index so an operator can alarm on it.
_BYTES_PER_BLOCK = 240
_BYTES_PER_MAPPING = 100


class RadixTree:
    """Flat chained-hash index with match-walk semantics
    (reference RadixTree indexer.rs:224).

    `max_blocks` bounds the index (docs/kv_cache_routing.md): when the
    cap is exceeded, LEAVES are evicted first in least-recently-matched
    order. Because hashes are chained, an interior block is exactly as
    useful as the deepest chain through it — evicting leaf-first means a
    capped index degrades from the deep (cold, most specific) end of each
    prefix chain while shared roots survive, and a match walk over the
    survivors still returns correct (merely shallower) overlap scores.
    Eviction drops the hash for ALL workers: it is routing metadata, not
    cache state — the worker still holds the block; the router just stops
    scoring it."""

    def __init__(self, max_blocks: Optional[int] = None):
        self._blocks: Dict[int, Set[int]] = defaultdict(set)  # hash -> workers
        self._worker_blocks: Dict[int, Set[int]] = defaultdict(set)  # worker -> hashes
        self.max_blocks = max_blocks if max_blocks and max_blocks > 0 else None
        # chain bookkeeping for leaf-first eviction: parent link per hash,
        # in-index children per hash, and leaves in least-recently-matched
        # order (OrderedDict as an O(1) recency list)
        self._parent: Dict[int, int] = {}
        self._children: Dict[int, Set[int]] = {}
        self._leaf_order: "OrderedDict[int, None]" = OrderedDict()
        self._mappings = 0  # live (hash, worker) pairs, for the mem estimate
        self.evicted_blocks = 0

    def apply_stored(self, worker_id: int, block_hashes: List[int],
                     chained: bool = True, parent: Optional[int] = None):
        """`chained=True` (live stored events): consecutive hashes are a
        contiguous chain, so each records the previous as its parent, and
        `parent` (the stored event's `parent_hash`) links the FIRST block
        to the chain it extends — without it, per-block stored events
        (one per generated block) would leave every block a root/leaf and
        leaf-first eviction would take the roots first.
        `chained=False` (snapshot restore via load(): dump() sorts hash
        sets, destroying chain order): no parent links are fabricated —
        restored blocks are all roots/leaves until live events re-chain
        them, degrading eviction quality, never correctness."""
        bounded = self.max_blocks is not None
        prev: Optional[int] = parent if chained else None
        for h in block_hashes:
            workers = self._blocks[h]
            if worker_id not in workers:
                workers.add(worker_id)
                self._worker_blocks[worker_id].add(h)
                self._mappings += 1
            if not bounded:
                continue  # chain/leaf bookkeeping only feeds eviction —
                # an uncapped tree skips its ~2x per-block overhead
            if h not in self._leaf_order and not self._children.get(h):
                self._leaf_order[h] = None
            if chained and prev is not None and h not in self._parent:
                self._parent[h] = prev
                self._children.setdefault(prev, set()).add(h)
                self._leaf_order.pop(prev, None)  # prev now interior
            prev = h
        self._maybe_evict()

    def _unlink(self, h: int):
        """Chain bookkeeping for a hash that left the index entirely:
        drop its leaf/parent entries, and re-leaf the parent (at the MRU
        end — it just proved useful by having had descendants) when `h`
        was its last in-index child."""
        self._leaf_order.pop(h, None)
        parent = self._parent.pop(h, None)
        if parent is not None:
            kids = self._children.get(parent)
            if kids is not None:
                kids.discard(h)
                if not kids:
                    del self._children[parent]
                    if parent in self._blocks:
                        self._leaf_order[parent] = None

    def _drop_hash(self, h: int):
        """Remove `h` for every holder + all chain bookkeeping."""
        workers = self._blocks.pop(h, None)
        if workers:
            for w in workers:
                wb = self._worker_blocks.get(w)
                if wb is not None:
                    wb.discard(h)
            self._mappings -= len(workers)
        self._unlink(h)

    def _maybe_evict(self):
        if self.max_blocks is None:
            return
        while len(self._blocks) > self.max_blocks:
            if self._leaf_order:
                victim = next(iter(self._leaf_order))
            else:
                # no known leaf (stale bookkeeping) — never wedge the cap
                victim = next(iter(self._blocks))
            self._drop_hash(victim)
            self.evicted_blocks += 1

    def _forget_for_worker(self, worker_id: int, h: int):
        workers = self._blocks.get(h)
        if workers and worker_id in workers:
            workers.discard(worker_id)
            self._mappings -= 1
            if not workers:
                self._blocks.pop(h, None)
                self._unlink(h)  # fully gone: same cleanup as an eviction

    def apply_removed(self, worker_id: int, block_hashes: List[int]):
        for h in block_hashes:
            self._forget_for_worker(worker_id, h)
            self._worker_blocks[worker_id].discard(h)

    def remove_worker(self, worker_id: int):
        """Worker died: drop all its blocks (reference remove_worker)."""
        for h in self._worker_blocks.pop(worker_id, set()):
            self._forget_for_worker(worker_id, h)

    def clear_all_blocks(self, worker_id: int):
        self.remove_worker(worker_id)

    def find_matches(self, seq_hashes: List[int], early_exit: bool = False) -> OverlapScores:
        """Walk the prefix; a worker scores i+1 if it holds blocks 0..i
        contiguously (reference find_matches indexer.rs:276)."""
        result = OverlapScores()
        active: Optional[Set[int]] = None
        for depth, h in enumerate(seq_hashes):
            holders = self._blocks.get(h)
            if not holders:
                break
            if self.max_blocks is not None and h in self._leaf_order:
                # matched leaves are hot: refresh their eviction recency
                self._leaf_order.move_to_end(h)
            active = set(holders) if active is None else (active & holders)
            if not active:
                break
            result.frequencies.append(len(active))
            for w in active:
                result.scores[w] = depth + 1
            if early_exit and len(active) == 1:
                break
        return result

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    def memory_bytes_estimate(self) -> int:
        """Order-of-magnitude resident cost of the index (docs note in
        kv_cache_routing.md: an alarmable scale signal, not an accountant)."""
        return (
            _BYTES_PER_BLOCK * len(self._blocks)
            + _BYTES_PER_MAPPING * self._mappings
        )

    def stats(self) -> dict:
        return {
            "index_blocks": len(self._blocks),
            "index_max_blocks": self.max_blocks or 0,
            "index_evicted_blocks": self.evicted_blocks,
            "index_mappings": self._mappings,
            "index_memory_bytes_estimate": self.memory_bytes_estimate(),
        }

    def worker_block_count(self, worker_id: int) -> int:
        return len(self._worker_blocks.get(worker_id, ()))

    def workers(self) -> List[int]:
        return list(self._worker_blocks.keys())

    def dump(self) -> dict:
        """Snapshot for replica sync / persistence (reference snapshots to
        the object store)."""
        return {
            str(w): sorted(hs) for w, hs in self._worker_blocks.items() if hs
        }

    def load(self, snapshot: dict):
        # dump() sorts each worker's hash set — chain order is gone, so
        # restoring must NOT fabricate parent links (chained=False);
        # restored blocks are all leaves until live events re-chain them
        for w_str, hashes in snapshot.items():
            self.apply_stored(int(w_str), list(hashes), chained=False)


EVENT_TOPIC_FMT = "kv_events/{namespace}/{component}"


ROUTER_SNAPSHOT_KEY_FMT = "v1/router_snapshots/{namespace}/{component}"


class KvIndexer:
    """Event-driven index: subscribes to the component's KV-event topic and
    applies stored/removed events to the RadixTree
    (reference KvIndexer indexer.rs + subscriber.rs).

    With `snapshot_threshold` set, the tree is persisted to the discovery
    KV (the reference's NATS object-store role, kv_cache_routing.md
    --router-snapshot-threshold) every N applied events and restored on
    start, so a restarted/added router replica syncs without replaying the
    whole event history. `reset_states` drops any stored snapshot instead
    (--router-reset-states)."""

    def __init__(
        self,
        drt: DistributedRuntime,
        namespace: str,
        component: str,
        block_size: int = 64,
        snapshot_threshold: Optional[int] = None,
        reset_states: bool = False,
        max_blocks: Optional[int] = None,
    ):
        self.drt = drt
        self.block_size = block_size
        self.topic = EVENT_TOPIC_FMT.format(namespace=namespace, component=component)
        self.snapshot_key = ROUTER_SNAPSHOT_KEY_FMT.format(
            namespace=namespace, component=component
        )
        self.snapshot_threshold = snapshot_threshold
        self.reset_states = reset_states
        if max_blocks is None:
            max_blocks = _index_cap_from_env()
        self.max_blocks = max_blocks
        self.tree = RadixTree(max_blocks=max_blocks)
        self._task: Optional[asyncio.Task] = None
        self._sub = None
        self.events_applied = 0
        self._events_at_snapshot = 0
        self._persist_task: Optional[asyncio.Task] = None

    async def start(self):
        assert self.drt.discovery is not None
        # subscribe BEFORE restoring: events arriving during the restore are
        # buffered in the subscription, not lost (load is additive)
        self._sub = await self.drt.discovery.subscribe(self.topic)
        if self.reset_states:
            await self.drt.discovery.delete(self.snapshot_key)
        elif self.snapshot_threshold is not None:
            await self._restore_snapshot()
        self._task = asyncio.create_task(self._loop())

    async def _restore_snapshot(self):
        raw = await self.drt.discovery.get(self.snapshot_key)
        if not raw:
            return
        try:
            self.tree.load(json.loads(raw))
            logger.info("restored router snapshot (%d blocks)", self.tree.num_blocks)
        except Exception:  # noqa: BLE001 — corrupt snapshot: start cold
            logger.exception("router snapshot restore failed; starting cold")

    def _start_persist_snapshot(self):
        """Dump the tree inline (consistent point-in-time view), then encode
        and upload off the event-apply hot path."""
        if self._persist_task is not None and not self._persist_task.done():
            return  # previous upload still in flight; next threshold retries
        snapshot = self.tree.dump()
        self._events_at_snapshot = self.events_applied

        async def upload():
            try:
                loop = asyncio.get_running_loop()
                raw = await loop.run_in_executor(
                    None, lambda: json.dumps(snapshot).encode()
                )
                await self.drt.discovery.put(self.snapshot_key, raw)
            except Exception:  # noqa: BLE001
                logger.exception("router snapshot persist failed")

        self._persist_task = asyncio.create_task(upload())

    async def _loop(self):
        from ...runtime import codec

        async for payload in self._sub:
            try:
                msg = codec.unpack(payload)
                worker_id = msg["worker_id"]
                for ev in msg.get("events", []):
                    if ev.get("event_type") == "stored":
                        self.tree.apply_stored(
                            worker_id, ev["block_hashes"],
                            parent=ev.get("parent_hash"),
                        )
                    elif ev.get("event_type") == "removed":
                        self.tree.apply_removed(worker_id, ev["block_hashes"])
                    elif ev.get("event_type") == "cleared":
                        self.tree.clear_all_blocks(worker_id)
                    self.events_applied += 1
                if (
                    self.snapshot_threshold is not None
                    and self.events_applied - self._events_at_snapshot
                    >= self.snapshot_threshold
                ):
                    self._start_persist_snapshot()
            except Exception:  # noqa: BLE001 — indexer must survive bad events
                logger.exception("bad kv event")

    def find_matches_for_tokens(self, token_ids: List[int]) -> OverlapScores:
        return self.find_matches_for_hashes(
            compute_seq_hashes(token_ids, self.block_size)
        )

    def find_matches_for_hashes(self, hashes: List[int]) -> OverlapScores:
        return self.tree.find_matches(hashes)

    def remove_worker(self, worker_id: int):
        self.tree.remove_worker(worker_id)

    def stats(self) -> dict:
        return {"events_applied": self.events_applied, **self.tree.stats()}

    async def close(self):
        if self._task:
            self._task.cancel()
        if self._persist_task is not None and not self._persist_task.done():
            try:
                await self._persist_task
            except Exception:  # noqa: BLE001
                pass
        if self._sub:
            await self._sub.cancel()


class KvIndexerSharded:
    """N independent trees, workers assigned by worker_id modulo shards;
    lookups fan out and merge (reference KvIndexerSharded indexer.rs:992 —
    bounds per-trie size and contention for large fleets)."""

    def __init__(self, num_shards: int = 4, block_size: int = 64,
                 max_blocks: Optional[int] = None):
        if num_shards < 1:
            raise ValueError("num_shards must be >= 1")
        self.block_size = block_size
        if max_blocks is None:
            max_blocks = _index_cap_from_env()
        self.max_blocks = max_blocks
        # shards hold disjoint workers, so the global cap splits evenly
        # (ceil: the sum may exceed max_blocks by < num_shards)
        per_shard = (
            -(-max_blocks // num_shards) if max_blocks is not None else None
        )
        self.shards = [
            RadixTree(max_blocks=per_shard) for _ in range(num_shards)
        ]

    def _shard(self, worker_id: int):
        return self.shards[worker_id % len(self.shards)]

    def apply_stored(self, worker_id: int, block_hashes: List[int],
                     chained: bool = True, parent: Optional[int] = None):
        self._shard(worker_id).apply_stored(
            worker_id, block_hashes, chained=chained, parent=parent
        )

    def apply_removed(self, worker_id: int, block_hashes: List[int]):
        self._shard(worker_id).apply_removed(worker_id, block_hashes)

    def clear_all_blocks(self, worker_id: int):
        self._shard(worker_id).clear_all_blocks(worker_id)

    def remove_worker(self, worker_id: int):
        self._shard(worker_id).remove_worker(worker_id)

    def find_matches(self, seq_hashes: List[int], early_exit: bool = False) -> OverlapScores:
        merged = OverlapScores()
        for shard in self.shards:
            r = shard.find_matches(seq_hashes, early_exit=early_exit)
            merged.scores.update(r.scores)
            # frequencies[d] counts workers matching at depth d; shards hold
            # disjoint workers, so merge is an element-wise sum
            if len(r.frequencies) > len(merged.frequencies):
                merged.frequencies.extend(
                    [0] * (len(r.frequencies) - len(merged.frequencies))
                )
            for d, f in enumerate(r.frequencies):
                merged.frequencies[d] += f
        return merged

    def find_matches_for_tokens(self, token_ids: List[int]) -> OverlapScores:
        return self.find_matches(compute_seq_hashes(token_ids, self.block_size))

    @property
    def num_blocks(self) -> int:
        return sum(s.num_blocks for s in self.shards)

    def stats(self) -> dict:
        out: dict = {"index_blocks": 0, "index_max_blocks": self.max_blocks or 0}
        for s in self.shards:
            for k, v in s.stats().items():
                if k == "index_max_blocks":
                    continue
                out[k] = out.get(k, 0) + v
        return out

    def workers(self) -> List[int]:
        out: List[int] = []
        for s in self.shards:
            out.extend(s.workers())
        return out

    def dump(self) -> dict:
        merged: dict = {}
        for s in self.shards:
            merged.update(s.dump())
        return merged

    def load(self, snapshot: dict):
        # route through each shard's own load: the sorted snapshot must
        # not be re-interpreted as chains
        for w_str, hashes in snapshot.items():
            self._shard(int(w_str)).load({w_str: list(hashes)})


class ApproxKvIndexer:
    """Indexer that needs no engine events: assumes a routed request's prefix
    becomes cached on the chosen worker for a TTL
    (reference ApproxKvIndexer approx.rs)."""

    def __init__(self, block_size: int = 64, ttl: float = 120.0):
        self.block_size = block_size
        self.ttl = ttl
        self.tree = RadixTree()
        self._expiry: List[tuple] = []  # (deadline, worker_id, hashes)
        # refcount per (worker, hash): a hot prefix re-routed inside the
        # TTL appends a SECOND expiry entry — without counts, the OLDER
        # entry's expiry would erase the still-valid refresh
        self._refs: dict = {}

    def process_routing_decision_for_request(self, token_ids: List[int], worker_id: int):
        self.apply_routed_hashes(
            compute_seq_hashes(token_ids, self.block_size), worker_id
        )

    def apply_routed_hashes(self, hashes: List[int], worker_id: int):
        import time

        self.tree.apply_stored(worker_id, hashes)
        for h in hashes:
            key = (worker_id, h)
            self._refs[key] = self._refs.get(key, 0) + 1
        self._expiry.append((time.monotonic() + self.ttl, worker_id, hashes))
        self._expire()

    def _expire(self):
        import time

        now = time.monotonic()
        while self._expiry and self._expiry[0][0] < now:
            _, worker_id, hashes = self._expiry.pop(0)
            dead = []
            for h in hashes:
                key = (worker_id, h)
                n = self._refs.get(key, 1) - 1
                if n <= 0:
                    self._refs.pop(key, None)
                    dead.append(h)
                else:
                    self._refs[key] = n
            if dead:
                self.tree.apply_removed(worker_id, dead)

    def find_matches_for_tokens(self, token_ids: List[int]) -> OverlapScores:
        return self.find_matches_for_hashes(
            compute_seq_hashes(token_ids, self.block_size)
        )

    def find_matches_for_hashes(self, hashes: List[int]) -> OverlapScores:
        self._expire()
        return self.tree.find_matches(hashes)

    def remove_worker(self, worker_id: int):
        self.tree.remove_worker(worker_id)
        self._refs = {k: v for k, v in self._refs.items() if k[0] != worker_id}
        self._expiry = [e for e in self._expiry if e[1] != worker_id]
