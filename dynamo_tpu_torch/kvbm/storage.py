"""KVBM storage tiers: host-RAM and disk block pools.

Port of `dynamo_tpu/kvbm/storage.py` (the reference's Storage traits and
fully-contiguous layout). Each tier is a fixed-capacity pool of KV blocks
keyed by the chained block hash (llm/tokens.py — the hash the router
indexes), with the same eviction policies and the same victim order:

  ``lru``           evict the least-recently-touched block (`get` and a
                    re-`put` both count as touches).
  ``lfu``           evict the least-frequently-touched block, oldest touch
                    breaking ties (lazy heap: stale entries are skipped at
                    eviction time).
  ``prefix-aware``  LRU, but a block with a live DESCENDANT in the same pool
                    is protected: hashes are chained, so an interior block
                    is useful exactly as long as a deeper block extends it.
                    A chained forest always has a leaf; blocks of unknown
                    parentage (warm disk restart) look like roots.

A block is one page of one sequence across all layers, K and V each
`block_shape`: `[num_layers, page_size, num_kv_heads, head_dim]` for a
float pool, `[num_layers, kv_page_bytes]` packed uint8 rows for a quantized
one. The host tier is ONE tensor `[capacity, *block_shape]` (pinned on a
machine with a CUDA device, so an onboard is an asynchronous host-to-device
copy). The disk tier keeps the reference's files byte for byte — `k.bin` and
`v.bin` with fixed block slots, `index.json` written atomically through
`index.json.tmp` — so a pool directory written by either package opens warm
in the other. It reads and writes them with `pread`/`pwrite` into and out of
host tensors, never through a memory map (a mapped pool file stays resident
in the process's memory on some sandboxed kernels). A bf16 block is stored
as its 16-bit patterns, the bytes `ml_dtypes.bfloat16` writes.
"""

from __future__ import annotations

import heapq
import json
import os
from collections import OrderedDict
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

EVICTION_POLICIES = ("lru", "lfu", "prefix-aware")


def byte_view(t: torch.Tensor) -> np.ndarray:
    """The bytes of a contiguous CPU tensor as a flat numpy uint8 array (no copy)."""
    return t.reshape(-1).view(torch.uint8).numpy()


class _BlockPool:
    """Slot pool + eviction bookkeeping shared by both tiers. Subclasses
    supply `_write(slot, k, v)` and `_read(slot, k_out, v_out)` and may
    pre-seed `_by_hash` before calling `_init_pool`."""

    name = "pool"
    evict_with_data = True

    def __init__(self, capacity: int, block_shape: tuple, dtype: torch.dtype,
                 policy: str = "lru"):
        if policy not in EVICTION_POLICIES:
            raise ValueError(
                f"unknown eviction policy {policy!r}; want one of "
                f"{'/'.join(EVICTION_POLICIES)}"
            )
        self.capacity = capacity
        self.block_shape = tuple(int(d) for d in block_shape)
        self.dtype = dtype
        self.block_bytes = int(np.prod(self.block_shape)) * self.dtype.itemsize
        self.policy = policy
        self._by_hash: Dict[int, int] = {}  # seq_hash -> slot
        self._free: List[int] = []
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        # lfu: lazy heap of (freq, tick, hash); entries go stale on re-touch
        self._freq: Dict[int, int] = {}
        self._heap: List[Tuple[int, int, int]] = []
        self._tick = 0
        # prefix-aware: parent link + in-pool children per hash, and the
        # childless blocks in recency order (victim selection is O(1))
        self._parent: Dict[int, int] = {}
        self._children: Dict[int, Set[int]] = {}
        self._leaves: "OrderedDict[int, None]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _init_pool(self):
        """Free list and recency from whatever `_by_hash` holds (empty on a
        cold start; the persisted index on a warm disk restart, whose
        blocks carry no parent links)."""
        used = set(self._by_hash.values())
        self._free = [s for s in range(self.capacity - 1, -1, -1) if s not in used]
        self._lru = OrderedDict((h, None) for h in self._by_hash)
        self._freq = {h: 1 for h in self._by_hash}
        self._heap = []
        for h in self._by_hash:
            self._push_heap(h)
        self._parent = {}
        self._children = {}
        self._leaves = OrderedDict((h, None) for h in self._by_hash)

    def _push_heap(self, seq_hash: int):
        self._tick += 1
        heapq.heappush(self._heap, (self._freq[seq_hash], self._tick, seq_hash))
        if len(self._heap) > max(4 * self.capacity, 64):
            # compaction: exactly one entry per live hash matches its freq
            self._heap = [
                (f, t, h) for f, t, h in self._heap
                if h in self._by_hash and self._freq.get(h) == f
            ]
            heapq.heapify(self._heap)

    def _touch(self, seq_hash: int):
        self._lru[seq_hash] = None
        self._lru.move_to_end(seq_hash)
        if seq_hash in self._leaves:
            self._leaves.move_to_end(seq_hash)
        if self.policy == "lfu":
            self._freq[seq_hash] = self._freq.get(seq_hash, 0) + 1
            self._push_heap(seq_hash)

    def _pick_victim(self) -> int:
        if self.policy == "lfu":
            while self._heap:
                freq, _, h = heapq.heappop(self._heap)
                if h in self._by_hash and self._freq.get(h) == freq:
                    return h
            return next(iter(self._lru))
        if self.policy == "prefix-aware" and self._leaves:
            return next(iter(self._leaves))
        return next(iter(self._lru))

    def _forget(self, seq_hash: int):
        """Drop the policy bookkeeping of an evicted hash."""
        self._lru.pop(seq_hash, None)
        self._leaves.pop(seq_hash, None)
        self._freq.pop(seq_hash, None)
        parent = self._parent.pop(seq_hash, None)
        if parent is not None:
            kids = self._children.get(parent)
            if kids is not None:
                kids.discard(seq_hash)
                if not kids:
                    del self._children[parent]
                    if parent in self._by_hash:
                        # last in-pool child left: the parent is a leaf
                        # again, at the most-recent end
                        self._leaves[parent] = None

    def _link_parent(self, seq_hash: int, parent: int):
        self._parent[seq_hash] = parent
        self._children.setdefault(parent, set()).add(seq_hash)
        self._leaves.pop(parent, None)  # the parent is now interior

    def __len__(self) -> int:
        return len(self._by_hash)

    def has(self, seq_hash: int) -> bool:
        return seq_hash in self._by_hash

    def hashes(self) -> List[int]:
        return list(self._by_hash)

    def put(self, seq_hash: int, k, v, parent: Optional[int] = None):
        """Store a block (`k`, `v`: CPU tensors of `block_shape`). If the
        pool was full, returns the evicted (hash, k, v, parent) — with
        copies of the data only when `evict_with_data` — so the caller can
        cascade it to the next tier; else None."""
        if seq_hash in self._by_hash:
            self._touch(seq_hash)
            if parent is not None and seq_hash not in self._parent:
                self._link_parent(seq_hash, parent)
            return None
        evicted = None
        if not self._free:
            old_hash = self._pick_victim()
            slot = self._by_hash.pop(old_hash)
            old_parent = self._parent.get(old_hash)
            if self.evict_with_data:
                ok, ov = self._read(slot, None, None)
                evicted = (old_hash, ok.clone(), ov.clone(), old_parent)
            else:
                evicted = (old_hash, None, None, old_parent)
            self._forget(old_hash)
            self.evictions += 1
            self._free.append(slot)
        slot = self._free.pop()
        self._write(slot, k, v)
        self._by_hash[seq_hash] = slot
        self._lru[seq_hash] = None
        if not self._children.get(seq_hash):
            # childless on arrival (a re-added interior block whose kids are
            # still pooled stays protected)
            self._leaves[seq_hash] = None
        if self.policy == "lfu":
            self._freq[seq_hash] = 1
            self._push_heap(seq_hash)
        if parent is not None:
            self._link_parent(seq_hash, parent)
        return evicted

    def get(self, seq_hash: int, k_out: Optional[torch.Tensor] = None,
            v_out: Optional[torch.Tensor] = None
            ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """The block's (k, v), counted as a hit and a touch. Written into
        `k_out`/`v_out` when given; else the host tier returns VIEWS into
        its pool (copy before a later put) and the disk tier new tensors."""
        slot = self._by_hash.get(seq_hash)
        if slot is None:
            self.misses += 1
            return None
        self.hits += 1
        self._touch(seq_hash)
        return self._read(slot, k_out, v_out)

    def peek(self, seq_hash: int, k_out=None, v_out=None):
        """As get, without counting or touching (read-only replication)."""
        slot = self._by_hash.get(seq_hash)
        return None if slot is None else self._read(slot, k_out, v_out)

    def clear(self) -> int:
        """Drop every block; data stays in place until overwritten."""
        n = len(self._by_hash)
        self._by_hash.clear()
        self._init_pool()
        return n

    def stats(self) -> dict:
        return {
            f"{self.name}_blocks": len(self._by_hash),
            f"{self.name}_capacity": self.capacity,
            f"{self.name}_hits": self.hits,
            f"{self.name}_misses": self.misses,
            f"{self.name}_evictions": self.evictions,
        }

    def _write(self, slot: int, k: torch.Tensor, v: torch.Tensor):
        raise NotImplementedError

    def _read(self, slot: int, k_out, v_out) -> Tuple[torch.Tensor, torch.Tensor]:
        raise NotImplementedError


class HostTier(_BlockPool):
    """G2: a preallocated host-RAM block pool, one `[capacity, *block_shape]`
    tensor each for K and V (pinned when `pin`). Evictions carry the block
    data so the manager can cascade them to disk."""

    name = "host"
    evict_with_data = True

    def __init__(self, capacity: int, block_shape: tuple, dtype: torch.dtype,
                 policy: str = "lru", pin: bool = False):
        super().__init__(capacity, block_shape, dtype, policy)
        shape = (capacity, *self.block_shape)
        self._k = torch.empty(shape, dtype=self.dtype, pin_memory=pin)
        self._v = torch.empty(shape, dtype=self.dtype, pin_memory=pin)
        self._init_pool()

    def _write(self, slot, k, v):
        self._k[slot].copy_(k.reshape(self.block_shape))
        self._v[slot].copy_(v.reshape(self.block_shape))

    def _read(self, slot, k_out, v_out):
        if k_out is None:
            return self._k[slot], self._v[slot]
        k_out.copy_(self._k[slot])
        v_out.copy_(self._v[slot])
        return k_out, v_out


def _pwrite_all(fd: int, buf: np.ndarray, offset: int):
    view = memoryview(buf)
    while len(view):
        n = os.pwrite(fd, view, offset)
        view, offset = view[n:], offset + n


def _pread_into(fd: int, buf: np.ndarray, offset: int):
    view = memoryview(buf)
    while len(view):
        n = os.preadv(fd, [view], offset)
        if n <= 0:
            raise OSError(f"short read of a KVBM pool file at offset {offset}")
        view, offset = view[n:], offset + n


class DiskTier(_BlockPool):
    """G3: a block pool in two files (`k.bin` / `v.bin`) with fixed block
    slots — the reference's fully-contiguous layout. The hash index is
    persisted to `index.json` by flush() (the engine calls it on close) and
    loaded when the pool files validate, so a restarted worker reuses warm
    blocks. Disk is the last tier: its evictions drop the block and carry
    no data."""

    name = "disk"
    evict_with_data = False

    def __init__(self, capacity: int, block_shape: tuple, dtype: torch.dtype, path: str,
                 policy: str = "lru"):
        super().__init__(capacity, block_shape, dtype, policy)
        self.path = path
        os.makedirs(path, exist_ok=True)
        index_path = os.path.join(path, "index.json")
        k_path = os.path.join(path, "k.bin")
        v_path = os.path.join(path, "v.bin")
        expected_bytes = capacity * self.block_bytes
        warm = False
        if all(os.path.exists(p) for p in (index_path, k_path, v_path)):
            try:
                with open(index_path) as f:
                    saved = json.load(f)
                if (
                    tuple(saved.get("block_shape", ())) == self.block_shape
                    and os.path.getsize(k_path) == expected_bytes
                    and os.path.getsize(v_path) == expected_bytes
                ):
                    self._by_hash = {
                        int(h): s for h, s in saved["index"].items() if 0 <= s < capacity
                    }
                    warm = True  # reuse the persisted blocks
            except (ValueError, KeyError, OSError):
                self._by_hash = {}
        flags = os.O_RDWR | os.O_CREAT | (0 if warm else os.O_TRUNC)
        self._fds = []
        for p in (k_path, v_path):
            fd = os.open(p, flags, 0o644)
            self._fds.append(fd)
            if not warm:
                os.ftruncate(fd, expected_bytes)  # zero-filled, as a new memmap
        self._init_pool()

    def put(self, seq_hash: int, k, v, parent: Optional[int] = None) -> Optional[int]:
        """Returns the dropped hash if the pool was full, else None."""
        evicted = super().put(seq_hash, k, v, parent=parent)
        return evicted[0] if evicted is not None else None

    def _write(self, slot, k, v):
        off = slot * self.block_bytes
        for fd, x in zip(self._fds, (k, v)):
            _pwrite_all(fd, byte_view(x.reshape(self.block_shape).contiguous()), off)

    def _read(self, slot, k_out, v_out):
        if k_out is None:
            k_out = torch.empty(self.block_shape, dtype=self.dtype)
            v_out = torch.empty(self.block_shape, dtype=self.dtype)
        off = slot * self.block_bytes
        for fd, x in zip(self._fds, (k_out, v_out)):
            _pread_into(fd, byte_view(x), off)
        return k_out, v_out

    def flush(self):
        """Persist the pool and its index. Crash-consistent: the index is
        written to a temp file and atomically renamed over index.json, so a
        crash mid-flush leaves the previous index intact. Call through
        KvBlockManager.flush(), which holds the manager lock."""
        for fd in self._fds:
            os.fsync(fd)
        index = {str(h): s for h, s in self._by_hash.items()}
        index_path = os.path.join(self.path, "index.json")
        tmp_path = index_path + ".tmp"
        with open(tmp_path, "w") as f:
            json.dump({"block_shape": self.block_shape, "index": index}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp_path, index_path)

    def close(self):
        fds, self._fds = self._fds, []
        for fd in fds:
            os.close(fd)
