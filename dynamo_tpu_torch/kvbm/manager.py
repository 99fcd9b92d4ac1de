"""KvBlockManager: tier policy + the engine connector.

Port of `dynamo_tpu/kvbm/manager.py`. A block goes down the G1 -> G2 -> G3
chain when it is committed (hash bound) and comes back up at admission when
the device prefix cache misses it. The data path is a pipeline:

  * offload is WRITE-THROUGH at block-commit time, BATCHED per engine step:
    every commit stages its (hash, page) pairs; the engine's
    `flush_step()` submits ONE gather for all of them to its device
    executor. The gather is enqueued on the compute stream before any later
    dispatch can rewrite those pages (the executor is FIFO, and the engine
    also flushes when it releases a slot, whose pages a later dispatch in
    the same step may reuse), and
    its device-to-host copy into pinned memory runs on the side copy stream
    behind an event. The host store, the G2 -> G3 cascade and the file I/O
    run on a dedicated `kvbm-tier` thread that waits on that event.
  * the staged -> stored path is a BOUNDED queue: when the tier thread
    falls behind, the OLDEST batch is dropped (blocks are cache copies —
    a drop loses a future hit, never correctness) and counted.
  * onboard happens at admission: after the device prefix cache, the engine
    probes the tiers (and, with the announcement mesh, peers: G4) for the
    next hashes of the chain; hits are injected into freshly allocated
    device pages before prefill. Under DYN_SCHED_POLICY=sla the three-arm
    budget compares the tiers' observed per-block load time with the slot's
    TTFT headroom and recompute.

DYN_KVBM_PIPELINE=0 keeps the reference's inline arm (one gather + store per
commit, on the device executor), a parity switch of the reference.

Failures of the device gather or inject are not caught: on the card a
failed copy is a CUDA error that has already poisoned the context, so it
propagates to the step loop like any other device error. The semantic
misses stay, as in the reference: a block evicted between probe and load
(KeyError), an injected `kvbm.onboard` / `kvbm.offload` fault, and a peer of
another KV format (KvFormatError).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import faults
from .storage import EVICTION_POLICIES, DiskTier, HostTier

logger = logging.getLogger(__name__)


def _parse_eviction(spec: Optional[str]) -> Tuple[str, str]:
    """DYN_KVBM_EVICTION: one policy (`lru`) for both tiers, or
    `host=lfu,disk=lru`. Unknown spellings fall back to lru."""
    spec = spec if spec is not None else os.environ.get("DYN_KVBM_EVICTION")
    if not spec:
        return "lru", "lru"
    spec = spec.strip().lower()
    if "=" not in spec:
        if spec not in EVICTION_POLICIES:
            logger.warning("DYN_KVBM_EVICTION=%r unknown; using lru", spec)
            spec = "lru"
        return spec, spec
    out = {"host": "lru", "disk": "lru"}
    for part in spec.split(","):
        tier, _, pol = part.partition("=")
        tier, pol = tier.strip(), pol.strip()
        if tier not in out or pol not in EVICTION_POLICIES:
            logger.warning("DYN_KVBM_EVICTION part %r unknown; ignoring", part)
            continue
        out[tier] = pol
    return out["host"], out["disk"]


@dataclass
class KvbmConfig:
    host_blocks: int = 0  # G2 capacity (0 disables the tier)
    disk_blocks: int = 0  # G3 capacity (0 disables the tier)
    disk_path: Optional[str] = None
    eviction: Optional[str] = None  # None -> DYN_KVBM_EVICTION -> lru


class KvBlockManager:
    """Owns the G2/G3 tiers and the offload/onboard policy. `pin` allocates
    the host tier and every onboard's staging buffer in pinned memory (a
    machine with a CUDA device)."""

    def __init__(self, cfg: KvbmConfig, block_shape: tuple, dtype: torch.dtype,
                 kv_format: str = "none", pin: bool = False):
        self.cfg = cfg
        self.block_shape = tuple(int(d) for d in block_shape)
        self.dtype = dtype
        self.pin = pin
        # the page format the tiers hold: under int8/int4 a block is one
        # packed uint8 row per layer; it travels in the peer-pull handshake
        self.kv_format = str(kv_format)
        # K+V bytes a block (the data plane's inline-vs-executor decision)
        self.block_nbytes = 2 * int(np.prod(self.block_shape)) * self.dtype.itemsize
        if cfg.disk_blocks > 0 and not cfg.disk_path:
            raise ValueError("kvbm_disk_blocks > 0 requires kvbm_disk_path")
        host_policy, disk_policy = _parse_eviction(cfg.eviction)
        t0 = time.perf_counter()
        self.host: Optional[HostTier] = (
            HostTier(cfg.host_blocks, self.block_shape, self.dtype, policy=host_policy,
                     pin=pin)
            if cfg.host_blocks > 0 else None
        )
        # seconds the host tier's (pinned) allocation took
        self.host_alloc_s = time.perf_counter() - t0
        self.disk: Optional[DiskTier] = (
            DiskTier(cfg.disk_blocks, self.block_shape, self.dtype, cfg.disk_path,
                     policy=disk_policy)
            if cfg.disk_blocks > 0 else None
        )
        self._lock = threading.Lock()  # the kvbm-tier thread stores
        self.offloaded_blocks = 0
        self.onboarded_blocks = 0
        self.disk_evictions = 0
        self.dropped_blocks = 0
        # hashes that fell off the whole tier chain since the last drain:
        # the announcement mesh retracts them
        self._evicted_pending: List[int] = []
        # per-tier per-block load time EWMA (ms), None until observed: a
        # cold tier never defers an onboard
        self._load_ms: dict = {"host": None, "disk": None}

    # -- store path (kvbm-tier thread) ---------------------------------- #

    def _cascade(self, evicted):
        """A host-tier eviction goes down to disk (or out of the chain)."""
        old_hash, old_k, old_v, old_parent = evicted
        if self.disk is not None:
            dropped = self.disk.put(old_hash, old_k, old_v, parent=old_parent)
            if dropped is not None:
                self.dropped_blocks += 1
                self._evicted_pending.append(int(dropped))
            self.disk_evictions += 1
        else:
            self.dropped_blocks += 1
            self._evicted_pending.append(int(old_hash))

    def store(self, seq_hash: int, k, v, parent: Optional[int] = None):
        """Insert one block at the top of the G2 -> G3 chain, cascading the
        host tier's eviction down to disk. `parent` = the preceding chain
        hash when known (prefix-aware eviction)."""
        with self._lock:
            if self.host is not None:
                evicted = self.host.put(seq_hash, k, v, parent=parent)
                self.offloaded_blocks += 1
                if evicted is not None:
                    self._cascade(evicted)
            elif self.disk is not None:
                dropped = self.disk.put(seq_hash, k, v, parent=parent)
                if dropped is not None:
                    self.dropped_blocks += 1
                    self._evicted_pending.append(int(dropped))
                self.offloaded_blocks += 1

    def drain_evicted(self) -> List[int]:
        """Hashes dropped from ALL tiers since the last drain, re-checked
        against the current tiers (a hash re-stored since its drop is live)."""
        with self._lock:
            pending, self._evicted_pending = self._evicted_pending, []
            out: List[int] = []
            seen = set()
            for h in pending:
                if h in seen:
                    continue
                seen.add(h)
                if not self._has(h):
                    out.append(h)
            return out

    def all_hashes(self) -> List[int]:
        """Every block hash held in any tier (the mesh's sync reply)."""
        with self._lock:
            out = set()
            for tier in (self.host, self.disk):
                if tier is not None:
                    out.update(tier.hashes())
            return sorted(out)

    def _has(self, seq_hash: int) -> bool:
        return ((self.host is not None and self.host.has(seq_hash))
                or (self.disk is not None and self.disk.has(seq_hash)))

    def has(self, seq_hash: int) -> bool:
        with self._lock:
            return self._has(seq_hash)

    # -- lookup path (event loop) ---------------------------------------- #

    def match_prefix(self, hashes: Sequence[int]) -> List[int]:
        """Longest leading run of `hashes` present in any tier."""
        out: List[int] = []
        for h in hashes:
            if not self.has(h):
                break
            out.append(h)
        return out

    def estimate_load_ms(self, hashes: Sequence[int]) -> Optional[float]:
        """Projected load_blocks time for `hashes` from the per-tier EWMAs;
        None when a needed tier was never observed or a hash is not here."""
        with self._lock:
            total = 0.0
            for h in hashes:
                if self.host is not None and self.host.has(h):
                    ms = self._load_ms["host"]
                elif self.disk is not None and self.disk.has(h):
                    ms = self._load_ms["disk"]
                else:
                    return None
                if ms is None:
                    return None
                total += ms
            return total

    def _staging(self, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
        shape = (n, *self.block_shape)
        return (torch.empty(shape, dtype=self.dtype, pin_memory=self.pin),
                torch.empty(shape, dtype=self.dtype, pin_memory=self.pin))

    def load_blocks(self, hashes: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fetch blocks (host first, then disk, promoting disk hits to host)
        stacked on a leading axis, `[n, *block_shape]`, into a fresh
        (pinned) staging buffer. Raises KeyError on a miss."""
        ks, vs = self._staging(len(hashes))
        with self._lock:
            for i, h in enumerate(hashes):
                t0 = time.perf_counter()
                got = self.host.get(h, ks[i], vs[i]) if self.host is not None else None
                src = "host"
                if got is None and self.disk is not None:
                    got = self.disk.get(h, ks[i], vs[i])
                    src = "disk"
                    if got is not None and self.host is not None:
                        # promotion keeps the chain link (prefix-aware)
                        evicted = self.host.put(h, ks[i], vs[i],
                                                parent=self.disk._parent.get(h))
                        if evicted is not None:
                            self._cascade(evicted)
                if got is None:
                    raise KeyError(f"KVBM block {h} vanished between probe and load")
                ms = (time.perf_counter() - t0) * 1000.0
                prev = self._load_ms[src]
                self._load_ms[src] = ms if prev is None else 0.8 * prev + 0.2 * ms
            self.onboarded_blocks += len(hashes)
        return ks, vs

    def read_blocks(self, hashes: Sequence[int]) -> Tuple[List[int], torch.Tensor, torch.Tensor]:
        """Read-only fetch (no promotion, no hit/miss/onboard accounting, no
        recency touch); missing hashes are skipped. Returns (present
        hashes, k [n, ...], v [n, ...])."""
        with self._lock:
            present = [int(h) for h in hashes if self._has(h)]
            if not present:
                return [], torch.empty((0,)), torch.empty((0,))
            ks, vs = self._staging(len(present))
            for i, h in enumerate(present):
                tier = self.host if self.host is not None and self.host.has(h) else self.disk
                tier.peek(h, ks[i], vs[i])
        return present, ks, vs

    def close(self):
        """Persist the disk tier's index and close its files (engine close)."""
        with self._lock:
            if self.disk is not None:
                self.disk.flush()
                self.disk.close()

    def clear(self) -> int:
        """Drop every tiered block (admin clear-kv-blocks)."""
        with self._lock:
            n = 0
            if self.host is not None:
                n += self.host.clear()
            if self.disk is not None:
                n += self.disk.clear()
                self.disk.flush()  # persist the now-empty index
            return n

    def stats(self) -> dict:
        with self._lock:
            out = {
                "kvbm_offloaded_blocks": self.offloaded_blocks,
                "kvbm_onboarded_blocks": self.onboarded_blocks,
                "kvbm_disk_evictions": self.disk_evictions,
                "kvbm_dropped_blocks": self.dropped_blocks,
            }
            if self.host is not None:
                out.update({f"kvbm_{k}": v for k, v in self.host.stats().items()})
                out["kvbm_host_eviction_policy"] = self.host.policy
            if self.disk is not None:
                out.update({f"kvbm_{k}": v for k, v in self.disk.stats().items()})
                out["kvbm_disk_eviction_policy"] = self.disk.policy
            for tier, ms in self._load_ms.items():
                if ms is not None:
                    out[f"kvbm_{tier}_load_ms_per_block"] = round(ms, 3)
            return out


@dataclass
class _OffloadBatch:
    """One step's coalesced commits awaiting the tier thread. `k`/`v` are
    host tensors `[layers, n, ...]` in the wire layout; `event` (CUDA) is
    recorded after their device-to-host copy was enqueued."""

    hashes: List[int]
    parents: List[Optional[int]]
    k: object = None
    v: object = None
    event: object = None
    ready: bool = False  # gather enqueued (k/v set)
    dropped: bool = False  # backpressure victim: the tier thread skips it
    # "offload" = this worker's own commits (staged for checkpointing);
    # "promotion" = peer-pulled blocks, already durable on their owner
    origin: str = "offload"


class KvbmConnector:
    """Engine-side glue. Holds the engine for its offload gather
    (`_dev_offload_gather`), its serial device executor and `_timed`."""

    def __init__(self, engine, manager: KvBlockManager):
        from ..runtime.config import env_bool

        self.engine = engine
        self.manager = manager
        self.pipelined = env_bool("DYN_KVBM_PIPELINE", True)
        # cluster KV fabric: admission may onboard blocks from a PEER's
        # tiers over the data plane
        self.peer_pull = env_bool("DYN_KVBM_PEER_PULL", True)
        try:
            self.queue_cap = max(int(os.environ.get("DYN_KVBM_OFFLOAD_QUEUE") or 8), 1)
        except ValueError:
            self.queue_cap = 8
        self._pending = 0
        self._pending_lock = threading.Lock()  # inline arm only
        # pipeline state, all guarded by _offload_cv's lock
        self._offload_cv = threading.Condition()
        self._staged: List[Tuple[int, int, Optional[int]]] = []  # (hash, page, parent)
        self._queue: Deque[_OffloadBatch] = deque()
        self._inflight_hashes: set = set()
        self._processing = 0
        self._tier_thread: Optional[threading.Thread] = None
        self._stopped = False
        self.offload_commit_calls = 0
        self.offload_gathers = 0
        self.offload_batches_dropped = 0
        self.offload_blocks_dropped = 0
        self.offload_failures = 0
        self.onboard_recompute_fallbacks = 0
        self.onboard_src_local_blocks = 0
        self.onboard_src_peer_blocks = 0
        self.onboard_src_recompute_blocks = 0
        # kvbm/distributed.py attaches itself here (the G4 role)
        self.distributed = None

    # -- offload (event loop: stage at commit, flush once per step) ------ #

    def offload_commit(self, seq_hashes: List[int], phys_pages: List[int],
                       parent: Optional[int] = None):
        """Write-through: snapshot just-committed device pages into G2.
        Pipelined: stage the pairs for the step's one gather. Inline
        (DYN_KVBM_PIPELINE=0): one gather + store per call on the device
        executor. `parent` = the hash before `seq_hashes[0]`."""
        if not self.pipelined:
            self._offload_commit_inline(seq_hashes, phys_pages, parent)
            return
        # probe before taking the cv: manager._lock never nests under it
        missing = {h for h in seq_hashes if not self.manager.has(h)}
        with self._offload_cv:
            self.offload_commit_calls += 1
            prev = parent
            for h, p in zip(seq_hashes, phys_pages):
                if h in missing and h not in self._inflight_hashes:
                    self._staged.append((h, p, prev))
                    self._inflight_hashes.add(h)
                prev = h

    def _push(self, batch: _OffloadBatch):
        """Queue a batch, dropping the oldest under backpressure. Caller
        holds _offload_cv."""
        while len(self._queue) >= self.queue_cap:
            victim = self._queue.popleft()
            victim.dropped = True
            self.offload_batches_dropped += 1
            self.offload_blocks_dropped += len(victim.hashes)
            self._inflight_hashes.difference_update(victim.hashes)
        self._queue.append(batch)
        self._ensure_tier_thread()

    def flush_step(self):
        """Submit ONE gather for everything staged since the last flush to
        the engine's device executor. Returns its future (None when nothing
        was staged): the engine awaits it, so a device error surfaces in
        the step loop."""
        with self._offload_cv:
            if self._stopped or not self._staged:
                return None
            staged, self._staged = self._staged, []
            batch = _OffloadBatch(hashes=[h for h, _, _ in staged],
                                  parents=[par for _, _, par in staged])
            self._push(batch)
            self.offload_gathers += 1
        pages = np.array([p for _, p, _ in staged], np.int32)
        eng = self.engine

        def run_gather():
            k, v, event = eng._dev_offload_gather(pages)
            with self._offload_cv:
                batch.k, batch.v, batch.event = k, v, event
                batch.ready = True
                self._offload_cv.notify_all()

        return eng._device_exec.submit(eng._timed(run_gather, "kvbm_offload"))

    def stage_promotion(self, hashes: Sequence[int], parents: Sequence[Optional[int]], k, v):
        """Promote peer-pulled blocks (`[n, ...]`) into the host tier off the
        onboard's critical path, through the same bounded queue."""
        batch = _OffloadBatch(hashes=[int(h) for h in hashes], parents=list(parents),
                              k=k.transpose(0, 1), v=v.transpose(0, 1), ready=True,
                              origin="promotion")
        with self._offload_cv:
            if self._stopped:
                return
            self._push(batch)
            self._inflight_hashes.update(batch.hashes)
            self._offload_cv.notify_all()

    def _ensure_tier_thread(self):
        """Caller holds _offload_cv."""
        if self._tier_thread is None or not self._tier_thread.is_alive():
            self._tier_thread = threading.Thread(
                target=self._tier_loop, name="kvbm-tier", daemon=True)
            self._tier_thread.start()

    def _drop(self, batch: _OffloadBatch, failed: bool):
        """Count a batch lost after it left the queue. Caller holds the cv."""
        if failed:
            self.offload_failures += 1
        self.offload_blocks_dropped += len(batch.hashes)
        self._inflight_hashes.difference_update(batch.hashes)

    def _tier_loop(self):
        """The tier thread: wait for the copy, store in G2, cascade to G3.
        One batch at a time, FIFO."""
        while True:
            with self._offload_cv:
                while not self._stopped and not (self._queue and self._queue[0].ready):
                    self._offload_cv.wait()
                if self._stopped and not self._queue:
                    return
                batch = self._queue.popleft()
                if not batch.ready:
                    # stopped with an un-gathered batch: nothing to store
                    self.offload_batches_dropped += 1
                    self._drop(batch, failed=False)
                    continue
                self._processing = len(batch.hashes)
            try:
                if batch.dropped:
                    continue
                try:
                    self._store_batch(batch)
                except faults.FaultError as e:
                    # dynochaos kvbm.offload `error`: the batch is dropped and
                    # counted; no stream notices
                    logger.warning("KVBM offload batch dropped (%s)", e)
                    with self._offload_cv:
                        self._drop(batch, failed=True)
                except Exception:  # noqa: BLE001 — the tier thread must not die
                    logger.exception("KVBM offload store failed; batch dropped")
                    with self._offload_cv:
                        self._drop(batch, failed=True)
            finally:
                with self._offload_cv:
                    self._processing = 0

    def _store_batch(self, batch: _OffloadBatch):
        f = faults.FAULTS
        if f.enabled:
            act = f.check("kvbm.offload")
            if act == "error":
                raise faults.FaultError("injected fault at kvbm.offload")
            if act == "delay":
                time.sleep(0.05)
        if batch.event is not None:
            batch.event.synchronize()  # the device-to-host copy has landed
        # [layers, n, ...] -> per-block [layers, ...]
        k, v = batch.k.transpose(0, 1), batch.v.transpose(0, 1)
        for i, h in enumerate(batch.hashes):
            self.manager.store(h, k[i], v[i], parent=batch.parents[i])
        with self._offload_cv:
            self._inflight_hashes.difference_update(batch.hashes)
        if self.distributed is not None:
            self.distributed.announce_threadsafe("stored", batch.hashes)
            self._announce_evictions()
            # session checkpointing: this worker's own committed blocks are
            # staged for replication into a peer's tier (bounded, never
            # blocks this thread); a promotion batch's blocks are already
            # durable on the peer that served them
            ck = self.distributed.checkpointer
            if ck is not None and batch.origin == "offload":
                ck.stage_threadsafe(batch.hashes, batch.parents)

    def _announce_evictions(self):
        """Retract fully-dropped hashes from the mesh (any thread)."""
        if self.distributed is None:
            return
        evicted = self.manager.drain_evicted()
        if evicted:
            self.distributed.announce_threadsafe("evicted", evicted)

    def _offload_commit_inline(self, seq_hashes: List[int], phys_pages: List[int],
                               parent: Optional[int] = None):
        """The inline arm (DYN_KVBM_PIPELINE=0): one gather + synchronous
        store per commit call, on the device executor."""
        todo = []
        prev = parent
        for h, p in zip(seq_hashes, phys_pages):
            if not self.manager.has(h):
                todo.append((h, p, prev))
            prev = h
        if not todo:
            return
        with self._offload_cv:
            self.offload_commit_calls += 1
            self.offload_gathers += 1
        eng = self.engine
        hashes = [h for h, _, _ in todo]
        parents = [par for _, _, par in todo]
        pages = np.array([p for _, p, _ in todo], np.int32)

        def run_extract():
            k, v, event = eng._dev_offload_gather(pages)
            if event is not None:
                event.synchronize()
            k, v = k.transpose(0, 1), v.transpose(0, 1)
            for i, h in enumerate(hashes):
                self.manager.store(h, k[i], v[i], parent=parents[i])
            if self.distributed is not None:
                self.distributed.announce_threadsafe("stored", hashes)
                self._announce_evictions()
                ck = self.distributed.checkpointer
                if ck is not None:
                    ck.stage_threadsafe(hashes, parents)

        with self._pending_lock:
            self._pending += 1

        def done(fut):
            with self._pending_lock:
                self._pending -= 1

        fut = eng._device_exec.submit(eng._timed(run_extract, "kvbm_offload"))
        fut.add_done_callback(done)

    # -- onboard (admission) --------------------------------------------- #

    def probe(self, hashes: Sequence[int], hint_instance: Optional[int] = None,
              hint_blocks: int = 0) -> List[int]:
        """Longest onboardable prefix: local tiers, extended by remote owners
        when the mesh is attached (G4), and by the router's holder hint."""
        local = self.manager.match_prefix(hashes)
        if self.peer_pull and self.distributed is not None and len(local) < len(hashes):
            return list(local) + self.distributed.extend_prefix(
                list(hashes)[len(local):], hint_instance=hint_instance,
                hint_blocks=max(hint_blocks - len(local), 0))
        return local

    def budget_onboard(
        self,
        hashes: List[int],
        headroom_ms: Optional[float],
        recompute_ms_per_block: Optional[float],
        hint_instance: Optional[int] = None,
    ) -> Tuple[List[int], str]:
        """Three-arm onboard budget: the cheapest source wins — local-tier
        load vs per-peer transfer vs recompute. Returns (hashes to onboard,
        decision), decision one of `full`, `trim-local` (keep the locally
        tiered prefix, recompute the rest) or `recompute`. Unknown costs
        never constrain (a cold tier, peer or cost model keeps the full
        onboard)."""
        if not hashes:
            return hashes, "full"
        local_mask = [self.manager.has(h) for h in hashes]
        n_total = len(hashes)
        local_part = [h for h, m in zip(hashes, local_mask) if m]
        peer_part = [h for h, m in zip(hashes, local_mask) if not m]
        est_local = self.manager.estimate_load_ms(local_part) if local_part else 0.0
        if peer_part and (self.distributed is None or not self.peer_pull):
            est_peer = None  # a racing eviction demoted a local hash
        elif peer_part:
            est_peer = self.distributed.estimate_pull_ms(peer_part, hint_instance=hint_instance)
        else:
            est_peer = 0.0
        est_full = (est_local + est_peer
                    if est_local is not None and est_peer is not None else None)
        if headroom_ms is None or est_full is None or est_full <= headroom_ms:
            self._count_onboard(len(local_part), len(peer_part), 0)
            return hashes, "full"
        if recompute_ms_per_block is None:
            self._count_onboard(len(local_part), len(peer_part), 0)
            return hashes, "full"
        n_local_prefix = 0
        for m in local_mask:
            if not m:
                break
            n_local_prefix += 1
        est_prefix = (self.manager.estimate_load_ms(hashes[:n_local_prefix])
                      if n_local_prefix else 0.0)
        cost_b = (est_prefix + recompute_ms_per_block * (n_total - n_local_prefix)
                  if est_prefix is not None else None)
        cost_c = recompute_ms_per_block * n_total
        best, decision = est_full, "full"
        if cost_c < best:
            best, decision = cost_c, "recompute"
        if cost_b is not None and n_local_prefix and cost_b < best:
            best, decision = cost_b, "trim-local"
        if decision == "full":
            self._count_onboard(len(local_part), len(peer_part), 0)
            return hashes, "full"
        if decision == "trim-local":
            kept = hashes[:n_local_prefix]
            self._count_onboard(len(kept), 0, n_total - len(kept))
            self.note_onboard_recompute()
            return kept, "trim-local"
        self._count_onboard(0, 0, n_total)
        self.note_onboard_recompute()
        return [], "recompute"

    def _count_onboard(self, n_local: int, n_peer: int, n_recompute: int):
        with self._offload_cv:
            self.onboard_src_local_blocks += n_local
            self.onboard_src_peer_blocks += n_peer
            self.onboard_src_recompute_blocks += n_recompute

    def note_onboard_recompute(self):
        """An onboard (or part of one) lost to recompute in the budget."""
        with self._offload_cv:
            self.onboard_recompute_fallbacks += 1

    def any_checkpoint(self, hashes: Sequence[int]) -> bool:
        """True when any of `hashes` is a session-checkpoint replica (pushed
        into this worker's tiers by a peer, or announced as checkpointed
        elsewhere): the engine's resume classifier."""
        return self.distributed is not None and self.distributed.any_checkpoint(hashes)

    async def load_async(self, hashes: Sequence[int], run,
                         hint_instance: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Onboard path: local tier reads through `run` (an awaitable
        executor call), remote blocks pulled point to point from their owner
        and promoted into the local host tier. Returns `[n, *block_shape]`
        host tensors. Raises KeyError on any miss (the engine prefills that
        span); an injected `kvbm.onboard` fault and a peer's typed transport
        failure ride the same fallback; KvFormatError stays typed."""
        f = faults.FAULTS
        if f.enabled:
            await f.on("kvbm.onboard")
        local = [h for h in hashes if self.manager.has(h)]
        remote = [h for h in hashes if not self.manager.has(h)]
        parent_of: dict = {}
        prev = None
        for h in hashes:
            parent_of[h] = prev
            prev = h
        parts: dict = {}
        if remote:
            if self.distributed is None or not self.peer_pull:
                raise KeyError(f"kvbm blocks {remote[:3]}... not tiered here")
            from ..llm.kv_transfer import KvFormatError

            try:
                rk, rv = await self.distributed.pull_blocks(remote, hint_instance=hint_instance)
            except (KeyError, KvFormatError):
                raise
            except Exception as e:  # noqa: BLE001 — a dead or severed peer -> recompute
                raise KeyError(f"kvbm remote pull failed: {e}") from e
            if self.pipelined:
                self.stage_promotion(remote, [parent_of[h] for h in remote], rk, rv)
            else:
                def promote():
                    for i, h in enumerate(remote):
                        self.manager.store(h, rk[i], rv[i], parent=parent_of[h])

                await run(promote)
            if not local:
                return rk, rv
            for i, h in enumerate(remote):
                parts[h] = (rk[i], rv[i])
        if local:
            lk, lv = await run(self.manager.load_blocks, local)
            # a disk -> host promotion can cascade drops: retract them
            self._announce_evictions()
            if not remote:
                return lk, lv
            for i, h in enumerate(local):
                parts[h] = (lk[i], lv[i])
        return (torch.stack([parts[h][0] for h in hashes]),
                torch.stack([parts[h][1] for h in hashes]))

    def clear(self) -> int:
        n = self.manager.clear()
        if self.distributed is not None:
            self.distributed.announce("cleared", [])
        return n

    def pending_offloads(self) -> int:
        """Staged pairs + queued batches' blocks + the batch mid-store +
        inline jobs (engine close() drains on this)."""
        with self._offload_cv:
            n = (len(self._staged) + sum(len(b.hashes) for b in self._queue)
                 + self._processing)
        with self._pending_lock:
            n += self._pending
        return n

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Block (callers off the event loop only) until every staged or
        queued offload is stored or dropped. False on timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.pending_offloads() == 0:
                return True
            time.sleep(0.005)
        return self.pending_offloads() == 0

    def shutdown(self):
        """Stop the tier thread once the queue empties."""
        with self._offload_cv:
            self._stopped = True
            self._offload_cv.notify_all()
        t = self._tier_thread
        if t is not None and t.is_alive():
            t.join(timeout=5.0)

    def stats(self) -> dict:
        with self._offload_cv:
            out = {
                "kvbm_offload_commit_calls": self.offload_commit_calls,
                "kvbm_offload_gathers": self.offload_gathers,
                "kvbm_offload_queue_depth": len(self._queue),
                "kvbm_offload_staged_blocks": len(self._staged),
                "kvbm_offload_batches_dropped": self.offload_batches_dropped,
                "kvbm_offload_blocks_dropped": self.offload_blocks_dropped,
                "kvbm_offload_failures": self.offload_failures,
                "kvbm_onboard_recompute_fallbacks": self.onboard_recompute_fallbacks,
                "kvbm_onboard_src_local_blocks": self.onboard_src_local_blocks,
                "kvbm_onboard_src_peer_blocks": self.onboard_src_peer_blocks,
                "kvbm_onboard_src_recompute_blocks": self.onboard_src_recompute_blocks,
            }
        out.update(self.manager.stats())
        out["kvbm_pending_offloads"] = self.pending_offloads()
        if self.distributed is not None:
            out.update(self.distributed.stats())
        return out
