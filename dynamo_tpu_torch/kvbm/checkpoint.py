"""Session KV checkpointing: replicate committed blocks into a peer's host tier.

Port of `dynamo_tpu/kvbm/checkpoint.py`. With incremental commit, a live
session's KV blocks reach the local tiers as decode fills pages; this
module pushes them on to a PEER worker's host tier (G2) over the KV data
plane, so a SIGKILL loses at most the un-checkpointed tail — the survivor
onboards the replicated prefix through the normal onboard budget instead of
recomputing the whole prefill.

  * the stage is a BOUNDED queue (`DYN_KV_CHECKPOINT` = max staged blocks)
    that refuses the NEWEST block on overflow: a resume only uses a
    CONTIGUOUS replicated prefix, so dropping the front would turn every
    later block into dead weight, while refusing the tail loses exactly
    what a death loses anyway. A refused block poisons its descendants for
    a while (a push behind a hole is unreachable);
  * block bytes are read from the local tiers with `read_blocks` (no
    promotion, no stat change) — the host tier is one pinned tensor, and a
    bf16 block travels as its 16-bit words — and pushed with the `kv_format`
    handshake of the peer-pull path, so a mixed-precision fleet refuses
    typed before any byte moves;
  * a batch is capped by bytes at half the server's CHECKPOINT_MAX_PAYLOAD;
  * push failures quarantine the peer (`note_peer_failure`) and drop the
    batch; a structural refusal (no tier there, another `kv_format`, another
    block geometry) excludes the peer from checkpointing for its lifetime.

`DYN_KV_CHECKPOINT=off` (the default) creates none of this.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from collections import deque
from typing import Deque, List, Optional, Tuple

logger = logging.getLogger(__name__)

# blocks a push batch at most; the byte cap below usually binds first
_PUSH_BATCH = 64


def checkpoint_queue_blocks(raw: Optional[str] = None) -> int:
    """Parse DYN_KV_CHECKPOINT: 'off'/''/'0' -> 0 (disabled), an integer
    N -> stage at most N blocks. A typo disables with a warning."""
    raw = raw if raw is not None else os.environ.get("DYN_KV_CHECKPOINT")
    if not raw:
        return 0
    raw = raw.strip().lower()
    if raw in ("off", "0", "false", "no"):
        return 0
    try:
        return max(int(raw), 0)
    except ValueError:
        logger.warning("DYN_KV_CHECKPOINT=%r unknown; checkpointing off", raw)
        return 0


class KvCheckpointer:
    """Bounded replication stage between the local tiers and a peer's G2.

    Blocks arrive from the kvbm-tier thread (`stage_threadsafe`); the
    consumer task runs on the event loop, draining batches, reading block
    bytes read-only and pushing them over the data plane. All queue state
    is confined to the event loop."""

    def __init__(self, distributed, max_blocks: int):
        self.dist = distributed
        self.max_blocks = max(int(max_blocks), 1)
        self._queue: Deque[Tuple[int, Optional[int]]] = deque()
        # hashes dropped anywhere on the path -> monotonic deadline: a later
        # block whose chain parent is here is refused too. Entries expire
        # (a stale hole risks wasted bytes, never wrong bytes)
        self._refused: dict = {}
        self._refused_ttl_s = 120.0
        self._wake = asyncio.Event()
        self._closed = False
        self._oversize_logged = False
        self.blocks_staged = 0
        self.blocks_pushed = 0
        self.bytes_pushed = 0
        self.blocks_dropped = 0
        self.push_failures = 0
        self.format_refusals = 0
        self.push_s = 0.0  # wall seconds of completed pushes
        self.last_peer: Optional[int] = None

    # -- staging (any thread) ------------------------------------------- #

    def stage_threadsafe(self, hashes, parents):
        loop = self.dist._loop
        if loop is None or self._closed:
            return
        try:
            loop.call_soon_threadsafe(self._stage, [int(h) for h in hashes], list(parents))
        except RuntimeError:
            pass  # the loop closed under a late store: the replica is lost

    def _stage(self, hashes: List[int], parents: List[Optional[int]]):
        if self._closed:
            return
        for h, p in zip(hashes, parents):
            if len(self._queue) >= self.max_blocks or self._poisoned(p):
                self.blocks_dropped += 1
                self._poison([h])
                continue
            # a re-offered block repairs its own hole
            self._refused.pop(h, None)
            self._queue.append((h, p))
            self.blocks_staged += 1
        self._wake.set()

    def _poisoned(self, h) -> bool:
        if h is None:
            return False
        dl = self._refused.get(h)
        if dl is None:
            return False
        if time.monotonic() >= dl:
            del self._refused[h]
            return False
        return True

    def _poison(self, hashes):
        now = time.monotonic()
        if len(self._refused) >= 4 * self.max_blocks:
            # bounded: purge expired entries, then shed the oldest deadlines
            self._refused = {k: v for k, v in self._refused.items() if v > now}
            while len(self._refused) >= 4 * self.max_blocks:
                self._refused.pop(min(self._refused, key=self._refused.get))
        dl = now + self._refused_ttl_s
        for h in hashes:
            self._refused[int(h)] = dl

    # -- consumer (event loop task) ------------------------------------- #

    async def run(self):
        while not self._closed:
            # a failed iteration drops a batch, never the task: a dead
            # checkpointer would freeze the kvbm_ckpt_* counters
            try:
                await self._run_once()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — replication is best-effort
                logger.exception("kv checkpoint iteration failed; continuing")
                await asyncio.sleep(1.0)

    async def _run_once(self):
        from ..llm import kv_transfer
        from ..runtime import faults

        if not self._queue:
            self._wake.clear()
            await self._wake.wait()
            return
        cap = kv_transfer.CHECKPOINT_MAX_PAYLOAD
        per_block = max(int(self.dist.manager.block_nbytes), 1)
        if per_block > cap:
            # no server accepts a single block: shed without dialing, so a
            # torn push never reads as a dead (quarantined) peer
            if not self._oversize_logged:
                self._oversize_logged = True
                logger.warning("kv checkpoint disabled: block_nbytes %d exceeds the "
                               "data-plane payload cap %d", per_block, cap)
            self.blocks_dropped += len(self._queue)
            self._poison([h for h, _ in self._queue])
            self._queue.clear()
            return
        max_batch = max(1, min(_PUSH_BATCH, (cap // 2) // per_block))
        batch: List[Tuple[int, Optional[int]]] = []
        while self._queue and len(batch) < max_batch:
            batch.append(self._queue.popleft())
        peer = self.dist.checkpoint_peer()
        if peer is None:
            # no ready peer: drop and poison (staging forever would turn the
            # bound into a stall)
            self.blocks_dropped += len(batch)
            self._poison([h for h, _ in batch])
            return
        inst, addr = peer
        self.last_peer = inst
        hashes = [h for h, _ in batch]
        parents = {h: p for h, p in batch}
        # the tier read copies up to a batch of blocks under the manager's
        # lock: off the event loop
        try:
            present, k, v = await asyncio.get_running_loop().run_in_executor(
                None, self.dist.manager.read_blocks, hashes)
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — the peer is blameless here
            self.blocks_dropped += len(hashes)
            self._poison(hashes)
            logger.exception("kv checkpoint read failed; batch dropped")
            return
        missing = set(hashes) - set(present)
        if missing:
            self.blocks_dropped += len(missing)
            self._poison(missing)
            # descendants of a read-time hole are unreachable for a
            # contiguous resume: drop them too (staged FIFO: parents first)
            dead = set(missing)
            for h in present:
                if parents.get(h) in dead:
                    dead.add(h)
            stranded = [h for h in present if h in dead]
            if stranded:
                self.blocks_dropped += len(stranded)
                self._poison(stranded)
                idx = [i for i, h in enumerate(present) if h not in dead]
                present = [present[i] for i in idx]
                k, v = k[idx], v[idx]
        if not present:
            return
        t0 = time.perf_counter()
        try:
            f = faults.FAULTS
            if f.enabled and await f.on("kv_transfer.checkpoint") == "sever":
                raise ConnectionError("injected: checkpoint push severed")
            await kv_transfer.push_checkpoint_blocks(
                addr, present, [parents.get(h) for h in present], k, v,
                kv_format=self.dist.manager.kv_format)
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — replication is best-effort
            structural = isinstance(e, kv_transfer.KvFormatError)
            if structural:
                self.format_refusals += 1
            self.push_failures += 1
            self.blocks_dropped += len(present)
            self._poison(present)
            if structural or getattr(e, "ckpt_ineligible", False):
                # never heals while the instance lives: exclude it durably
                # (its pull roles stay)
                self.dist.note_checkpoint_ineligible(inst)
            elif not getattr(e, "peer_blameless", False):
                # peer_blameless = our own oversized batch
                self.dist.note_peer_failure(inst)
            logger.warning("kv checkpoint push to %x (%s) failed: %s", inst, addr, e)
            return
        self.push_s += time.perf_counter() - t0
        self.blocks_pushed += len(present)
        self.bytes_pushed += int(k.nbytes) + int(v.nbytes)

    def stats(self) -> dict:
        out = {
            "kvbm_ckpt_blocks_staged": self.blocks_staged,
            "kvbm_ckpt_blocks_pushed": self.blocks_pushed,
            "kvbm_ckpt_bytes_pushed": self.bytes_pushed,
            "kvbm_ckpt_blocks_dropped": self.blocks_dropped,
            "kvbm_ckpt_push_failures": self.push_failures,
            "kvbm_ckpt_format_refusals": self.format_refusals,
            "kvbm_ckpt_queue_depth": len(self._queue),
            "kvbm_ckpt_push_s": round(self.push_s, 6),
        }
        if self.last_peer is not None:
            out["kvbm_ckpt_last_peer"] = f"{self.last_peer:x}"
        return out

    def close(self):
        self._closed = True
        self._wake.set()
