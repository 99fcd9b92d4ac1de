"""Distributed KVBM: cross-worker block sharing over the KV data plane.

Port of `dynamo_tpu/kvbm/distributed.py`, a symmetric announcement mesh
(no leader):
  * every KVBM-enabled worker announces stored / evicted / cleared block
    hashes on the discovery topic `kvbm_blocks/{ns}/{comp}` and serves block
    reads on its KV data plane (llm/kv_transfer.py resolves `{"blocks":
    [...]}` requests straight from the tier manager);
  * every worker mirrors the announcements into hash -> {instance} plus the
    peers' data-plane addresses (the `v1/kv_data_plane/` entries), so an
    admission probe extends the local tier prefix with remote hits;
  * onboarding pulls the missing blocks point to point from their owner and
    promotes them into the local host tier, so repeat hits are local.

The remote peers' pools are the G4 tier. A peer whose pull failed is
quarantined for a while; an owner whose tiers dropped a block retracts it.
With `DYN_KV_CHECKPOINT=N` the session checkpointer (`kvbm/checkpoint.py`)
replicates this worker's committed blocks into its ring successor's host
tier; replicas pushed here are tagged and announced as `checkpoint`, which
is how a survivor classifies a migrated stream's resume.
"""

from __future__ import annotations

import asyncio
import json
import logging
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch

logger = logging.getLogger(__name__)

KVBM_TOPIC_FMT = "kvbm_blocks/{namespace}/{component}"


class KvbmDistributed:
    """The announcement mesh + remote pull for one worker's KVBM."""

    def __init__(self, drt, connector, data_plane, namespace: str, component: str,
                 instance_id: int):
        self.drt = drt
        self.connector = connector
        self.manager = connector.manager
        self.data_plane = data_plane
        self.topic = KVBM_TOPIC_FMT.format(namespace=namespace, component=component)
        self.instance_id = instance_id
        # hash -> instances that announced it; instance -> data plane addr
        self._owners: Dict[int, Set[int]] = {}
        self._addrs: Dict[int, str] = {}
        self._sub = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._task: Optional[asyncio.Task] = None
        self._addr_task: Optional[asyncio.Task] = None
        self._drain_task: Optional[asyncio.Task] = None
        self._addr_watch = None
        self._bg: set = set()
        self.remote_onboards = 0
        self.remote_blocks_pulled = 0
        self.remote_bytes_pulled = 0
        self.remote_pull_failures = 0
        # per-peer pull time EWMA (ms a block, by data-plane addr): the
        # budget's third arm; None until a pull is observed
        self._pull_ms_per_block: Dict[str, float] = {}
        # session checkpointing (DYN_KV_CHECKPOINT): None when off
        self.checkpointer = None
        self._ckpt_task: Optional[asyncio.Task] = None
        # hashes known to be checkpoint replicas (pushed into our tiers, or
        # announced as such): the engine's resume classifier reads them
        self._ckpt_hashes: set = set()
        # peers that refused a checkpoint push for a structural reason (no
        # tier, another kv_format or block geometry): excluded from
        # checkpoint peering until their data plane's lease goes
        self._ckpt_ineligible: Set[int] = set()
        # peers whose data plane failed us, quarantined until the deadline;
        # a fresh announcement lifts it, lease expiry removes it
        self._dead: Dict[int, float] = {}
        self._pull_hist_bounds = (5.0, 20.0, 50.0, 100.0, 250.0, 1000.0)
        self._pull_hist = [0] * (len(self._pull_hist_bounds) + 1)
        self._pull_ms_sum = 0.0
        if data_plane is not None:
            data_plane.kvbm_source = self.manager
            data_plane.kvbm_distributed = self
        connector.distributed = self

    async def start(self):
        from ..llm.kv_transfer import DATA_PLANE_ROOT
        from .checkpoint import KvCheckpointer, checkpoint_queue_blocks

        self._loop = asyncio.get_running_loop()
        if self.drt.discovery is None:
            return
        self._sub = await self.drt.discovery.subscribe(self.topic)
        self._task = asyncio.create_task(self._mirror_loop())
        # periodic retraction drain: a worker that mostly SERVES pulls
        # cascades drops with no connector involvement
        self._drain_task = asyncio.create_task(self._drain_evictions_loop())
        self._addr_watch = await self.drt.discovery.watch_prefix(DATA_PLANE_ROOT)
        for item in self._addr_watch.snapshot:
            self._on_addr(item["key"], item["value"])
        self._addr_task = asyncio.create_task(self._addr_loop(self._addr_watch))
        ckpt_blocks = checkpoint_queue_blocks()
        if ckpt_blocks > 0:
            self.checkpointer = KvCheckpointer(self, ckpt_blocks)
            self._ckpt_task = asyncio.create_task(self.checkpointer.run())
        # announcements are fire-and-forget: a late joiner asks everyone to
        # re-announce (peers reply with their full hash sets)
        self.announce("sync_request", [])

    def _on_addr(self, key: str, raw: Optional[bytes]):
        inst = int(key.rsplit("/", 1)[-1], 16)
        if raw is None:
            self._addrs.pop(inst, None)
            self._ckpt_ineligible.discard(inst)
            self._drop_owner(inst, None)
            return
        try:
            self._addrs[inst] = json.loads(raw)["addr"]
        except (ValueError, KeyError, TypeError):
            logger.warning("bad data plane advertisement %s", key)

    async def _addr_loop(self, watch):
        async for event in watch:
            self._on_addr(event.key, event.value if event.type == "put" else None)

    async def _drain_evictions_loop(self):
        while True:
            await asyncio.sleep(2.0)
            evicted = self.manager.drain_evicted()
            if evicted:
                self.announce("evicted", evicted)

    async def _mirror_loop(self):
        from ..runtime import codec

        async for payload in self._sub:
            try:
                msg = codec.unpack(payload)
                inst = int(msg["worker"])
                if inst == self.instance_id:
                    continue
                self._dead.pop(inst, None)  # a live announcement lifts quarantine
                op = msg["op"]
                if op in ("stored", "checkpoint"):
                    for h in msg["hashes"]:
                        self._owners.setdefault(int(h), set()).add(inst)
                    if op == "checkpoint":
                        for h in msg["hashes"]:
                            self._tag_checkpoint(int(h))
                elif op == "evicted":
                    self._drop_owner(inst, msg["hashes"])
                elif op == "cleared":
                    self._drop_owner(inst, None)
                elif op == "sync":
                    # full-set re-announcement: REPLACE the peer's owner set
                    # (a union would resurrect hashes it evicted since)
                    self._drop_owner(inst, None)
                    for h in msg["hashes"]:
                        self._owners.setdefault(int(h), set()).add(inst)
                elif op == "sync_request":
                    self._answer_sync()
            except Exception:  # noqa: BLE001 — one bad announcement must not stop the mirror
                logger.exception("bad kvbm announcement")

    def _answer_sync(self):
        all_hashes = [int(h) for h in self.manager.all_hashes()]
        self.announce("sync", all_hashes)
        ck = [h for h in all_hashes if h in self._ckpt_hashes]
        if ck:
            self.announce("checkpoint", ck)

    def _drop_owner(self, inst: int, hashes: Optional[Sequence[int]]):
        """Remove `inst` as owner of `hashes` (None = everywhere)."""
        keys = [int(h) for h in hashes] if hashes is not None else list(self._owners)
        for h in keys:
            owners = self._owners.get(h)
            if owners is None:
                continue
            owners.discard(inst)
            if not owners:
                del self._owners[h]

    def announce_threadsafe(self, op: str, hashes: Sequence[int]):
        """Schedule an announcement from any thread (the tier thread)."""
        if self._loop is not None and not self._loop.is_closed():
            self._loop.call_soon_threadsafe(self.announce, op, list(hashes))

    def announce(self, op: str, hashes: Sequence[int]):
        """Fire-and-forget announcement of our tier contents."""
        from ..runtime import codec

        if self.drt.discovery is None:
            return

        async def _pub():
            try:
                await self.drt.discovery.publish(self.topic, codec.pack(
                    {"worker": self.instance_id, "op": op,
                     "hashes": [int(h) for h in hashes]}))
            except Exception:  # noqa: BLE001 — announcements are best-effort
                logger.debug("kvbm announce failed", exc_info=True)

        t = asyncio.get_running_loop().create_task(_pub())
        self._bg.add(t)
        t.add_done_callback(self._bg.discard)

    # -- quarantine + checkpoint tags ------------------------------------ #

    def note_peer_failure(self, inst: int, ttl_s: float = 30.0):
        """A pull from this peer failed: skip it until the deadline."""
        self._dead[int(inst)] = time.monotonic() + ttl_s

    def note_checkpoint_ineligible(self, inst: int):
        """This peer refused a checkpoint push for a structural reason: skip
        it as a checkpoint target while it advertises this instance id (a
        TTL quarantine would re-pick it at every expiry). Its pull roles
        are untouched."""
        if len(self._ckpt_ineligible) >= 1024:
            self._ckpt_ineligible.pop()
        self._ckpt_ineligible.add(int(inst))

    def _quarantined(self, inst: int) -> bool:
        dl = self._dead.get(int(inst))
        if dl is None:
            return False
        if time.monotonic() >= dl:
            del self._dead[int(inst)]
            return False
        return True

    def _tag_checkpoint(self, h: int):
        if len(self._ckpt_hashes) >= 65536:
            for _ in range(32768):
                self._ckpt_hashes.pop()
        self._ckpt_hashes.add(int(h))

    def note_checkpoint_received(self, hashes: Sequence[int]):
        for h in hashes:
            self._tag_checkpoint(int(h))
        self.announce("checkpoint", list(hashes))

    def any_checkpoint(self, hashes: Sequence[int]) -> bool:
        return any(int(h) in self._ckpt_hashes for h in hashes)

    def checkpoint_peer(self) -> Optional[Tuple[int, str]]:
        """The replication target: the ring successor, i.e. the first live,
        non-quarantined, eligible peer with a data plane whose id follows
        this worker's (wrapping). Stable, so one session's blocks land on
        one peer; per-worker distinct, so a fleet's replication spreads."""
        me = self.instance_id
        ring = sorted(self._addrs)
        for inst in [i for i in ring if i > me] + [i for i in ring if i < me]:
            if self._quarantined(inst) or inst in self._ckpt_ineligible:
                continue
            addr = self._addrs.get(inst)
            if addr:
                return inst, addr
        return None

    # -- probe / pull (G4) ----------------------------------------------- #

    def remote_owner(self, h: int, hint_instance: Optional[int] = None
                     ) -> Optional[Tuple[int, str]]:
        """First live announced owner; the router's holder hint when the
        mesh has not mirrored the hash. Quarantined peers are skipped."""
        for inst in self._owners.get(int(h), ()):
            if self._quarantined(inst):
                continue
            addr = self._addrs.get(inst)
            if addr:
                return inst, addr
        if hint_instance is not None and not self._quarantined(int(hint_instance)):
            addr = self._addrs.get(int(hint_instance))
            if addr:
                return int(hint_instance), addr
        return None

    def extend_prefix(self, hashes: Sequence[int], hint_instance: Optional[int] = None,
                      hint_blocks: int = 0) -> List[int]:
        """Longest leading run of `hashes` available remotely."""
        out: List[int] = []
        for i, h in enumerate(hashes):
            hint = hint_instance if i < hint_blocks else None
            if self.remote_owner(h, hint_instance=hint) is None:
                break
            out.append(int(h))
        return out

    def estimate_pull_ms(self, hashes: Sequence[int], hint_instance: Optional[int] = None
                         ) -> Optional[float]:
        """Projected pull time: the max over peers (they pull concurrently)
        of each peer's span at its EWMA. None when a peer is cold or a hash
        has no reachable owner."""
        per_peer: Dict[str, float] = {}
        for h in hashes:
            owner = self.remote_owner(h, hint_instance=hint_instance)
            if owner is None:
                return None
            ms = self._pull_ms_per_block.get(owner[1])
            if ms is None:
                return None
            per_peer[owner[1]] = per_peer.get(owner[1], 0.0) + ms
        return max(per_peer.values(), default=0.0)

    async def pull_blocks(self, hashes: Sequence[int], hint_instance: Optional[int] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fetch blocks from peers (`[n, *block_shape]`), grouped by owner
        and pulled concurrently. Raises KeyError when a block has no
        reachable owner and KvTransferError when a peer fails mid-pull."""
        from ..llm.kv_transfer import pull_kvbm_blocks

        plan: Dict[str, List[int]] = {}
        addr_inst: Dict[str, int] = {}
        for h in hashes:
            owner = self.remote_owner(h, hint_instance=hint_instance)
            if owner is None:
                raise KeyError(f"kvbm block {h} has no remote owner")
            plan.setdefault(owner[1], []).append(int(h))
            addr_inst[owner[1]] = owner[0]
        t0 = time.perf_counter()
        parts: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}

        async def pull_one(addr: str, hs: List[int]):
            t_peer = time.perf_counter()
            try:
                k, v = await pull_kvbm_blocks(
                    addr, hs, self.manager.block_shape, self.manager.dtype,
                    kv_format=self.manager.kv_format, connect_timeout=2.0)
            except (KeyError, asyncio.CancelledError):
                raise  # a block miss / teardown: the peer itself is fine
            except BaseException:
                self.note_peer_failure(addr_inst.get(addr, -1))
                raise
            per_block = (time.perf_counter() - t_peer) * 1000.0 / max(len(hs), 1)
            prev = self._pull_ms_per_block.get(addr)
            self._pull_ms_per_block[addr] = (
                per_block if prev is None else 0.8 * prev + 0.2 * per_block)
            for i, h in enumerate(hs):
                parts[h] = (k[i], v[i])
            self.remote_blocks_pulled += len(hs)
            self.remote_bytes_pulled += int(k.nbytes) + int(v.nbytes)

        tasks = [asyncio.create_task(pull_one(addr, hs)) for addr, hs in plan.items()]

        async def _reap_siblings():
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)

        try:
            await asyncio.gather(*tasks)
        except asyncio.CancelledError:
            await asyncio.shield(_reap_siblings())
            raise
        except BaseException:
            await asyncio.shield(_reap_siblings())
            self.remote_pull_failures += 1
            raise
        self.remote_onboards += 1
        total_ms = (time.perf_counter() - t0) * 1000.0
        self._pull_ms_sum += total_ms
        for i, b in enumerate(self._pull_hist_bounds):
            if total_ms <= b:
                self._pull_hist[i] += 1
                break
        else:
            self._pull_hist[-1] += 1
        return (torch.stack([parts[int(h)][0] for h in hashes]),
                torch.stack([parts[int(h)][1] for h in hashes]))

    def stats(self) -> dict:
        out = {
            "kvbm_remote_onboards": self.remote_onboards,
            "kvbm_remote_blocks_pulled": self.remote_blocks_pulled,
            "kvbm_peer_bytes_pulled": self.remote_bytes_pulled,
            "kvbm_peer_pull_failures": self.remote_pull_failures,
            "kvbm_peer_pull_ms_sum": round(self._pull_ms_sum, 3),
            "kvbm_peer_pull_hist": {
                **{f"le_{b:g}ms": n for b, n in zip(self._pull_hist_bounds, self._pull_hist)},
                "inf": self._pull_hist[-1],
            },
            "kvbm_known_remote_blocks": sum(1 for owners in self._owners.values() if owners),
            "kvbm_quarantined_peers": sum(1 for i in list(self._dead) if self._quarantined(i)),
            "kvbm_known_checkpoint_blocks": len(self._ckpt_hashes),
            "kvbm_ckpt_ineligible_peers": len(self._ckpt_ineligible),
        }
        if self.checkpointer is not None:
            out.update(self.checkpointer.stats())
        for addr, ms in self._pull_ms_per_block.items():
            out.setdefault("kvbm_peer_ms_per_block", {})[addr] = round(ms, 3)
        return out

    async def close(self):
        for t in list(self._bg):
            t.cancel()
        if self.checkpointer is not None:
            self.checkpointer.close()
        tasks = [t for t in (self._task, self._addr_task, self._drain_task, self._ckpt_task)
                 if t is not None]
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, *self._bg, return_exceptions=True)
        if self._sub is not None:
            await self._sub.cancel()
        if self._addr_watch is not None:
            await self._addr_watch.cancel()
