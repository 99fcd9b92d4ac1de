"""KV-aware worker selection.

Port of `dynamo_tpu/llm/kv_router/scheduler.py`, unchanged: the same cost
and the same draws from the `random` module, so a seeded run picks the
same workers.

Mirrors reference lib/llm/src/kv_router/scheduler.rs: cost =
`overlap_weight * potential_prefill_blocks + potential_decode_blocks`
(:505-538) and softmax/temperature sampling over negated costs
(softmax_sample :389). "Potential" blocks include sequences this router has
scheduled but the worker hasn't reported yet (reference sequence.rs
ActiveSequences), so rapid-fire requests don't all pile onto one worker.
"""

from __future__ import annotations

import logging
import math
import random
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ...runtime.metrics import KV_ACTIVE_BLOCKS, KV_TOTAL_BLOCKS, NUM_WAITING_REQS

logger = logging.getLogger(__name__)


@dataclass
class KvRouterConfig:
    """Reference KvRouterConfig kv_router.rs:85."""

    overlap_score_weight: float = 1.0
    router_temperature: float = 0.0
    use_kv_events: bool = True  # False -> ApproxKvIndexer
    replica_sync: bool = False
    block_size: int = 64
    # mirrored replica-sync entries have no local stream whose end frees
    # them — if the publishing frontend dies (or its best-effort 'free' is
    # dropped) they would skew active-block scoring forever; prune at a
    # max-request-lifetime TTL instead
    sync_entry_ttl_s: float = 600.0
    # event mode only: assume a routed prefix is cached on its worker for
    # this long, so same-prefix requests arriving BEFORE the engine's KV
    # events co-locate instead of spreading (0 disables the overlay)
    inflight_prefix_ttl_s: float = 30.0


@dataclass
class _ActiveSeq:
    worker_id: int
    blocks: int
    started: float = field(default_factory=time.monotonic)
    mirrored: bool = False  # came from replica sync, not a local stream


@dataclass
class WorkerLoad:
    """Last reported engine stats (ForwardPassMetrics role)."""

    kv_active_blocks: int = 0
    kv_total_blocks: int = 1
    num_waiting_reqs: int = 0
    updated: float = 0.0


def softmax_sample(costs: Dict[int, float], temperature: float) -> int:
    """Sample a worker by softmax over negated costs; temperature 0 =
    argmin with random tie-break (reference softmax_sample scheduler.rs:389)."""
    if not costs:
        raise ValueError("no workers to sample")
    if temperature <= 0.0:
        best = min(costs.values())
        candidates = [w for w, c in costs.items() if c == best]
        return random.choice(candidates)
    # normalize for stability
    vals = list(costs.values())
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    logits = {w: -((c - lo) / span) / temperature for w, c in costs.items()}
    mx = max(logits.values())
    exps = {w: math.exp(v - mx) for w, v in logits.items()}
    total = sum(exps.values())
    r = random.random() * total
    acc = 0.0
    for w, e in exps.items():
        acc += e
        if r <= acc:
            return w
    return w  # numerical tail


class KvScheduler:
    """Pick the best worker for a request (reference KvScheduler
    scheduler.rs:297)."""

    def __init__(self, config: Optional[KvRouterConfig] = None):
        self.config = config or KvRouterConfig()
        self.loads: Dict[int, WorkerLoad] = {}
        self._active: Dict[str, _ActiveSeq] = {}  # request_id -> seq
        self._potential_blocks: Dict[int, int] = {}  # worker -> unreported blocks

    # -- state updates ------------------------------------------------------ #

    def update_load(self, worker_id: int, stats: dict):
        load = self.loads.setdefault(worker_id, WorkerLoad())
        load.kv_active_blocks = int(stats.get(KV_ACTIVE_BLOCKS, 0))
        load.kv_total_blocks = max(int(stats.get(KV_TOTAL_BLOCKS, 1)), 1)
        load.num_waiting_reqs = int(stats.get(NUM_WAITING_REQS, 0))
        load.updated = time.monotonic()

    def add_request(
        self, request_id: str, worker_id: int, blocks: int, mirrored: bool = False
    ):
        # re-adding an id (e.g. duplicate sync delivery) must not leak the
        # old entry's potential blocks
        if request_id in self._active:
            self.mark_free(request_id)
        self._active[request_id] = _ActiveSeq(worker_id, blocks, mirrored=mirrored)
        self._potential_blocks[worker_id] = (
            self._potential_blocks.get(worker_id, 0) + blocks
        )

    def mark_free(self, request_id: str):
        seq = self._active.pop(request_id, None)
        if seq is not None:
            w = seq.worker_id
            self._potential_blocks[w] = max(
                0, self._potential_blocks.get(w, 0) - seq.blocks
            )

    def prune_mirrored(self, now: Optional[float] = None) -> int:
        """Drop mirrored entries older than sync_entry_ttl_s (reference
        subscriber.rs keeps replicas converged via resync; here sync is
        best-effort pub/sub, so staleness is bounded by TTL instead).
        Returns how many entries were pruned."""
        now = time.monotonic() if now is None else now
        ttl = self.config.sync_entry_ttl_s
        stale = [
            rid for rid, s in self._active.items()
            if s.mirrored and now - s.started > ttl
        ]
        for rid in stale:
            self.mark_free(rid)
        return len(stale)

    def remove_worker(self, worker_id: int):
        self.loads.pop(worker_id, None)
        self._potential_blocks.pop(worker_id, None)
        for rid in [r for r, s in self._active.items() if s.worker_id == worker_id]:
            self._active.pop(rid, None)

    # -- the decision ------------------------------------------------------- #

    def schedule(
        self,
        request_blocks: int,
        overlap_scores: Dict[int, int],
        live_workers: List[int],
    ) -> int:
        """Reference cost function scheduler.rs:505-538."""
        if not live_workers:
            raise RuntimeError("no live workers")
        costs: Dict[int, float] = {}
        for w in live_workers:
            overlap = overlap_scores.get(w, 0)
            potential_prefill = max(request_blocks - overlap, 0)
            load = self.loads.get(w)
            decode_blocks = (load.kv_active_blocks if load else 0) + self._potential_blocks.get(w, 0)
            costs[w] = (
                self.config.overlap_score_weight * potential_prefill + decode_blocks
            )
        choice = softmax_sample(costs, self.config.router_temperature)
        logger.debug(
            "kv schedule: blocks=%d overlaps=%s costs=%s -> %x",
            request_blocks,
            overlap_scores,
            costs,
            choice,
        )
        return choice
