"""Per-tenant fairness primitives: token buckets and weighted fair queuing.

Port of `dynamo_tpu/gate/fairness.py`, unchanged.

Both are pure, clock-injectable data structures (deterministic under a
fake clock — tests/test_gate.py drives them with one) consumed by
`gate.AdmissionGate`; neither holds asyncio state.
"""

from __future__ import annotations

import heapq
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


class TokenBucket:
    """Classic token bucket: `rate` tokens/s refill, `burst` capacity.

    Refill is computed lazily from elapsed time (no timer task), so for a
    fixed clock sequence the admit/deny decisions are exactly
    reproducible — the determinism the gate's rate-limit tests pin."""

    def __init__(self, rate: float, burst: float,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = max(float(burst), 1.0)
        self._clock = clock
        self._tokens = self.burst  # start full: a new tenant gets its burst
        self._last = clock()

    def _refill(self, now: float) -> None:
        if now > self._last:
            self._tokens = min(
                self.burst, self._tokens + (now - self._last) * self.rate
            )
        self._last = max(self._last, now)

    def try_take(self, n: float = 1.0) -> bool:
        self._refill(self._clock())
        if self._tokens >= n:
            self._tokens -= n
            return True
        return False

    def wait_s(self, n: float = 1.0) -> float:
        """Seconds until `n` tokens will be available (the Retry-After a
        rate-limited tenant is told)."""
        self._refill(self._clock())
        missing = n - self._tokens
        if missing <= 0:
            return 0.0
        if self.rate <= 0:
            return float("inf")
        return missing / self.rate


@dataclass(order=True)
class WfqEntry:
    """One queued admission, ordered by WFQ virtual finish time."""

    vft: float
    seq: int
    tenant: str = field(compare=False)
    priority: int = field(compare=False, default=0)
    enq_s: float = field(compare=False, default=0.0)
    deadline_s: float = field(compare=False, default=0.0)  # shed-by time
    payload: object = field(compare=False, default=None)


class WfqQueue:
    """Weighted fair queue over tenants (virtual-time WFQ).

    Each tenant's entries finish at `max(V, last_finish[tenant]) + 1/w`,
    so a tenant flooding the queue only advances its OWN finish times —
    other tenants' entries keep interleaving at their weight share no
    matter how deep the flood (the no-starvation property
    tests/test_gate.py pins under an adversarial mix).

    Shedding is by SLA class: `shed_lowest()` picks the lowest-priority
    entry (newest first within a class), the explicit overload contract —
    premium classes are the last to go (docs/overload.md)."""

    def __init__(self, weight_of: Optional[Callable[[str], float]] = None):
        self._weight_of = weight_of or (lambda _t: 1.0)
        self._heap: List[WfqEntry] = []
        self._vtime = 0.0
        self._finish: Dict[str, float] = {}
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._heap)

    def entries(self) -> List[WfqEntry]:
        """Snapshot of the queued entries (no order guarantee)."""
        return list(self._heap)

    def push(self, tenant: str, priority: int, enq_s: float,
             deadline_s: float, payload: object = None) -> WfqEntry:
        # finish tags at-or-behind the virtual clock are equivalent to a
        # fresh tenant's — prune them so the table stays bounded by the
        # tenants actually ahead of V, not by every tenant key ever seen
        # (the header is client-controlled)
        if len(self._finish) > 1024:
            self._finish = {
                t: f for t, f in self._finish.items() if f > self._vtime
            }
        w = max(self._weight_of(tenant), 1e-9)
        vft = max(self._vtime, self._finish.get(tenant, 0.0)) + 1.0 / w
        self._finish[tenant] = vft
        entry = WfqEntry(
            vft=vft, seq=next(self._seq), tenant=tenant, priority=priority,
            enq_s=enq_s, deadline_s=deadline_s, payload=payload,
        )
        heapq.heappush(self._heap, entry)
        return entry

    def peek(self) -> Optional[WfqEntry]:
        return self._heap[0] if self._heap else None

    def pop(self) -> WfqEntry:
        entry = heapq.heappop(self._heap)
        # virtual time advances to the served entry's finish tag; tenants
        # that were idle re-enter at V (they do not bank unused service)
        self._vtime = max(self._vtime, entry.vft)
        return entry

    def take(self, pred: Callable[[WfqEntry], bool]) -> List[WfqEntry]:
        """Remove and return, in virtual-finish order, every entry `pred`
        accepts. Entries `pred` refuses stay queued with their tags
        intact — a blocked tight-SLA entry does not dam lenient classes
        behind it (each is judged against its OWN headroom)."""
        admitted: List[WfqEntry] = []
        kept: List[WfqEntry] = []
        for entry in sorted(self._heap):
            if pred(entry):
                admitted.append(entry)
                self._vtime = max(self._vtime, entry.vft)
            else:
                kept.append(entry)
        if admitted:
            self._heap = kept
            heapq.heapify(self._heap)
        return admitted

    def _refund(self, entry: WfqEntry) -> None:
        """Roll the tenant's finish tag back one service quantum: a shed
        entry was never served, and leaving its charge in place would
        starve the tenant's LATER requests below its weight share as a
        consequence of requests that were refused."""
        f = self._finish.get(entry.tenant)
        if f is not None:
            w = max(self._weight_of(entry.tenant), 1e-9)
            self._finish[entry.tenant] = f - 1.0 / w

    def shed_lowest(self) -> Optional[WfqEntry]:
        """Remove and return the entry overload sheds first: lowest SLA
        class, newest arrival within the class."""
        if not self._heap:
            return None
        victim = min(self._heap, key=lambda e: (e.priority, -e.seq))
        self._heap.remove(victim)
        heapq.heapify(self._heap)
        self._refund(victim)
        return victim

    def expired(self, now_s: float) -> List[WfqEntry]:
        """Remove and return every entry whose shed deadline passed."""
        out = [e for e in self._heap if e.deadline_s <= now_s]
        if out:
            keep = [e for e in self._heap if e.deadline_s > now_s]
            self._heap = keep
            heapq.heapify(self._heap)
            for entry in out:
                self._refund(entry)
        return out

    def drain(self) -> List[WfqEntry]:
        out, self._heap = self._heap, []
        return out
