"""dynogate: admission control, per-tenant fairness, and load shedding.

Port of `dynamo_tpu/gate/gate.py`, unchanged.

The overload discipline the frontend applies BEFORE tokenizing
(docs/overload.md; ROADMAP item 4 / FlexNPU & Nexus degraded-mode
framing): offered load past capacity is refused with HTTP 429 +
`Retry-After` instead of collapsing into convoy timeouts, one noisy
tenant cannot starve the rest, and when admitted load still passes
capacity the LOWEST SLA class sheds first — cleanly, from the gate
queue, never mid-stream.

Decision flow per request (``admit``):

  1. dynochaos `gate.admit` fault point (`reject` forces a 429).
  2. Per-tenant token bucket (`DYN_GATE_TENANT_RATE`): a tenant past its
     rate is told exactly when its bucket refills.
  3. Load check against the worker-published signals (signals.py): when
     the best ready instance's projected TTFT fits the request's SLA
     class headroom (class = nvext.priority, each +1 halves the target —
     the SlaConfig math), the request is admitted. Unknown signals admit.
  4. Otherwise the request waits in a weighted-fair queue (WFQ virtual
     time per tenant) for capacity, bounded by
     min(DYN_GATE_MAX_WAIT_MS, class headroom); the pump re-evaluates as
     signals refresh. Past the bound — or past DYN_GATE_MAX_QUEUE — it
     is SHED: lowest class first, newest first within a class.

All queue/virtual-time state is confined to the single `_pump` task
(GUARDED_STATE); `admit` only appends to an inbox queue and awaits its
entry's future, so admission decisions are serialized and untorn.
"""

from __future__ import annotations

import asyncio
import logging
import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..runtime import faults
from ..runtime.metrics import metric_spec
from .config import GateConfig
from .fairness import TokenBucket, WfqQueue
from .signals import LoadSignals

logger = logging.getLogger(__name__)

#: cap on any Retry-After the gate hands out (s): past this the estimate
#: is noise, and well-behaved clients should re-probe anyway
RETRY_AFTER_CAP_S = 30.0

#: cardinality bound on per-tenant accounting: the tenant key is a
#: client-controlled header, so without a cap a unique-tenant flood grows
#: counters/buckets/metric output without bound — the overflow tenant
#: absorbs everything past it
MAX_TRACKED_TENANTS = 1024
OVERFLOW_TENANT = "~other"


def _prom_label(value: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline): the
    tenant label is raw client input and must not be able to corrupt the
    /metrics exposition."""
    return (value.replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


@dataclass
class GateDecision:
    """The admission verdict the HTTP layer turns into 200-path or 429."""

    admitted: bool
    reason: str = "admitted"  # rate-limited | overloaded | shed | fault
    retry_after_s: float = 0.0
    projected_ttft_ms: Optional[float] = None
    queued_ms: float = 0.0


@dataclass
class _Pending:
    """Inbox payload: one request awaiting a pump decision."""

    model: str
    tenant: str
    priority: int
    enq_s: float
    counted: bool = False  # already counted in gate_parked_total
    fut: asyncio.Future = field(
        default_factory=lambda: asyncio.get_running_loop().create_future()
    )


class AdmissionGate:
    """One per frontend process. ``start()`` spawns the pump; models are
    registered by the ModelWatcher via ``track_model``."""

    def __init__(self, drt, config: Optional[GateConfig] = None):
        self.config = config or GateConfig.from_env()
        self.signals = LoadSignals(drt, self.config)
        self._inbox: asyncio.Queue = asyncio.Queue()
        self._waiting = WfqQueue(weight_of=self.config.weight)
        self._buckets: Dict[str, TokenBucket] = {}
        self._pump_task: Optional[asyncio.Task] = None
        self._closed = False
        # optimism debt: admissions since the model's last signal refresh
        # (each one pushes the true projected TTFT past the published
        # number until the next 0.25s publish lands)
        self._debt: Dict[str, int] = {}
        self._debt_seen: Dict[str, float] = {}
        # counters (monotonic; stats() + the frontend /metrics surface)
        self.admitted_total = 0
        self.rejected_total = 0
        self.shed_total = 0
        self.queued_total = 0
        self.rejected_by_reason: Dict[str, int] = {}
        self.per_tenant: Dict[str, Dict[str, int]] = {}
        self.retry_after_hist: Dict[str, int] = {
            "le_1s": 0, "le_2s": 0, "le_5s": 0, "le_10s": 0, "inf": 0,
        }

    # -- lifecycle -------------------------------------------------------- #

    async def start(self) -> "AdmissionGate":
        if self._pump_task is None:
            self._pump_task = asyncio.create_task(self._pump())
        return self

    async def close(self) -> None:
        self._closed = True
        if self._pump_task is not None:
            self._pump_task.cancel()
            self._pump_task = None
        # a shutdown must not 429 requests that were admissible: resolve
        # every parked entry as admitted and let the drain path finish them
        for entry in self._waiting.drain():
            pend: _Pending = entry.payload
            if not pend.fut.done():
                pend.fut.set_result(GateDecision(admitted=True))
        while not self._inbox.empty():
            pend = self._inbox.get_nowait()
            if not pend.fut.done():
                pend.fut.set_result(GateDecision(admitted=True))
        await self.signals.close()

    async def track_model(self, model: str, namespace: str, component: str,
                          client) -> None:
        await self.signals.track(model, namespace, component, client)

    async def untrack_model(self, model: str) -> None:
        await self.signals.untrack(model)

    # -- admission -------------------------------------------------------- #

    async def admit(self, model: str, tenant: str = "",
                    priority: int = 0) -> GateDecision:
        """The edge decision, taken BEFORE tokenization. Returns quickly
        on the uncontended path; under pressure the caller is parked in
        the WFQ until capacity frees or the shed bound hits."""
        if not self.config.enabled or self._closed:
            return GateDecision(admitted=True)
        tenant = tenant or "default"
        priority = max(min(int(priority or 0), 8), -8)

        f = faults.FAULTS
        if f.enabled and f.check("gate.admit") == "reject":
            return self._reject(model, tenant, "fault",
                                self.config.retry_after_floor_s)

        # token bucket: per-tenant rate limit, checked synchronously so
        # the deny and its Retry-After are deterministic per (clock, plan)
        if self.config.tenant_rate > 0:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                burst = self.config.tenant_burst or max(
                    2.0 * self.config.tenant_rate, 1.0
                )
                if len(self._buckets) >= MAX_TRACKED_TENANTS:
                    # drop buckets that have fully refilled (identical to
                    # a fresh tenant's) before folding into the overflow
                    # bucket — the header is client-controlled, the table
                    # must not be
                    for t, b in list(self._buckets.items()):
                        if b.wait_s(b.burst) <= 0:
                            del self._buckets[t]
                if len(self._buckets) >= MAX_TRACKED_TENANTS:
                    bucket = self._buckets.setdefault(
                        OVERFLOW_TENANT,
                        TokenBucket(self.config.tenant_rate, burst),
                    )
                else:
                    bucket = self._buckets.setdefault(
                        tenant, TokenBucket(self.config.tenant_rate, burst)
                    )
            if not bucket.try_take():
                return self._reject(
                    model, tenant, "rate-limited",
                    max(bucket.wait_s(), self.config.retry_after_floor_s),
                )

        # every load decision runs on the pump task (one event-loop hop):
        # the WFQ, virtual time and optimism debt stay single-task-
        # confined, so concurrent admissions cannot tear each other
        pend = _Pending(model=model, tenant=tenant, priority=priority,
                        enq_s=time.monotonic())
        self._inbox.put_nowait(pend)
        return await pend.fut

    # -- pump (single task: owns every queue/vtime/debt mutation) --------- #

    async def _pump(self) -> None:
        while True:
            try:
                pend = await asyncio.wait_for(self._inbox.get(), timeout=0.05)
            except asyncio.TimeoutError:
                pend = None
            now = time.monotonic()
            # drain the inbox into the WFQ (virtual finish times assigned
            # in arrival order)
            while pend is not None:
                deadline = pend.enq_s + min(
                    self.config.max_wait_ms,
                    self.config.class_headroom_ms(pend.priority),
                ) / 1000.0
                self._waiting.push(pend.tenant, pend.priority, pend.enq_s,
                                   deadline, payload=pend)
                try:
                    pend = self._inbox.get_nowait()
                except asyncio.QueueEmpty:
                    pend = None

            # shed pass FIRST: entries past their wait bound are hopeless
            # (serving them now would still blow their class SLA)
            for entry in self._waiting.expired(now):
                self._resolve_shed(entry, "shed-timeout")
            while self.config.max_queue and len(self._waiting) > self.config.max_queue:
                victim = self._waiting.shed_lowest()
                if victim is None:
                    break
                self._resolve_shed(victim, "shed-overflow")

            # admit pass: WFQ virtual-finish order; each entry is checked
            # against ITS class headroom, so a lenient class behind a
            # blocked tight one still drains. `scan_debt` charges each
            # admission WITHIN this scan before the next entry is judged
            # — without it one cycle's whole backlog slips under a single
            # projection reading (the burst over-admission hole).
            scan_debt: Dict[str, int] = {}

            def _fits(entry) -> bool:
                pend: _Pending = entry.payload
                if pend.fut.done():  # caller gave up (disconnect)
                    return True
                proj = self._projected(pend.model)
                if proj is not None and scan_debt.get(pend.model):
                    proj += scan_debt[pend.model] * \
                        self.signals.per_request_ms(pend.model)
                ok = proj is None or \
                    proj <= self.config.class_headroom_ms(pend.priority)
                if ok:
                    scan_debt[pend.model] = scan_debt.get(pend.model, 0) + 1
                return ok

            for entry in self._waiting.take(_fits):
                pend = entry.payload
                if pend.fut.done():
                    continue
                proj = self._projected(pend.model)
                decision = self._admit(
                    pend.model, pend.tenant, proj,
                    queued_ms=(time.monotonic() - pend.enq_s) * 1000.0,
                )
                pend.fut.set_result(decision)

            # whatever is left had to PARK for capacity (the overload
            # signal the stats surface reports as gate_parked_total)
            for entry in self._waiting.entries():
                pend = entry.payload
                if not pend.counted:
                    pend.counted = True
                    self.queued_total += 1

    def _resolve_shed(self, entry, reason: str) -> None:
        pend: _Pending = entry.payload
        if pend.fut.done():
            return
        self.shed_total += 1
        proj = self._projected(pend.model)
        retry = self._retry_after(proj, pend.priority)
        pend.fut.set_result(GateDecision(
            admitted=False, reason=reason, retry_after_s=retry,
            projected_ttft_ms=proj,
            queued_ms=(time.monotonic() - pend.enq_s) * 1000.0,
        ))
        self._count_reject(pend.tenant, reason, retry)

    # -- internals -------------------------------------------------------- #

    def _projected(self, model: str) -> Optional[float]:
        """Published projection plus the optimism debt of admissions the
        publisher has not seen yet; debt resets when a fresher sample
        lands."""
        proj = self.signals.projected_ttft_ms(model)
        if proj is None:
            return None
        last = self.signals.last_update(model)
        if last > self._debt_seen.get(model, 0.0):
            self._debt_seen[model] = last
            self._debt[model] = 0
        debt = self._debt.get(model, 0)
        if debt:
            proj += debt * self.signals.per_request_ms(model)
        return proj

    def _retry_after(self, proj: Optional[float], priority: int) -> float:
        """How long until this class plausibly fits: the projection's
        excess over the class headroom, floored and capped."""
        headroom = self.config.class_headroom_ms(priority)
        excess_s = ((proj or 0.0) - headroom) / 1000.0
        return min(max(excess_s, self.config.retry_after_floor_s),
                   RETRY_AFTER_CAP_S)

    def _tenant_counts(self, tenant: str) -> Dict[str, int]:
        """Per-tenant counter row, folding past the cardinality bound
        (the tenant key is client-controlled input)."""
        t = self.per_tenant.get(tenant)
        if t is None:
            if len(self.per_tenant) >= MAX_TRACKED_TENANTS:
                tenant = OVERFLOW_TENANT
            t = self.per_tenant.setdefault(
                tenant, {"admitted": 0, "rejected": 0})
        return t

    def _admit(self, model: str, tenant: str, proj: Optional[float],
               queued_ms: float = 0.0) -> GateDecision:
        self.admitted_total += 1
        self._debt[model] = self._debt.get(model, 0) + 1
        self._tenant_counts(tenant)["admitted"] += 1
        return GateDecision(admitted=True, projected_ttft_ms=proj,
                            queued_ms=queued_ms)

    def _reject(self, model: str, tenant: str, reason: str,
                retry_after_s: float) -> GateDecision:
        retry = min(max(retry_after_s, self.config.retry_after_floor_s),
                    RETRY_AFTER_CAP_S)
        self._count_reject(tenant, reason, retry)
        return GateDecision(
            admitted=False, reason=reason, retry_after_s=retry,
            projected_ttft_ms=self.signals.projected_ttft_ms(model),
        )

    def _count_reject(self, tenant: str, reason: str, retry: float) -> None:
        self.rejected_total += 1
        self.rejected_by_reason[reason] = \
            self.rejected_by_reason.get(reason, 0) + 1
        self._tenant_counts(tenant)["rejected"] += 1
        for bound, key in ((1, "le_1s"), (2, "le_2s"), (5, "le_5s"),
                           (10, "le_10s")):
            if retry <= bound:
                self.retry_after_hist[key] += 1
                break
        else:
            self.retry_after_hist["inf"] += 1

    # -- observability ---------------------------------------------------- #

    def stats(self) -> dict:
        out = {
            "gate_enabled": int(self.config.enabled),
            "gate_admitted_total": self.admitted_total,
            "gate_rejected_total": self.rejected_total,
            "gate_shed_total": self.shed_total,
            "gate_parked_total": self.queued_total,
            "gate_queue_depth": len(self._waiting),
            "gate_rejected_by_reason": dict(self.rejected_by_reason),
            "gate_retry_after_hist": dict(self.retry_after_hist),
            "gate_per_tenant": {
                t: dict(v) for t, v in self.per_tenant.items()
            },
        }
        out.update(self.signals.stats())
        return out

    def render_prometheus(self) -> bytes:
        """Prometheus text lines appended to the frontend /metrics render
        (hand-assembled: the counters live on this object so the soak and
        unit tests can read them without a registry scrape)."""
        ns = "dynamo_frontend_gate"

        def _help(name: str) -> str:
            # HELP text comes from the metrics contract registry, so the
            # exposition can never drift from docs/observability.md
            return (metric_spec(name) or {}).get("help", name)

        lines = [
            f"# HELP {ns}_admitted_total {_help(ns + '_admitted_total')}",
            f"# TYPE {ns}_admitted_total counter",
            f"{ns}_admitted_total {self.admitted_total}",
            f"# HELP {ns}_rejected_total {_help(ns + '_rejected_total')}",
            f"# TYPE {ns}_rejected_total counter",
            f"{ns}_rejected_total {self.rejected_total}",
            f"# HELP {ns}_shed_total {_help(ns + '_shed_total')}",
            f"# TYPE {ns}_shed_total counter",
            f"{ns}_shed_total {self.shed_total}",
            f"# HELP {ns}_queue_depth {_help(ns + '_queue_depth')}",
            f"# TYPE {ns}_queue_depth gauge",
            f"{ns}_queue_depth {len(self._waiting)}",
        ]
        if self.rejected_by_reason:
            lines.append(
                f"# HELP {ns}_rejected_by_reason_total "
                f"{_help(ns + '_rejected_by_reason_total')}"
            )
            lines.append(f"# TYPE {ns}_rejected_by_reason_total counter")
        for reason, n in sorted(self.rejected_by_reason.items()):
            # reason strings are produced by the gate itself, but escape
            # anyway: a label value must never break the exposition line
            lines.append(
                f'{ns}_rejected_by_reason_total'
                f'{{reason="{_prom_label(reason)}"}} {n}'
            )
        if self.per_tenant:
            lines.append(
                f"# HELP {ns}_tenant_requests_total "
                f"{_help(ns + '_tenant_requests_total')}"
            )
            lines.append(f"# TYPE {ns}_tenant_requests_total counter")
        for tenant, v in sorted(self.per_tenant.items()):
            for k in ("admitted", "rejected"):
                lines.append(
                    f'{ns}_tenant_requests_total'
                    f'{{tenant="{_prom_label(tenant)}",'
                    f'outcome="{_prom_label(k)}"}} {v[k]}'
                )
        lines.append(
            f"# HELP {ns}_retry_after_seconds "
            f"{_help(ns + '_retry_after_seconds')}"
        )
        lines.append(f"# TYPE {ns}_retry_after_seconds histogram")
        acc = 0
        for key in ("le_1s", "le_2s", "le_5s", "le_10s", "inf"):
            acc += self.retry_after_hist[key]
            le = key[3:].rstrip("s") if key != "inf" else "+Inf"
            lines.append(
                f'{ns}_retry_after_seconds_bucket'
                f'{{le="{_prom_label(le)}"}} {acc}'
            )
        lines.append(f"{ns}_retry_after_seconds_count {acc}")
        return ("\n".join(lines) + "\n").encode()


def retry_after_header(retry_after_s: float) -> str:
    """Retry-After is delta-seconds, integral, never 0 (RFC 9110 §10.2.3)."""
    return str(max(int(math.ceil(retry_after_s)), 1))
