"""StepPlanner: per-step prefill admission, ordering, and chunk sizing.

Each `_step_once` the engine asks the planner three questions the step
loop used to hardcode:

  1. `order(cands)` — which prefill candidate goes first. fifo: admission
     order (the legacy `admit_seq` sort, bit-for-bit). sla: earliest TTFT
     deadline first, with a starvation guard (a candidate skipped
     `starve_dispatches` times jumps the deadline order).
  2. `pick_batch_kind(cands, kind_of)` — which dispatch-variant kind
     (plain/guided/mm/lora) this batch serves. The legacy rule (first
     non-plain in order) starves a kind when ordering keeps another kind
     perpetually first; the aging tiebreak forces a skipped kind through
     after `starve_dispatches` misses. Active under BOTH policies — it is
     a fairness fix, not a policy feature (it only changes behavior in
     mixed-kind traffic that would otherwise starve).
  3. `plan_prefill(cands, ...)` — the dispatch shape: bucket, lane count,
     and which slots ride it. fifo reproduces the legacy formula exactly
     (bucket from the head candidate's chunk, lanes 1-or-cap). sla scores
     every (bucket, lanes) in the engine's bounded compile-variant space
     by (slots served, real tokens granted, less padding) and spends an
     explicit ITL budget: with decode active and `itl_target_ms` set, the
     projected per-token ITL of "decode block + this prefill" must stay
     under target — shapes are shrunk to fit, and when nothing fits the
     dispatch defers (unless a TTFT deadline is already at risk, which
     wins: SLA attainment is the objective, not decode smoothness).

Costs come from the shared CostModel (EWMA per dispatch shape, fed by the
engine's `_timed` instrumentation). Planner bookkeeping (`_deadlines`,
`_records`) is step-loop-confined (GUARDED_STATE) and cleared by the
engine's fail-all path so a chaos-killed step leaves no orphaned deadline
state.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..bucketing import bucket_for, next_pow2 as _next_pow2
from .cost_model import CostModel
from .sla import SlaConfig


@dataclass
class PrefillPlan:
    """One prefill dispatch decision."""

    bucket: int
    lanes: int  # device lane count (1 or the bucket's cap)
    chosen: List  # slots riding this dispatch, in lane order
    reason: str  # "fifo" | "coverage" | "itl-shrunk" | "deadline-override"
    budget_s: Optional[float] = None  # ITL prefill budget (None = no cap)
    predicted_s: Optional[float] = None
    slack_ms: Optional[float] = None  # min deadline slack among chosen


@dataclass
class MixedPlan:
    """One unified mixed-step dispatch decision: which prefill chunks ride
    the flat ragged buffer beside the active decode lanes, and how big
    the buffer is (engine `_dispatch_mixed`)."""

    bucket: int  # flat token bucket (pow2, <= config.mixed_max_tokens)
    chosen: List  # prefill slots riding this dispatch, in row order
    chunks: List[int]  # granted chunk per chosen slot (1:1 with chosen)
    n_decode: int  # decode rows packed beside the chunks
    reason: str  # "mixed" | "mixed-shrunk"
    predicted_s: Optional[float] = None  # CostModel("mixed", ...) estimate
    deferred_slots: int = 0  # candidates that did not fit this dispatch
    # speculative draft rows (engine spec fusion): EXTRA one-token rows
    # beyond n_decode — each spec-eligible decode lane packs 1 + d rows
    # (current token + d drafts), so the budget must reserve them too
    n_spec_rows: int = 0


#: EDF deadline quantum (s) inside which the per-tenant fairness tiebreak
#: may reorder candidates — far below any meaningful TTFT target delta
_TENANT_TIE_QUANTUM_S = 0.1
#: per-tenant served-token counts halve when the max passes this bound
_TENANT_DECAY = 1 << 20
#: tenant-key cardinality bound (the key is a client-controlled header):
#: past it, the least-served half is evicted — evicted tenants simply
#: read as debt 0 again
_TENANT_MAX = 4096


@dataclass
class _Decision:
    """Per-step decision record (bounded history for stats/debugging)."""

    t: float
    reason: str
    bucket: int = 0
    lanes: int = 0
    granted_tokens: int = 0
    granted_slots: int = 0
    deferred_slots: int = 0
    budget_ms: Optional[float] = None
    slack_ms: Optional[float] = None


class StepPlanner:
    """Owns the per-step schedule. `config` is the EngineConfig (duck-typed:
    prefill_buckets, prefill_batch_tokens, max_prefill_batch,
    max_prefill_chunk, decode_block_steps, max_num_seqs)."""

    def __init__(self, config, sla: SlaConfig, cost: Optional[CostModel] = None):
        self.config = config
        self.sla = sla
        self.cost = cost or CostModel()
        self._deadlines: Dict[str, float] = {}  # request_id -> deadline (mono s)
        self._records: deque = deque(maxlen=64)
        # dynogate per-tenant fairness (docs/overload.md): granted prefill
        # tokens per tenant key. Within a ~100ms EDF deadline bucket the
        # LEAST-served tenant dispatches first, so a noisy tenant's flood
        # cannot monopolize same-class capacity; across buckets EDF still
        # rules (SLA attainment outranks fairness). Counts halve past
        # _TENANT_DECAY so the debt is recent-history, not all-time.
        self._tenant_served: Dict[str, int] = {}
        # counters (monotonic; surfaced via stats())
        self.granted_chunks = 0
        self.granted_tokens = 0
        self.deferred_steps = 0
        self.starvation_overrides = 0
        self.itl_shrunk_steps = 0
        self.deadline_overrides = 0

    @property
    def policy(self) -> str:
        return self.sla.policy

    # -- slot lifecycle ------------------------------------------------- #

    def assign_deadline(self, slot) -> None:
        """Stamp the slot's TTFT deadline from its arrival + priority.
        Called at slot construction (any task); only reads SLA config."""
        slot.sched_deadline = self.sla.deadline(
            slot.arrival_s, getattr(slot, "priority", 0)
        )

    def on_admit(self, slot) -> None:
        """Track the admitted slot's deadline (step-loop only)."""
        self._deadlines[slot.request_id] = slot.sched_deadline

    def onboard_headroom_ms(self, slot) -> Optional[float]:
        """TTFT headroom a KVBM tier onboard may spend for this slot (ms;
        floor 0). None under fifo — no deadline means no budget, so the
        engine never trades a tier hit for recompute (docs/kvbm.md)."""
        if self.sla.policy != "sla":
            return None
        return max((slot.sched_deadline - time.monotonic()) * 1000.0, 0.0)

    def on_release(self, slot) -> None:
        self._deadlines.pop(slot.request_id, None)

    def reset(self) -> None:
        """Fail-all: the batch died; no deadline may outlive its slot."""
        self._deadlines.clear()

    # -- ordering -------------------------------------------------------- #

    def tenant_debt(self, slot) -> int:
        """Recent prefill tokens granted to the slot's tenant (0 for the
        default tenant or one never served)."""
        return self._tenant_served.get(getattr(slot, "tenant", "") or "", 0)

    def _note_tenant(self, slot, granted: int) -> None:
        tenant = getattr(slot, "tenant", "") or ""
        served = self._tenant_served.get(tenant, 0) + granted
        self._tenant_served[tenant] = served
        if served > _TENANT_DECAY:
            for t in list(self._tenant_served):
                self._tenant_served[t] //= 2
        if len(self._tenant_served) > _TENANT_MAX:
            keep = sorted(self._tenant_served.items(),
                          key=lambda kv: kv[1], reverse=True)
            self._tenant_served = dict(keep[: _TENANT_MAX // 2])

    def order(self, cands: List) -> List:
        """Prefill candidate order. fifo: admission order (bit-for-bit the
        legacy `admit_seq` sort). sla: EDF with the starvation guard, and
        — within a ~100ms deadline bucket — the least-served tenant first
        (the dynogate fairness tiebreak: same class, same urgency, the
        noisy tenant queues behind the quiet one)."""
        if self.sla.policy != "sla":
            return sorted(cands, key=lambda s: s.admit_seq)
        starve = self.sla.starve_dispatches

        def key(s):
            starved = 0 if s.sched_skips >= starve else 1
            return (starved, int(s.sched_deadline / _TENANT_TIE_QUANTUM_S),
                    self.tenant_debt(s), s.sched_deadline, s.admit_seq)

        return sorted(cands, key=key)

    def order_waiting(self, waiting: List) -> List:
        """Admission order for the waiting queue under sla: EDF by the
        deadline stamped at arrival (preempted victims keep their original
        arrival, so they stay at the front exactly as the legacy
        insert-at-0 intended). fifo: untouched."""
        if self.sla.policy != "sla" or len(waiting) < 2:
            return waiting
        return sorted(waiting, key=lambda s: (s.sched_deadline, s.admit_seq))

    def pick_batch_kind(self, cands: List, kind_of: Callable[[object], str]) -> str:
        """Which dispatch-variant kind this batch serves. Legacy rule:
        first non-plain candidate's kind. Aging tiebreak: a non-plain
        candidate skipped `starve_dispatches` times by this very filter
        wins outright, so no kind starves under a steady stream of
        another kind."""
        starve = self.sla.starve_dispatches
        starved = [
            s for s in cands
            if kind_of(s) != "plain" and s.sched_skips >= starve
        ]
        if starved:
            self.starvation_overrides += 1
            winner = min(starved, key=lambda s: (-s.sched_skips, s.admit_seq))
            return kind_of(winner)
        return next((k for k in map(kind_of, cands) if k != "plain"), "plain")

    # -- shape planning -------------------------------------------------- #

    def _lane_cap(self, bucket: int) -> int:
        cfg = self.config
        return max(1, min(cfg.prefill_batch_tokens // bucket, cfg.max_prefill_batch))

    def _bucket_for(self, n: int) -> int:
        return bucket_for(n, self.config.prefill_buckets)

    def plan_prefill(
        self,
        cands: List,
        decode_active: bool,
        now: Optional[float] = None,
    ) -> Optional[PrefillPlan]:
        """Choose the prefill dispatch shape; None = defer this step (the
        ITL budget is exhausted and no deadline is at risk). `cands` must
        already be in planner order."""
        cfg = self.config
        if now is None:
            now = time.monotonic()

        def remaining(s) -> int:
            return len(s.kv_prompt) - s.prefill_pos

        if self.sla.policy != "sla":
            # legacy formula, bit-for-bit: bucket from the head candidate's
            # chunk, lanes 1 (lone arrival) or the bucket's cap
            first_chunk = min(remaining(cands[0]), cfg.max_prefill_chunk)
            bucket = self._bucket_for(first_chunk)
            lanes = 1 if len(cands) == 1 else self._lane_cap(bucket)
            plan = PrefillPlan(
                bucket=bucket, lanes=lanes, chosen=cands[:lanes], reason="fifo"
            )
            self._note(plan, cands, now)
            return plan

        # ITL budget: with decode active, the next block's K tokens arrive
        # (block_time + this_prefill_time) later — keep that under
        # K * itl_target. Unknown block cost (cold model) = no constraint.
        budget_s = None
        if decode_active and self.sla.itl_target_ms > 0:
            blk = self.cost.predict(
                "block", cfg.decode_block_steps, cfg.max_num_seqs
            )
            if blk is not None:
                budget_s = max(
                    cfg.decode_block_steps * self.sla.itl_target_ms / 1000.0
                    - blk,
                    0.0,
                )

        # max_prefill_chunk caps the bucket exactly as the legacy formula
        # did (first_chunk = min(remaining, cap) before bucketing): the
        # score search must not hand out a bigger dispatch than the
        # operator's per-chunk latency bound allows
        max_bucket = self._bucket_for(cfg.max_prefill_chunk)
        shapes: List[Tuple[bool, Tuple[int, int, int], int, int, List, Optional[float]]] = []
        for b in cfg.prefill_buckets:
            if b > max_bucket:
                continue
            cap = self._lane_cap(b)
            chosen = cands[:cap]
            lanes = 1 if len(chosen) == 1 else cap
            t = self.cost.predict("prefill", b, lanes)
            granted = sum(min(remaining(s), b) for s in chosen)
            fits = budget_s is None or t is None or t <= budget_s
            # score: serve the most slots, then the most real tokens, then
            # the least padding (smaller bucket)
            score = (len(chosen), granted, -b)
            shapes.append((fits, score, b, lanes, chosen, t))

        feasible = [x for x in shapes if x[0]]
        if feasible:
            best = max(feasible, key=lambda x: x[1])
            reason = "coverage" if len(feasible) == len(shapes) else "itl-shrunk"
            if reason == "itl-shrunk":
                self.itl_shrunk_steps += 1
            _, _, b, lanes, chosen, t = best
            plan = PrefillPlan(
                bucket=b, lanes=lanes, chosen=chosen, reason=reason,
                budget_s=budget_s, predicted_s=t,
                slack_ms=self._min_slack_ms(chosen, now),
            )
            self._note(plan, cands, now)
            return plan

        # every shape busts the ITL budget. Defer — unless the head's TTFT
        # deadline is already at risk (negative slack) or it has starved:
        # TTFT attainment outranks decode smoothness.
        smallest = min(shapes, key=lambda x: x[2])
        _, _, b, lanes, chosen, t = smallest
        head = cands[0]
        slack_s = head.sched_deadline - now - (t or 0.0)
        if slack_s < 0 or head.sched_skips >= self.sla.starve_dispatches:
            self.deadline_overrides += 1
            plan = PrefillPlan(
                bucket=b, lanes=lanes, chosen=chosen,
                reason="deadline-override", budget_s=budget_s, predicted_s=t,
                slack_ms=self._min_slack_ms(chosen, now),
            )
            self._note(plan, cands, now)
            return plan
        self.deferred_steps += 1
        self._records.append(_Decision(
            t=now, reason="deferred", deferred_slots=len(cands),
            budget_ms=None if budget_s is None else budget_s * 1000.0,
            slack_ms=self._min_slack_ms(cands, now),
        ))
        return None

    def plan_mixed(
        self,
        cands: List,
        n_decode: int,
        align: int = 1,
        now: Optional[float] = None,
        n_spec_rows: int = 0,
    ) -> Optional[MixedPlan]:
        """Shape the unified mixed dispatch: greedily grant prefill chunks
        (planner order, each padded to the packer's row alignment) into
        the flat-token budget left beside `n_decode` one-token decode
        rows. `n_spec_rows` reserves EXTRA one-token rows for speculative
        draft verification riding the same buffer (engine spec fusion:
        each spec-eligible lane packs its current token plus d drafts).
        Returns None when nothing fits — the engine falls back to
        the split path for this step. `cands` must already be in planner
        order.

        Under sla with an ITL target, the mixed step IS the decode step
        (it advances every decode lane one token), so its predicted wall
        time is budgeted directly against `itl_target_ms`: chunks are
        halved until the CostModel("mixed", bucket, rows) estimate fits,
        floored at one aligned unit per chunk (a mixed step never defers
        outright — serving the decode lanes is the point).

        Pure: no counters or decision records — the engine may still
        abandon the plan (pipeline in flight, page-growth preemption);
        it calls `commit_mixed` with what actually dispatched."""
        cfg = self.config
        if now is None:
            now = time.monotonic()

        def aligned(n: int) -> int:
            return -(-n // align) * align

        # floor the budget to the packer alignment: every granted span is
        # a multiple of `align`, so an aligned budget keeps `space`
        # aligned throughout and no grant can overpack the flat buffer
        budget = cfg.mixed_max_tokens - cfg.mixed_max_tokens % align
        dec_tokens = aligned(1) * (n_decode + n_spec_rows)
        if dec_tokens >= budget:
            return None  # too many decode lanes to fuse a chunk beside

        chosen: List = []
        chunks: List[int] = []
        space = budget - dec_tokens
        for s in cands[: cfg.max_prefill_batch]:
            remaining = len(s.kv_prompt) - s.prefill_pos
            take = min(remaining, cfg.max_prefill_chunk, space)
            if take <= 0:
                break
            chosen.append(s)
            chunks.append(take)
            space -= aligned(take)

        if not chosen:
            return None

        total = budget - space
        bucket = min(_next_pow2(max(total, align)), budget)
        rows = len(chosen) + n_decode + n_spec_rows
        reason = "mixed"
        t = self.cost.predict("mixed", bucket, rows)
        if (
            self.sla.policy == "sla"
            and self.sla.itl_target_ms > 0
            and t is not None
        ):
            itl_budget = self.sla.itl_target_ms / 1000.0
            while t is not None and t > itl_budget and max(chunks) > align:
                # halve the biggest chunk (floored at one aligned unit)
                i = max(range(len(chunks)), key=lambda j: chunks[j])
                chunks[i] = max(align, chunks[i] // 2)
                total = dec_tokens + sum(aligned(ch) for ch in chunks)
                bucket = min(_next_pow2(max(total, align)), budget)
                t = self.cost.predict("mixed", bucket, rows)
                reason = "mixed-shrunk"
        return MixedPlan(
            bucket=bucket, chosen=chosen, chunks=chunks, n_decode=n_decode,
            reason=reason, predicted_s=t,
            deferred_slots=len(cands) - len(chosen),
            n_spec_rows=n_spec_rows,
        )

    def commit_mixed(
        self,
        plan: MixedPlan,
        dispatched,
        now: Optional[float] = None,
    ) -> None:
        """Account a mixed dispatch the engine actually committed.
        `dispatched` is the [(slot, chunk)] list that survived the
        engine's post-plan re-filter (page-growth preemption can drop
        slots) — counters and the decision record reflect dispatched
        work only, never an abandoned plan (the split path's plan_prefill
        would otherwise double-count the same step)."""
        if now is None:
            now = time.monotonic()
        slots = [s for s, _ in dispatched]
        granted = sum(ch for _, ch in dispatched)
        if plan.reason == "mixed-shrunk":
            self.itl_shrunk_steps += 1
        self.granted_chunks += len(slots)
        self.granted_tokens += granted
        for s, ch in dispatched:
            self._note_tenant(s, ch)
        self._records.append(_Decision(
            t=now, reason=plan.reason, bucket=plan.bucket,
            lanes=len(slots) + plan.n_decode + plan.n_spec_rows,
            granted_tokens=granted, granted_slots=len(slots),
            deferred_slots=plan.deferred_slots,
            slack_ms=self._min_slack_ms(slots, now),
        ))

    def _min_slack_ms(self, slots: List, now: float) -> Optional[float]:
        if not slots:
            return None
        return min((s.sched_deadline - now) * 1000.0 for s in slots)

    def _note(self, plan: PrefillPlan, cands: List, now: float) -> None:
        def remaining(s) -> int:
            return len(s.kv_prompt) - s.prefill_pos

        granted = sum(min(remaining(s), plan.bucket) for s in plan.chosen)
        self.granted_chunks += len(plan.chosen)
        self.granted_tokens += granted
        for s in plan.chosen:
            self._note_tenant(s, min(remaining(s), plan.bucket))
        self._records.append(_Decision(
            t=now, reason=plan.reason, bucket=plan.bucket, lanes=plan.lanes,
            granted_tokens=granted, granted_slots=len(plan.chosen),
            deferred_slots=len(cands) - len(plan.chosen),
            budget_ms=None if plan.budget_s is None else plan.budget_s * 1000.0,
            slack_ms=plan.slack_ms,
        ))

    # -- observability ---------------------------------------------------- #

    def estimate_wait_ms(self, pending_tokens: int) -> Optional[float]:
        """Estimated time to prefill `pending_tokens` through this engine
        (queue depth x cost model): the disagg router's "local TTFT"
        signal. None until the cost model has seen a prefill."""
        per_tok = self.cost.per_token("prefill")
        if per_tok is None or pending_tokens <= 0:
            return 0.0 if per_tok is not None else None
        return pending_tokens * per_tok * 1000.0

    def recent_decisions(self) -> List[dict]:
        out = []
        for d in list(self._records):
            out.append({
                "reason": d.reason, "bucket": d.bucket, "lanes": d.lanes,
                "granted_tokens": d.granted_tokens,
                "granted_slots": d.granted_slots,
                "deferred_slots": d.deferred_slots,
                "budget_ms": d.budget_ms,
                "slack_ms": None if d.slack_ms is None else round(d.slack_ms, 1),
            })
        return out

    def stats(self) -> dict:
        last = self._records[-1] if self._records else None
        out = {
            "sched_policy": self.sla.policy,
            "sched_ttft_target_ms": self.sla.ttft_target_ms,
            "sched_itl_target_ms": self.sla.itl_target_ms,
            "sched_granted_chunks": self.granted_chunks,
            "sched_granted_tokens": self.granted_tokens,
            "sched_deferred_steps": self.deferred_steps,
            "sched_itl_shrunk_steps": self.itl_shrunk_steps,
            "sched_deadline_overrides": self.deadline_overrides,
            "sched_starvation_overrides": self.starvation_overrides,
            "sched_pending_deadlines": len(self._deadlines),
            "sched_cost_observations": self.cost.n_observations(),
            "sched_tenants_served": len(self._tenant_served),
        }
        if last is not None:
            out["sched_last_budget_tokens"] = last.granted_tokens
            if last.slack_ms is not None:
                out["sched_last_slack_ms"] = round(last.slack_ms, 1)
        return out
