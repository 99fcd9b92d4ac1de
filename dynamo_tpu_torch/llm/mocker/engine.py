"""Mock engine: a fake engine with real scheduling + KV accounting.

Port of `dynamo_tpu/llm/mocker/engine.py`, which mirrors reference lib/llm/src/mocker/: `MockVllmEngine` (engine.rs:48),
`Scheduler` (scheduler.rs:240) with continuous batching, chunked prefill,
prefix caching, and watermark eviction; `MockEngineArgs` (protocols.rs:67).

The mocker emits REAL KV events and realistic timing (scaled by
`speedup_ratio`), so the KV router, disaggregation flow, migration and
planner can all be exercised on CPU-only CI. It holds no tensor: the
scheduler policy's constants and `SlaConfig` are the engine's own.
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import time
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from ...engine.scheduler.policy import (
    _TENANT_DECAY,
    _TENANT_MAX,
    _TENANT_TIE_QUANTUM_S,
)
from ...engine.scheduler.sla import SlaConfig
from ...runtime import faults
from ...runtime.engine import Context
from ...runtime.metrics import (
    KV_ACTIVE_BLOCKS,
    KV_TOTAL_BLOCKS,
    NUM_RUNNING_REQS,
    NUM_WAITING_REQS,
    SCHED_EST_DECODE_TOK_S,
    SCHED_EST_PREFILL_TOK_S,
    SCHED_EST_REQ_MS,
    SCHED_EST_TTFT_MS,
)
from ...runtime.request_plane import StreamSevered
from ..protocols import Annotated, LLMEngineOutput, PreprocessedRequest
from ..tokens import DEFAULT_BLOCK_SIZE, TokenBlockSequence, compute_seq_hashes
from .kv_manager import KvEvent, KvManager

logger = logging.getLogger(__name__)


@dataclass
class MockEngineArgs:
    """Reference MockEngineArgs protocols.rs:67."""

    model_name: str = "mock-model"
    num_gpu_blocks: int = 4096
    block_size: int = DEFAULT_BLOCK_SIZE
    max_num_seqs: int = 256
    max_num_batched_tokens: int = 8192
    enable_prefix_caching: bool = True
    enable_chunked_prefill: bool = True
    speedup_ratio: float = 1.0
    # synthetic timing model (seconds)
    prefill_time_per_token: float = 25e-6
    decode_time_per_step: float = 8e-3
    decode_time_per_seq: float = 60e-6
    vocab_size: int = 32000
    # SLA-aware scheduling (engine/scheduler/sla.py): None = resolve from
    # the DYN_SCHED_POLICY / DYN_SLA_TTFT_MS / DYN_SLA_ITL_MS env knobs.
    # "fifo" keeps the reference scheduler bit-for-bit; "sla" orders
    # admission+prefill by TTFT deadline (EDF) and caps the per-step
    # prefill budget so the synthetic decode cadence holds the ITL target
    # — the same policy the TorchEngine's StepPlanner applies, priced by
    # the mocker's own timing model instead of the EWMA cost model.
    sched_policy: Optional[str] = None
    ttft_target_ms: Optional[float] = None
    itl_target_ms: Optional[float] = None
    # serving role (docs/autoscaling.md "Role morphing"): which discovery
    # component this engine's worker registers under. "both" = colocated
    # (one worker serves prefill AND decode at low traffic). Flipped live
    # by MockEngine.morph().
    role: str = "decode"


@dataclass
class _MockRequest:
    request_id: str
    prompt: List[int]
    max_tokens: int
    eos_token_ids: List[int]
    ignore_eos: bool
    queue: asyncio.Queue
    context: Context
    seq: TokenBlockSequence = None  # type: ignore[assignment]
    prefill_pos: int = 0  # tokens prefilled so far
    generated: int = 0
    held_hashes: List[int] = field(default_factory=list)
    done: bool = False
    decode_only: bool = False  # disagg: KV assumed transferred in
    priority: int = 0
    sched_deadline: float = 0.0  # EDF key (monotonic s; sla policy only)
    tenant: str = ""  # dynogate fairness key (docs/overload.md)


class MockEngine:
    """Continuous-batching mock engine (reference MockVllmEngine engine.rs:48).

    `generate(request, context)` returns an async stream of Annotated
    LLMEngineOutput; a background step loop does prefill (chunked) and
    decode with synthetic timing.
    """

    def __init__(
        self,
        args: Optional[MockEngineArgs] = None,
        event_sink: Optional[Callable[[KvEvent], None]] = None,
    ):
        self.args = args or MockEngineArgs()
        self.kv = KvManager(
            self.args.num_gpu_blocks, self.args.block_size, event_sink=event_sink
        )
        self._waiting: List[_MockRequest] = []
        self._running: List[_MockRequest] = []
        self._step_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._closed = False
        self.num_requests = 0
        self.sla = SlaConfig.from_env(
            policy=self.args.sched_policy,
            ttft_target_ms=self.args.ttft_target_ms,
            itl_target_ms=self.args.itl_target_ms,
        )
        self.sched_deferred_steps = 0  # steps the ITL budget zeroed prefill
        self.sched_deadline_overrides = 0  # overdue requests that broke it
        # dynogate parity with StepPlanner (docs/overload.md): recent
        # prefill tokens per tenant — the EDF tiebreak prefers the
        # least-served tenant inside a ~100ms deadline bucket
        self._tenant_served: Dict[str, int] = {}
        # migration parity with TorchEngine stats (docs/fault_tolerance.md):
        # the mocker has no KVBM tiers, so every resume is a recompute —
        # but the soak/CI arms still assert the resume was COUNTED here
        self.migrations_resumed = 0
        self.resume_source_recompute = 0
        # live role morphing (docs/autoscaling.md "Role morphing"): the
        # serving role + state machine position, mutated only inside
        # morph() (GUARDED_STATE "MockEngine._role"/"._morph_state")
        self._role = self.args.role
        self._morph_state = "serving"
        self.morphs_completed = 0
        self.morphs_rolled_back = 0
        self.morph_drained_sessions = 0
        self.morph_last_duration_s = 0.0
        # fused-coverage parity with TorchEngine (docs/ragged_attention.md):
        # the mocker's step IS a fused prefill+decode step by
        # construction, so a step serving both kinds counts as mixed and
        # coverage is structurally 1.0 — gates reading any worker's
        # metrics see the same key set
        self.mixed_steps = 0
        self.split_steps = 0
        self.mixed_rows_plain = 0

    # -- lifecycle ---------------------------------------------------------- #

    def start(self):
        if self._step_task is None:
            self._step_task = asyncio.create_task(self._step_loop())

    async def close(self):
        self._closed = True
        self._wake.set()
        if self._step_task:
            self._step_task.cancel()

    async def warmup(self, extra_delay: float = 0.0) -> int:
        """Drive a few requests through the real step loop BEFORE the
        worker joins the control plane (the TorchEngine.warmup contract:
        first-iteration costs are paid pre-registration, never absorbed by
        live traffic). `extra_delay` simulates compile time so ordering
        tests can observe the not-yet-routable window."""
        n = 0
        for _ in range(2):
            req = PreprocessedRequest(
                token_ids=list(range(40, 56)),
                stop_conditions={"max_tokens": 4, "ignore_eos": True},
            ).to_dict()
            async for _ in self.generate(req, Context()):
                pass
            n += 1
        if extra_delay > 0:
            await asyncio.sleep(extra_delay)
        return n

    # -- public engine interface -------------------------------------------- #

    async def generate(
        self, request: Any, context: Context
    ) -> AsyncIterator[dict]:
        if self._morph_state in ("draining-role", "flipped"):
            # mid-morph: refuse new streams the same way the drain cut the
            # in-flight ones — the server maps StreamSevered to a
            # `draining`-coded T_ERR, so the caller's migration machinery
            # re-routes instead of surfacing a terminal error. ("warm" is
            # admitted: the re-warm phase drives generate() itself.)
            raise StreamSevered(
                f"worker is morphing ({self._morph_state}); stream re-routed"
            )
        self.start()
        req = (
            request
            if isinstance(request, PreprocessedRequest)
            else PreprocessedRequest.from_dict(request)
        )
        stop = req.stop_conditions or {}
        disagg = req.disagg_params or {}
        mreq = _MockRequest(
            request_id=req.request_id or f"mock-{self.num_requests}",
            prompt=list(req.token_ids),
            max_tokens=int(stop.get("max_tokens") or 128),
            eos_token_ids=list(req.eos_token_ids or []),
            ignore_eos=bool(stop.get("ignore_eos")),
            queue=asyncio.Queue(),
            context=context,
            decode_only=bool(disagg.get("remote_prefill_done")),
        )
        mreq.seq = TokenBlockSequence(mreq.prompt, self.args.block_size)
        mreq.priority = int(req.priority or 0)
        mreq.tenant = req.tenant or ""
        if int(getattr(req, "migration", 0) or 0):
            self.migrations_resumed += 1
            self.resume_source_recompute += 1
        mreq.sched_deadline = self.sla.deadline(time.monotonic(), mreq.priority)
        self.num_requests += 1
        self._waiting.append(mreq)
        self._wake.set()
        try:
            while True:
                item = await mreq.queue.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    # _sever_all pushed a StreamSevered sentinel: raise it
                    # out of the handler so the request plane codes the
                    # T_ERR as `draining` and the caller migrates
                    raise item
                yield item
        finally:
            mreq.done = True
            self._wake.set()

    # -- stats (ForwardPassMetrics role) ------------------------------------ #

    def stats(self) -> dict:
        est_role = self.estimated_role_tok_s()
        return {
            NUM_WAITING_REQS: len(self._waiting),
            NUM_RUNNING_REQS: len(self._running),
            "gpu_cache_usage_perc": self.kv.usage_perc(),
            KV_ACTIVE_BLOCKS: self.kv.active_blocks,
            KV_TOTAL_BLOCKS: self.kv.num_blocks,
            "request_total_slots": self.args.max_num_seqs,
            "sched_policy": self.sla.policy,
            "sched_deferred_steps": self.sched_deferred_steps,
            "sched_deadline_overrides": self.sched_deadline_overrides,
            "migrations_resumed": self.migrations_resumed,
            "resume_source_recompute": self.resume_source_recompute,
            # dynogate signal parity with the TorchEngine (docs/overload.md):
            # the frontend admission gate projects TTFT from this gauge,
            # so the soak and CI smoke exercise the real gate without a model
            SCHED_EST_TTFT_MS: round(self.estimated_ttft_ms(), 1),
            # marginal cost of one MORE admitted request (the gate's
            # optimism-debt unit between 0.25s metric publishes — without
            # it a one-window burst floods past the published estimate)
            SCHED_EST_REQ_MS: round(self.estimated_req_ms(), 1),
            # role-morph telemetry (docs/autoscaling.md "Role morphing"):
            # per-role marginal throughput prices the planner's re-role
            # arm; the role/state gauges make a flip observable
            SCHED_EST_PREFILL_TOK_S: round(est_role["prefill"], 1),
            SCHED_EST_DECODE_TOK_S: round(est_role["decode"], 1),
            "engine_role": self._role,
            "morph_state": self._morph_state,
            "morphs_completed": self.morphs_completed,
            "morphs_rolled_back": self.morphs_rolled_back,
            "morph_drained_sessions": self.morph_drained_sessions,
            "morph_last_duration_s": round(self.morph_last_duration_s, 3),
            # fused-coverage parity (see __init__): structurally fused
            "mixed_steps": self.mixed_steps,
            "split_steps": self.split_steps,
            "mixed_rows_plain": self.mixed_rows_plain,
            "mixed_coverage_frac": 1.0,
        }

    def estimated_req_ms(self) -> float:
        """Marginal TTFT one more admitted request adds: with every slot
        busy, each queued admission adds one FULL request drain spread
        across the slots."""
        a = self.args
        occupied = len(self._running) + len(self._waiting)
        if occupied < a.max_num_seqs or not occupied:
            return 0.0  # truly free slots: an admission costs no queue wait
        speed = max(a.speedup_ratio, 1e-9)
        per_step = (
            a.decode_time_per_step
            + a.max_num_seqs * a.decode_time_per_seq
        ) / speed
        full = [max(r.max_tokens, 1) for r in [*self._running, *self._waiting]]
        mean_req_s = (sum(full) / len(full)) * per_step
        return mean_req_s / max(a.max_num_seqs, 1) * 1000.0

    def estimated_ttft_ms(self) -> float:
        """Projected TTFT for one more arriving request, priced by the
        mocker's own synthetic timing model (the mocker's spelling of
        TorchEngine.estimated_prefill_wait_ms): pending prefill tokens at
        the prefill rate, plus — when every slot is taken — the slot wait
        until the decode work AHEAD of the newcomer drains: the running
        requests' remaining steps plus every queued request's FULL
        service time, spread across the slots."""
        a = self.args
        speed = max(a.speedup_ratio, 1e-9)
        pending_tokens = sum(
            max(len(r.prompt) - r.prefill_pos, 0)
            for r in [*self._waiting, *self._running]
            if not r.done and not r.decode_only
        )
        est_s = pending_tokens * a.prefill_time_per_token / speed
        # slot wait: a waiting queue means every momentarily-free slot is
        # already spoken for — the term must not collapse to zero in the
        # instant between a finish and the next admission step (the gate
        # would read that publish as an idle fleet and flood)
        if self._waiting or len(self._running) >= a.max_num_seqs:
            per_step = (
                a.decode_time_per_step
                + a.max_num_seqs * a.decode_time_per_seq
            ) / speed
            ahead_steps = sum(
                max(r.max_tokens - r.generated, 1) for r in self._running
            ) + sum(
                max(r.max_tokens, 1)
                for r in self._waiting if not r.done
            )
            est_s += (ahead_steps / max(a.max_num_seqs, 1)) * per_step
        return est_s * 1000.0

    # -- scheduler ---------------------------------------------------------- #

    async def _step_loop(self):
        """One iteration = admit + chunked prefill + decode all running
        (reference Scheduler::step scheduler.rs:240)."""
        while not self._closed:
            if not self._waiting and not self._running:
                self._wake.clear()
                await self._wake.wait()
                continue
            t_step0 = time.monotonic()
            try:
                f = faults.FAULTS
                if f.enabled:
                    # dynochaos `mocker.step`: rides the same fail-all path
                    # a real scheduler bug would take
                    await f.on("mocker.step")
                prefill_tokens = self._do_admission_and_prefill()
                decoded = self._do_decode()
                if prefill_tokens and decoded:
                    self.mixed_steps += 1
                self.mixed_rows_plain += decoded
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — step loop must not die silently
                logger.exception("mock engine step failed; failing active requests")
                self._fail_all(f"mock engine step failed: {type(e).__name__}: {e}")
                await asyncio.sleep(0.05)
                continue
            # synthetic step latency
            a = self.args
            step_time = (
                prefill_tokens * a.prefill_time_per_token
                + (a.decode_time_per_step + decoded * a.decode_time_per_seq if decoded else 0.0)
            ) / max(a.speedup_ratio, 1e-9)
            elapsed = time.monotonic() - t_step0
            await asyncio.sleep(max(step_time - elapsed, 0.0001))

    def _itl_prefill_budget(self) -> int:
        """sla policy: prefill tokens this step may spend while the
        projected step latency (decode + prefill, the mocker's synthetic
        timing model) stays under the ITL target. Full throttle when no
        request is decode-active; a request past its TTFT deadline breaks
        a zero budget (one block) — TTFT attainment outranks decode
        smoothness, mirroring StepPlanner's deadline override."""
        a = self.args
        full = a.max_num_batched_tokens
        if self.sla.itl_target_ms <= 0:
            return full
        n_dec = sum(
            1 for r in self._running if r.prefill_pos >= len(r.prompt)
        )
        if not n_dec:
            return full
        speed = max(a.speedup_ratio, 1e-9)
        decode_s = (a.decode_time_per_step + n_dec * a.decode_time_per_seq) / speed
        per_tok = a.prefill_time_per_token / speed
        if per_tok <= 0:
            return full
        budget = int(max(self.sla.itl_target_ms / 1000.0 - decode_s, 0.0) / per_tok)
        budget = min(budget, full)
        if budget <= 0:
            pending = [
                r for r in [*self._waiting, *self._running]
                if r.prefill_pos < len(r.prompt) and not r.done
            ]
            if not pending:
                return 0  # nothing to defer: the counters must not move
            now = time.monotonic()
            if any(r.sched_deadline <= now for r in pending):
                self.sched_deadline_overrides += 1
                return a.block_size
            self.sched_deferred_steps += 1
            return 0
        return budget

    def _do_admission_and_prefill(self) -> int:
        """Admit waiting requests (prefix-cache aware) and advance chunked
        prefill; returns prefill tokens processed this step. Under the
        sla policy, admission and chunk order are EDF over TTFT deadlines
        and the budget is ITL-capped; under fifo (default) this is the
        reference scheduler bit-for-bit."""
        a = self.args
        budget = a.max_num_batched_tokens
        waiting = self._waiting
        if self.sla.policy == "sla":
            waiting = sorted(waiting, key=self._edf_key)
            budget = min(budget, self._itl_prefill_budget())
        processed = 0
        # admit
        still_waiting: List[_MockRequest] = []
        for req in waiting:
            if req.done or req.context.is_stopped():
                self._finish(req, "cancelled", emit=not req.done)
                continue
            if len(self._running) >= a.max_num_seqs:
                still_waiting.append(req)
                continue
            hashes = req.seq.block_hashes()
            if a.enable_prefix_caching:
                cached = self.kv.cached_prefix_blocks(hashes)
            else:
                cached = 0
            if not self.kv.can_allocate(hashes, extra_blocks=1):
                still_waiting.append(req)
                continue
            token_blocks = [b.tokens for b in req.seq.blocks]
            self.kv.acquire(hashes, token_blocks=token_blocks)
            req.held_hashes = list(hashes)
            req.prefill_pos = cached * a.block_size if not req.decode_only else len(req.prompt)
            self._running.append(req)
        self._waiting = still_waiting
        # chunked prefill over running requests (EDF order under sla;
        # taken AFTER admission so fresh admits prefill this same step,
        # exactly like the fifo path)
        prefill_order = (
            sorted(self._running, key=self._edf_key)
            if self.sla.policy == "sla" else self._running
        )
        for req in prefill_order:
            if req.prefill_pos >= len(req.prompt):
                continue
            remaining = len(req.prompt) - req.prefill_pos
            chunk = min(remaining, budget - processed) if a.enable_chunked_prefill else remaining
            if chunk <= 0:
                continue
            req.prefill_pos += chunk
            processed += chunk
            self._note_tenant(req.tenant, chunk)
        return processed

    def _edf_key(self, req: _MockRequest):
        """EDF with the dynogate tenant tiebreak (StepPlanner.order
        parity — same quantum/decay/cap constants, imported so the two
        paths cannot drift): within a deadline bucket the least-served
        tenant goes first."""
        return (int(req.sched_deadline / _TENANT_TIE_QUANTUM_S),
                self._tenant_served.get(req.tenant, 0), req.sched_deadline)

    def _note_tenant(self, tenant: str, granted: int) -> None:
        served = self._tenant_served.get(tenant, 0) + granted
        self._tenant_served[tenant] = served
        if served > _TENANT_DECAY:
            for t in list(self._tenant_served):
                self._tenant_served[t] //= 2
        if len(self._tenant_served) > _TENANT_MAX:  # client-controlled key
            keep = sorted(self._tenant_served.items(),
                          key=lambda kv: kv[1], reverse=True)
            self._tenant_served = dict(keep[: _TENANT_MAX // 2])

    def _do_decode(self) -> int:
        """One decode token for every prefilled running request."""
        a = self.args
        decoded = 0
        finished: List[_MockRequest] = []
        for req in self._running:
            if req.done or req.context.is_stopped():
                finished.append(req)
                continue
            if req.prefill_pos < len(req.prompt):
                continue  # still prefilling
            token = self._next_token(req)
            req.seq.append(token)
            req.generated += 1
            decoded += 1
            # block accounting for newly completed generation blocks
            hashes = req.seq.block_hashes()
            if len(hashes) > len(req.held_hashes):
                new = hashes[len(req.held_hashes) :]
                tokens_new = [b.tokens for b in req.seq.blocks[len(req.held_hashes) :]]
                self.kv.acquire(
                    new,
                    token_blocks=tokens_new,
                    parent_of_first=req.held_hashes[-1] if req.held_hashes else None,
                )
                req.held_hashes.extend(new)
            finish = None
            if not req.ignore_eos and token in req.eos_token_ids:
                finish = "eos"
            elif req.generated >= req.max_tokens:
                finish = "length"
            out = LLMEngineOutput(token_ids=[token], finish_reason=finish).to_dict()
            req.queue.put_nowait(Annotated(data=out).to_dict())
            if finish:
                finished.append(req)
        for req in finished:
            self._finish(req, None)
        return decoded

    def _next_token(self, req: _MockRequest) -> int:
        """Deterministic pseudo-token stream derived from the prompt. Tokens
        land in the byte-tokenizer's printable range (ids 35..126 ≈ ASCII)
        so mock responses detokenize to visible text."""
        h = hashlib.blake2b(
            f"{req.request_id}:{req.generated}".encode()
            + bytes(str(req.prompt[:8]), "ascii"),
            digest_size=4,
        ).digest()
        tok = 35 + int.from_bytes(h, "little") % 92
        while tok in req.eos_token_ids:
            tok = 35 + (tok + 1 - 35) % 92
        return tok

    def _fail_all(self, message: str):
        """A step raised: error every live request so callers see a clean
        typed terminal chunk and can retry/migrate, instead of hanging on
        queues a dead step loop will never fill (mirrors
        TorchEngine._fail_all)."""
        for req in [*self._running, *self._waiting]:
            if req.held_hashes:
                self.kv.release(req.held_hashes)
                req.held_hashes = []
            if not req.done:
                req.queue.put_nowait(Annotated.from_error(message).to_dict())
                req.queue.put_nowait(None)
                req.done = True
        self._running = []
        self._waiting = []

    def _sever_all(self, message: str) -> int:
        """Role-morph drain: deliberately cut every live stream with a
        StreamSevered sentinel (NOT a terminal error chunk — _fail_all's
        shape). The consumer loop raises it, the server codes the T_ERR
        as `draining`, and each caller's migration loop resumes the
        session on a peer from its durable checkpoint."""
        severed = 0
        for req in [*self._running, *self._waiting]:
            if req.held_hashes:
                self.kv.release(req.held_hashes)
                req.held_hashes = []
            # no trailing None: the consumer raises on the sentinel itself
            if not req.done:
                req.queue.put_nowait(StreamSevered(message))
                req.done = True
                severed += 1
        self._running = []
        self._waiting = []
        return severed

    # -- live role morphing (docs/autoscaling.md "Role morphing") ------------ #

    _ROLES = {
        "prefill": {"prefill"},
        "decode": {"decode"},
        "both": {"prefill", "decode"},
    }

    async def morph(
        self,
        target_role: str,
        *,
        on_flip: Optional[Callable[[], Any]] = None,
    ) -> dict:
        """Re-role this live engine: serving → draining-role → flipped →
        warm → serving. Streams of the OUTGOING role are severed so their
        sessions resume on peers from durable checkpoints (zero lost
        items, a tail of latency); `on_flip` is awaited between the role
        flip and re-warm so the worker harness can atomically move the
        discovery registration; re-warm drives the incoming role's
        compile surfaces before the worker takes traffic again.

        Failure semantics: any exception mid-morph rolls the engine back
        to its original role (drained sessions already resumed on peers —
        nothing to restore) EXCEPT faults.MorphCrash, which propagates so
        the harness tears the worker down crash-style."""
        if target_role not in self._ROLES:
            raise ValueError(f"unknown role {target_role!r}")
        if self._morph_state != "serving":
            raise RuntimeError(
                f"morph re-entered while {self._morph_state!r}"
            )
        old_role = self._role
        if target_role == old_role:
            return {"from": old_role, "to": target_role,
                    "drained": 0, "duration_s": 0.0}
        t0 = time.monotonic()
        self._morph_state = "draining-role"
        try:
            f = faults.FAULTS
            if f.enabled:
                # dynochaos `worker.morph` (mid-drain): `error` exercises
                # rollback, `crash` the corpse path
                act = await f.on("worker.morph")
                if act == "crash":
                    raise faults.MorphCrash("injected crash mid-drain")
            drained = 0
            # sever when ANY previously-served lane is going away; "both"
            # keeps every lane, so growing into it drains nothing
            if self._ROLES[old_role] - self._ROLES[target_role]:
                drained = self._sever_all(
                    f"worker morphing {old_role}->{target_role}; "
                    "stream re-routed"
                )
            self.morph_drained_sessions += drained
            self._morph_state = "flipped"
            if f.enabled:
                # dynochaos `worker.morph` (mid-flip): same actions, after
                # the drain — rollback here proves sessions already moved
                act = await f.on("worker.morph")
                if act == "crash":
                    raise faults.MorphCrash("injected crash mid-flip")
            self._role = target_role
            if on_flip is not None:
                await on_flip()
            self._morph_state = "warm"
            await self.warmup()
        except asyncio.CancelledError:
            raise
        except faults.MorphCrash:
            raise  # harness tears the worker down mid-morph, no rollback
        except Exception:
            self._role = old_role
            self._morph_state = "serving"
            self.morphs_rolled_back += 1
            raise
        self._morph_state = "serving"
        self.morphs_completed += 1
        self.morph_last_duration_s = time.monotonic() - t0
        return {"from": old_role, "to": target_role,
                "drained": drained,
                "duration_s": self.morph_last_duration_s}

    def estimated_role_tok_s(self) -> Dict[str, float]:
        """Marginal per-role throughput from the synthetic timing model —
        the mocker's spelling of the TorchEngine's cost-model-EWMA
        estimates that price the planner's morph-vs-spawn decision."""
        a = self.args
        speed = max(a.speedup_ratio, 1e-9)
        prefill = speed / max(a.prefill_time_per_token, 1e-12)
        b = max(a.max_num_seqs, 1)
        decode = b * speed / max(
            a.decode_time_per_step + b * a.decode_time_per_seq, 1e-12
        )
        return {"prefill": prefill, "decode": decode}

    def _finish(self, req: _MockRequest, reason: Optional[str], emit: bool = True):
        if req in self._running:
            self._running.remove(req)
        if req.held_hashes:
            self.kv.release(req.held_hashes)
            req.held_hashes = []
        if emit and reason and not req.done:
            out = LLMEngineOutput(token_ids=[], finish_reason=reason).to_dict()
            req.queue.put_nowait(Annotated(data=out).to_dict())
        if not req.done:
            req.queue.put_nowait(None)
