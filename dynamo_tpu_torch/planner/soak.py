"""Autoscaling soak harness: the planner loop's proving ground.

Port of `dynamo_tpu/planner/soak.py` (docs/autoscaling.md): an in-proc cluster — real frontend
(HTTP service + model watcher + /metrics), real discovery, N mock workers
— with the real `Planner` scraping the frontend and scaling the worker set
while a seeded qps ramp runs and dynochaos fault plans fire. The pieces
here are reusable by tests (tests/test_planner_soak.py), the CI soak
smoke, and interactive debugging; none of them stub the serving plane —
streams ride the same request-plane/migration/drain machinery production
traffic does.

Two worker backends implement the `PlannerConnector` protocol:

* :class:`InProcWorkerPool` — workers are `DistributedRuntime`s inside
  this process (fast: tier-1 soak). Scale-down closes gracefully (the
  PR-3 drain: mark draining → revoke lease → finish in-flight);
  `kill_one()` tears a worker down crash-style for migration tests.
* `planner.connector.LocalProcessConnector` — real subprocess workers
  (`python -m dynamo_tpu_torch.mocker`), SIGTERM-drained on scale-down;
  the subprocess soaks use it via :func:`mocker_cmd`.

Its HTTP client is the port's asyncio-stream one (`llm/http/client.py`),
for the GETs and the SSE streams: the card's machine has no aiohttp.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..llm.http.client import ClientError, ClientSession
from ..runtime import DistributedRuntime, RouterMode, RuntimeConfig
from ..runtime.discovery import DiscoveryServer
from .perf_interpolation import DecodeInterpolator, PrefillInterpolator

logger = logging.getLogger(__name__)


# --------------------------------------------------------------------------- #
# synthetic interpolation profiles
# --------------------------------------------------------------------------- #


def synthetic_profiles(
    decode_tok_s_per_chip: float = 56.0,
    prefill_tok_s_per_chip: float = 5000.0,
    itl_grid_ms: float = 40.0,
    max_kv_tokens: int = 100_000,
) -> Tuple[dict, dict]:
    """(prefill_raw, decode_raw) interpolator inputs with CONSTANT
    throughput surfaces, so the planner's replica math reduces to
    `ceil(load_tok_s / per_chip)` — the soak can predict the correct
    replica count for a given ramp exactly."""
    isl = np.array([16.0, 256.0, 1024.0, 4096.0])
    prefill_raw = {
        "prefill_isl": isl,
        "prefill_ttft": np.full_like(isl, 5.0),  # ms; flat
        "prefill_thpt_per_gpu": np.full_like(isl, prefill_tok_s_per_chip),
    }
    xs, ys = np.meshgrid(
        np.array([0.1, 0.3, 0.5, 0.7, 0.9]), np.array([64.0, 512.0, 2048.0])
    )
    xs, ys = xs.ravel(), ys.ravel()
    decode_raw = {
        "x_kv_usage": xs,
        "y_context_length": ys,
        "z_itl": np.full_like(xs, itl_grid_ms),
        "z_thpt_per_gpu": np.full_like(xs, decode_tok_s_per_chip),
        "max_kv_tokens": np.array([max_kv_tokens]),
    }
    return prefill_raw, decode_raw


def make_interpolators(**kwargs) -> Tuple[PrefillInterpolator, DecodeInterpolator]:
    p_raw, d_raw = synthetic_profiles(**kwargs)
    return (
        PrefillInterpolator(raw_data=p_raw),
        DecodeInterpolator(raw_data=d_raw),
    )


# --------------------------------------------------------------------------- #
# in-proc cluster pieces
# --------------------------------------------------------------------------- #


class SoakFrontend:
    """Discovery server + frontend runtime + model watcher + HTTP service,
    all in-proc — the real serving plane the ramp drives and the planner
    scrapes."""

    def __init__(self, router_mode: RouterMode = RouterMode.ROUND_ROBIN,
                 lease_ttl_s: float = 3.0, graceful_timeout: float = 10.0):
        self.router_mode = router_mode
        self.lease_ttl_s = lease_ttl_s
        self.graceful_timeout = graceful_timeout
        self.disc: Optional[DiscoveryServer] = None
        self.drt: Optional[DistributedRuntime] = None
        self.http = None
        self.watcher = None
        self.gate = None  # dynogate (env-resolved; DYN_GATE=0 disables)
        self.port: int = 0

    @property
    def cfg(self) -> RuntimeConfig:
        cfg = RuntimeConfig()
        assert self.disc is not None
        cfg.discovery_endpoint = f"tcp://127.0.0.1:{self.disc.port}"
        cfg.lease_ttl_s = self.lease_ttl_s
        cfg.graceful_shutdown_timeout = self.graceful_timeout
        return cfg

    @property
    def metrics_url(self) -> str:
        return f"http://127.0.0.1:{self.port}/metrics"

    @property
    def base_url(self) -> str:
        return f"http://127.0.0.1:{self.port}"

    async def start(self) -> "SoakFrontend":
        from ..gate import AdmissionGate, GateConfig
        from ..llm.discovery import ModelManager, ModelWatcher
        from ..llm.http import HttpService

        self.disc = DiscoveryServer(port=0)
        await self.disc.start()
        self.drt = await DistributedRuntime.create(self.cfg)
        # same gate wiring as `python -m dynamo_tpu_torch.frontend`: the soaks
        # exercise the production admission path, not a stub of it
        gate_cfg = GateConfig.from_env()
        if gate_cfg.enabled:
            self.gate = AdmissionGate(self.drt, gate_cfg)
            await self.gate.start()
        manager = ModelManager()
        self.watcher = ModelWatcher(
            self.drt, manager, self.router_mode, gate=self.gate
        )
        await self.watcher.start()
        self.http = HttpService(manager, host="127.0.0.1", port=0,
                                gate=self.gate)
        self.port = await self.http.start()
        return self

    async def wait_model(self, model: str, timeout: float = 30.0):
        deadline = time.monotonic() + timeout
        async with ClientSession() as s:
            while time.monotonic() < deadline:
                try:
                    async with s.get(f"{self.base_url}/v1/models") as r:
                        data = await r.json()
                    if any(m["id"] == model for m in data.get("data", [])):
                        return
                except (ClientError, OSError, ValueError):
                    pass
                await asyncio.sleep(0.1)
        raise TimeoutError(f"model {model} never registered")

    async def stop(self):
        if self.watcher is not None:
            await self.watcher.stop()
        if self.http is not None:
            await self.http.stop()
        if self.gate is not None:
            await self.gate.close()
        if self.drt is not None:
            await self.drt.close()
        if self.disc is not None:
            await self.disc.stop()


#: which serving roles a worker role covers (soak-side mirror of the
#: engines' _ROLES table): a "both" worker counts as prefill AND decode.
ROLE_SERVES = {
    "prefill": frozenset({"prefill"}),
    "decode": frozenset({"decode"}),
    "both": frozenset({"prefill", "decode"}),
}


class InProcMockWorker:
    """One in-proc mock worker: mirrors `python -m dynamo_tpu_torch.mocker` —
    warmup BEFORE registration (the capacity-readiness gate the planner
    counts on), MockEngine behind a served endpoint, model card under the
    primary lease.

    Role-aware (docs/autoscaling.md "Role morphing"): a decode-role worker
    registers under `component` with the model card (chat traffic routes
    here), a prefill-role worker registers under `prefill_component` with
    NO card (it is planner capacity + disagg remote-prefill target, never
    a chat destination), and a colocated "both" worker registers under
    both. `morph()` re-roles the live worker: mark every lane `morphing`
    (routers stop dialing immediately), drain via the engine's
    StreamSevered tail-migration, then flip the discovery lanes + card
    atomically with the drain's completion."""

    def __init__(self, cfg: RuntimeConfig, engine_args, *,
                 namespace: str = "dynamo", component: str = "mocker",
                 prefill_component: str = "prefill",
                 endpoint: str = "generate", migration_limit: int = 3):
        self.cfg = cfg
        self.engine_args = engine_args
        self.namespace, self.component, self.endpoint = namespace, component, endpoint
        self.prefill_component = prefill_component
        self.migration_limit = migration_limit
        self.role: str = getattr(engine_args, "role", "decode")
        self.drt: Optional[DistributedRuntime] = None
        self.engine = None
        self._metrics_pub = None
        self._served: dict = {}  # component name -> ServedEndpoint
        self._card_key: Optional[str] = None

    def _role_components(self, role: str) -> List[str]:
        return {
            "decode": [self.component],
            "prefill": [self.prefill_component],
            "both": [self.component, self.prefill_component],
        }[role]

    def _lane_endpoint(self, comp: str):
        assert self.drt is not None
        return (self.drt.namespace(self.namespace)
                .component(comp).endpoint(self.endpoint))

    async def _serve_lane(self, comp: str):
        engine = self.engine

        async def handler(request, context):
            async for item in engine.generate(request, context):
                yield item

        return await self._lane_endpoint(comp).serve_endpoint(handler)

    async def _register_card(self) -> None:
        from ..llm.model_card import ModelDeploymentCard, register_llm

        self._card_key = await register_llm(
            self._lane_endpoint(self.component),
            ModelDeploymentCard(
                name=self.engine_args.model_name,
                tokenizer="byte",
                kv_cache_block_size=self.engine_args.block_size,
                migration_limit=self.migration_limit,
            ))

    async def _drop_card(self) -> None:
        # mirror ServedEndpoint.remove for the leased card key: a worker
        # morphed away from decode must stop advertising the model NOW,
        # not at lease expiry
        assert self.drt is not None and self._card_key is not None
        self.drt._leased_keys.pop(self._card_key, None)
        if self.drt.discovery is not None:
            await self.drt.discovery.delete(self._card_key)
        self._card_key = None

    async def _start_metrics(self) -> None:
        from ..llm.kv_router.publisher import WorkerMetricsPublisher

        # swap-before-await: the attribute is cleared synchronously, so a
        # concurrent caller never double-closes the same publisher
        pub, self._metrics_pub = self._metrics_pub, None
        if pub is not None:
            await pub.close()
        if not self._served:
            return
        comp = (self.component if self.component in self._served
                else next(iter(self._served)))
        # same load-signal surface as `python -m dynamo_tpu_torch.mocker`: the
        # admission gate and KV router read sched_est_ttft_ms/queue depth
        # off this topic (docs/overload.md); the planner's RoleEstimates
        # reads sched_est_{prefill,decode}_tok_s off the same stats dict
        self._metrics_pub = WorkerMetricsPublisher(
            self.drt, self._lane_endpoint(comp),
            self.drt.instance_id, self.engine.stats
        )
        await self._metrics_pub.start()

    async def _apply_lanes(self, role: str) -> None:
        """Reconcile discovery registrations to `role`'s lane set: remove
        lanes the role drops, serve lanes it gains (born `morphing` until
        the morph commits), and move the model card + metrics topic with
        the decode lane. Runs as the engine morph's on_flip hook, so the
        discovery flip is atomic with drain completion."""
        from ..runtime.component import STATE_MORPHING

        want = set(self._role_components(role))
        for comp in set(self._served) - want:
            await self._served.pop(comp).remove()
        for comp in want - set(self._served):
            served = await self._serve_lane(comp)
            await served.set_state(STATE_MORPHING)
            self._served[comp] = served
        if self.component in want and self._card_key is None:
            await self._register_card()
        elif self.component not in want and self._card_key is not None:
            await self._drop_card()
        await self._start_metrics()

    async def morph(self, target_role: str) -> dict:
        """Re-role this live worker. Unroutable window first (every lane
        flips to STATE_MORPHING before the drain starts, so new dials land
        on peers), then the engine state machine drains + flips + re-warms
        with `_apply_lanes` as the atomic discovery flip. On engine
        rollback the old lanes are restored routable; MorphCrash
        propagates for the pool's crash-style teardown."""
        from ..runtime import faults
        from ..runtime.component import STATE_MORPHING, STATE_READY

        assert self.engine is not None
        old_role = self.role
        if target_role == old_role:
            return {"from": old_role, "to": target_role, "drained": 0}
        await self._set_lane_states(STATE_MORPHING)
        try:
            summary = await self.engine.morph(
                target_role, on_flip=lambda: self._apply_lanes(target_role))
        except faults.MorphCrash:
            raise
        except BaseException:
            # engine rolled back to old_role (drained sessions already
            # migrating to peers); restore the old lane set routable
            await self._apply_lanes(old_role)
            await self._set_lane_states(STATE_READY)
            raise
        self.role = target_role
        await self._set_lane_states(STATE_READY)
        return summary

    async def _set_lane_states(self, state: str) -> None:
        for served in list(self._served.values()):
            await served.set_state(state)

    async def start(self) -> "InProcMockWorker":
        from ..llm.mocker import MockEngine

        self.drt = await DistributedRuntime.create(self.cfg)
        self.engine = MockEngine(self.engine_args)
        await self.engine.warmup()
        for comp in self._role_components(self.role):
            self._served[comp] = await self._serve_lane(comp)
        await self._start_metrics()
        if self.component in self._served:
            await self._register_card()
        return self

    @property
    def instance_id(self) -> int:
        assert self.drt is not None
        return self.drt.instance_id

    async def stop(self, graceful: bool = True):
        if self._metrics_pub is not None:
            await self._metrics_pub.close()
        if self.drt is not None:
            await self.drt.close(graceful=graceful)


class InProcWorkerPool:
    """PlannerConnector over in-proc mock workers, role-aware: decode
    workers serve `component` with the model card, prefill workers serve
    `prefill_component` without one, and a colocated "both" worker serves
    under both (docs/autoscaling.md "Role morphing"). Honors the same
    `planner.connector` / `worker.spawn` / `worker.kill` fault points as
    LocalProcessConnector so fault-plan soaks exercise one grammar, and
    exposes the native `morph_replicas`/`colocate` capability the
    planner's re-role arm probes for — a morph re-roles a LIVE worker via
    `InProcMockWorker.morph` instead of cold-spawning, which is exactly
    the time-to-SLA-recovery edge the soak measures (`spawn_delay_s`
    prices the cold spawn the morph avoids)."""

    def __init__(self, cfg: RuntimeConfig, engine_args, *,
                 component: str = "mocker",
                 prefill_component: str = "prefill",
                 spawn_retries: int = 3, spawn_delay_s: float = 0.0,
                 estimates=None):
        self.cfg = cfg
        self.engine_args = engine_args
        self.component = component
        self.prefill_component = prefill_component
        self.spawn_retries = spawn_retries
        self.spawn_delay_s = spawn_delay_s
        # planner.RoleEstimates (optional): reconcile() feeds it each
        # worker's stats so sched_est_{prefill,decode}_tok_s price the
        # planner's re-role decision without an HTTP scrape hop
        self.estimates = estimates
        self.workers: List[InProcMockWorker] = []
        self.scale_events: List[Tuple[float, int]] = []  # (t, decode_count)
        self.morph_events: List[Tuple[float, str, str]] = []  # (t, from, to)
        self._want: Optional[Tuple[int, int]] = None

    def count(self, role: str) -> int:
        """Workers currently covering `role` ("both" counts for each)."""
        return sum(1 for w in self.workers
                   if role in ROLE_SERVES.get(w.role, ()))

    async def _spawn(self, role: str = "decode") -> None:
        import dataclasses

        from ..runtime import faults
        from ..runtime.backoff import Backoff, retry_async

        async def start_one():
            args = (dataclasses.replace(self.engine_args, role=role)
                    if getattr(self.engine_args, "role", role) != role
                    else self.engine_args)
            w = InProcMockWorker(self.cfg, args, component=self.component,
                                 prefill_component=self.prefill_component)
            f = faults.FAULTS
            if f.enabled:
                act = await f.on("worker.spawn")  # `error` raises
                if act == "crash":
                    # worker dies before it reports ready: start, then
                    # tear down crash-style before registration counts
                    await w.start()
                    await w.stop(graceful=False)
                    raise ConnectionError("injected: worker crashed before ready")
            if self.spawn_delay_s > 0:
                # priced cold-spawn: the provisioning latency a morph of a
                # live worker does NOT pay
                await asyncio.sleep(self.spawn_delay_s)
            await w.start()
            return w

        self.workers.append(await retry_async(
            start_one, attempts=self.spawn_retries,
            backoff=Backoff.seeded("worker.spawn", base=0.05, max_delay=0.5),
            desc="in-proc worker spawn", log=logger,
        ))

    async def _stop_role(self, role: str) -> None:
        """Shed one unit of `role` capacity: retire the newest dedicated
        worker gracefully (the PR-3 drain sequence), or — if only a
        colocated worker covers the role — de-colocate by morphing it
        down to the remaining role."""
        exact = [w for w in self.workers if w.role == role]
        if exact:
            w = exact[-1]
            self.workers.remove(w)
            await w.stop(graceful=True)
            return
        colo = [w for w in self.workers if w.role == "both"]
        if colo:
            other = "decode" if role == "prefill" else "prefill"
            await self._morph_worker(colo[-1], other)
            return
        raise RuntimeError(f"no {role} worker to stop")

    async def set_replicas(self, prefill: int, decode: int,
                           frontend: Optional[int] = None) -> None:
        # `frontend` accepted and ignored: the in-proc soak runs one
        # SoakFrontend; frontend-tier scaling is exercised through
        # LocalProcessConnector(frontend_cmd=frontend_cmd(...))
        from ..runtime import faults

        f = faults.FAULTS
        if f.enabled:
            await f.on("planner.connector")  # `error` raises; planner retries
        while self.count("decode") < decode:
            await self._spawn("decode")
        while self.count("prefill") < prefill:
            await self._spawn("prefill")
        # retire colocated workers outright while BOTH roles are above
        # target (shutdown path); per-role shrink below de-colocates
        while (self.count("prefill") > prefill
               and self.count("decode") > decode):
            colo = [w for w in self.workers if w.role == "both"]
            if not colo:
                break
            w = colo[-1]
            self.workers.remove(w)
            await w.stop(graceful=True)
        while self.count("decode") > decode:
            await self._stop_role("decode")
        while self.count("prefill") > prefill:
            await self._stop_role("prefill")
        # committed only on success (same contract as LocalProcessConnector:
        # reconcile re-asserts the last SUCCESSFUL counts, never a target
        # the planner recorded as connector-error)
        self._want = (prefill, decode)
        self.scale_events.append((time.monotonic(), self.count("decode")))

    async def morph_replicas(self, from_role: str, to_role: str,
                             k: int) -> int:
        """Re-role up to k live workers from `from_role` to `to_role` —
        the planner's re-role arm. Only dedicated from_role workers are
        candidates (newest first, matching scale-down order). Commits the
        new role split to `_want` so reconcile re-asserts it."""
        from ..runtime import faults

        f = faults.FAULTS
        if f.enabled:
            await f.on("planner.connector")  # `error` raises; planner retries
        done = 0
        for _ in range(k):
            cands = [w for w in self.workers if w.role == from_role]
            if not cands:
                break
            await self._morph_worker(cands[-1], to_role)
            done += 1
        if done:
            self._want = (self.count("prefill"), self.count("decode"))
            self.scale_events.append((time.monotonic(), self.count("decode")))
        return done

    async def _morph_worker(self, w: InProcMockWorker, to_role: str) -> None:
        from ..runtime import faults

        from_role = w.role
        try:
            await w.morph(to_role)
        except faults.MorphCrash:
            # crashed mid-morph: crash-style teardown — the lease revoke
            # severs its streams onto peers through the same migration
            # machinery a SIGKILL exercises; reconcile respawns to the
            # last committed want. Surfaces to the planner as an
            # uncommitted connector error (PR-9 retry semantics).
            self.workers.remove(w)
            await w.stop(graceful=False)
            self.scale_events.append((time.monotonic(), self.count("decode")))
            raise ConnectionError("worker crashed mid-morph") from None
        self.morph_events.append((time.monotonic(), from_role, to_role))

    async def colocate(self) -> bool:
        """Fold to colocated serving at the traffic floor: morph the
        newest decode worker to "both", then gracefully retire dedicated
        prefill workers. Returns False when already colocated or nothing
        to fold."""
        if any(w.role == "both" for w in self.workers):
            return False
        decode = [w for w in self.workers if w.role == "decode"]
        if not decode:
            return False
        await self._morph_worker(decode[-1], "both")
        for w in [w for w in self.workers if w.role == "prefill"]:
            self.workers.remove(w)
            await w.stop(graceful=True)
        self._want = (self.count("prefill"), self.count("decode"))
        self.scale_events.append((time.monotonic(), self.count("decode")))
        return True

    async def reconcile(self) -> None:
        from ..runtime import faults

        f = faults.FAULTS
        if f.enabled and f.check("worker.kill") == "kill" and self.workers:
            # same `worker.kill` grammar as LocalProcessConnector: hard
            # worker death on the reconcile tick, no drain — migration
            # absorbs the severed streams, the respawn below heals
            await self.kill_one()
        if self._want is not None:
            p, d = self._want
            if self.count("prefill") < p or self.count("decode") < d:
                await self.set_replicas(p, d)
        if self.estimates is not None:
            for w in list(self.workers):
                if w.engine is not None:
                    self.estimates.observe(w.instance_id, w.engine.stats())

    async def kill_one(self, index: int = -1) -> int:
        """Crash-style teardown of one worker (no drain): the in-proc
        analog of SIGKILL, for mid-stream migration scenarios. Returns the
        killed instance id."""
        w = self.workers.pop(index)
        iid = w.instance_id
        await w.stop(graceful=False)
        self.scale_events.append((time.monotonic(), self.count("decode")))
        return iid

    async def shutdown(self) -> None:
        await self.set_replicas(0, 0)


def mocker_cmd(discovery: str, *, model_name: str = "mock-model",
               component: str = "mocker", block_size: int = 8,
               speedup_ratio: float = 2.0,
               extra: Sequence[str] = ()) -> List[str]:
    """argv template for LocalProcessConnector: a real mocker worker
    subprocess wired to the soak's discovery service."""
    return [
        sys.executable, "-m", "dynamo_tpu_torch.mocker",
        "--model-name", model_name,
        "--component", component,
        "--discovery", discovery,
        "--block-size", str(block_size),
        "--speedup-ratio", str(speedup_ratio),
        *extra,
    ]


def frontend_cmd(discovery: str, *, http_port: int,
                 router_mode: str = "round-robin",
                 extra: Sequence[str] = ()) -> List[str]:
    """argv template for LocalProcessConnector(frontend_cmd=...): one
    stateless frontend replica on the shared discovery plane. Replica i
    listens on http_port + i (the frontend offsets by DYN_WORKER_INDEX,
    docs/frontend_scaleout.md)."""
    return [
        sys.executable, "-m", "dynamo_tpu_torch.frontend",
        "--discovery", discovery,
        "--http-host", "127.0.0.1",
        "--http-port", str(http_port),
        "--router-mode", router_mode,
        *extra,
    ]


# --------------------------------------------------------------------------- #
# seeded qps ramp load
# --------------------------------------------------------------------------- #


@dataclass
class RampPhase:
    qps: float
    duration_s: float
    label: str = ""
    # per-phase shape overrides (None = RampLoad's defaults): a
    # prefill-heavy phase (big isl, small osl) flipping to a decode-heavy
    # one (small isl, big osl) is how the morph soak skews the planner's
    # per-role ask without changing total qps
    isl_chars: Optional[int] = None
    osl_tokens: Optional[int] = None


@dataclass
class StreamRecord:
    """One client stream's observation, sufficient for both SLA windows
    and the zero-lost/zero-duplicated contiguity check (the byte
    tokenizer maps one token to one character, so received characters
    count emitted stream items exactly — migration replays would inflate
    the count, drops would shrink it)."""

    phase: str
    t_send: float
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    content_tokens: int = 0
    usage_completion: Optional[int] = None
    max_tokens: int = 0
    finish_reason: Optional[str] = None
    error: Optional[str] = None
    tenant: str = ""
    # dynogate rejection (docs/overload.md): a clean 429 BEFORE any
    # stream bytes — not an error, not a contiguity problem
    rejected: bool = False
    retry_after_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        return (not self.rejected and self.error is None
                and self.finish_reason is not None)

    def ttft_ms(self) -> float:
        if self.t_first is None:
            return math.inf
        return (self.t_first - self.t_send) * 1000.0

    def contiguity_problems(self) -> List[str]:
        out = []
        if self.rejected:
            return out  # typed pre-stream rejection: nothing was promised
        if self.error is not None:
            out.append(f"error: {self.error}")
            return out
        if self.finish_reason is None:
            out.append("no finish_reason (truncated stream)")
        if self.content_tokens != self.max_tokens:
            out.append(
                f"{'lost' if self.content_tokens < self.max_tokens else 'duplicated'}"
                f" items: got {self.content_tokens}, asked {self.max_tokens}"
            )
        if self.usage_completion is not None and \
                self.usage_completion != self.content_tokens:
            out.append(
                f"usage mismatch: usage={self.usage_completion} "
                f"streamed={self.content_tokens}"
            )
        return out


async def drive_stream(session: ClientSession, base_url: str,
                       model: str, prompt: str, max_tokens: int,
                       phase: str = "", tenant: str = "",
                       priority: int = 0,
                       tenant_header: str = "x-dynamo-tenant") -> StreamRecord:
    """One streaming chat completion, recorded chunk by chunk. `tenant`
    rides the gate's tenant header and `priority` its nvext SLA class; a
    gate 429 is recorded as a clean rejection (Retry-After parsed), any
    other non-200 as an error."""
    rec = StreamRecord(phase=phase, t_send=time.monotonic(),
                       max_tokens=max_tokens, tenant=tenant)
    body = {
        "model": model,
        "messages": [{"role": "user", "content": prompt}],
        "max_tokens": max_tokens,
        "stream": True,
        "stream_options": {"include_usage": True},
    }
    if priority:
        body["nvext"] = {"priority": priority}
    headers = {tenant_header: tenant} if tenant else None
    try:
        async with session.post(
            f"{base_url}/v1/chat/completions",
            json=body,
            headers=headers,
            timeout=120,
        ) as resp:
            if resp.status == 429:
                rec.rejected = True
                try:
                    rec.retry_after_s = float(
                        resp.headers.get("Retry-After", "0"))
                except ValueError:
                    rec.retry_after_s = None
                await resp.read()
                return rec
            if resp.status != 200:
                rec.error = f"HTTP {resp.status}: {(await resp.text())[:200]}"
                return rec
            async for raw in resp.content:
                line = raw.decode("utf-8", "replace").strip()
                if not line.startswith("data:"):
                    continue
                payload = line[5:].strip()
                if payload == "[DONE]":
                    break
                chunk = json.loads(payload)
                if chunk.get("usage"):
                    rec.usage_completion = chunk["usage"]["completion_tokens"]
                for ch in chunk.get("choices", []):
                    content = (ch.get("delta") or {}).get("content")
                    if content:
                        if rec.t_first is None:
                            rec.t_first = time.monotonic()
                        rec.t_last = time.monotonic()
                        rec.content_tokens += len(content)
                    if ch.get("finish_reason"):
                        rec.finish_reason = ch["finish_reason"]
    except (ClientError, asyncio.TimeoutError, OSError) as e:
        rec.error = f"{type(e).__name__}: {e}"
    return rec


class RampLoad:
    """Seeded deterministic qps ramp: fixed inter-arrival 1/qps per phase,
    prompts varied per request index (prefix caching stays honest).
    `tenant_cycle`: optional [(tenant, priority), ...] assigned to
    requests round-robin — the deterministic multi-tenant mix the gate
    soak drives (docs/overload.md)."""

    def __init__(self, base_url: str, model: str, phases: Sequence[RampPhase],
                 *, isl_chars: int = 24, osl_tokens: int = 16, seed: int = 0,
                 tenant_cycle: Sequence[Tuple[str, int]] = ()):
        self.base_url = base_url
        self.model = model
        self.phases = list(phases)
        self.isl_chars = isl_chars
        self.osl_tokens = osl_tokens
        self.seed = seed
        self.tenant_cycle = list(tenant_cycle)
        self.records: List[StreamRecord] = []

    async def run(self) -> List[StreamRecord]:
        tasks: List[asyncio.Task] = []
        i = 0
        async with ClientSession() as session:
            for phase in self.phases:
                t_phase = time.monotonic()
                gap = 1.0 / max(phase.qps, 1e-9)
                n = max(1, int(round(phase.qps * phase.duration_s)))
                isl = phase.isl_chars if phase.isl_chars is not None \
                    else self.isl_chars
                osl = phase.osl_tokens if phase.osl_tokens is not None \
                    else self.osl_tokens
                for k in range(n):
                    at = t_phase + k * gap
                    delay = at - time.monotonic()
                    if delay > 0:
                        await asyncio.sleep(delay)
                    prompt = f"soak-{self.seed}-{i:05d} " + "x" * isl
                    tenant, priority = "", 0
                    if self.tenant_cycle:
                        tenant, priority = self.tenant_cycle[
                            i % len(self.tenant_cycle)]
                    tasks.append(asyncio.create_task(drive_stream(
                        session, self.base_url, self.model, prompt,
                        osl, phase=phase.label or f"qps{phase.qps}",
                        tenant=tenant, priority=priority,
                    )))
                    i += 1
                # hold the phase boundary even if requests lag
                tail = t_phase + phase.duration_s - time.monotonic()
                if tail > 0:
                    await asyncio.sleep(tail)
            self.records = list(await asyncio.gather(*tasks))
        return self.records


# --------------------------------------------------------------------------- #
# report helpers
# --------------------------------------------------------------------------- #


def attainment(records: Sequence[StreamRecord], ttft_slo_ms: float) -> float:
    """Fraction of records meeting the TTFT target (failures count as
    misses) — the bench_e2e `sla_fields` definition."""
    if not records:
        return 1.0
    met = [r for r in records if r.ok and r.ttft_ms() <= ttft_slo_ms]
    return len(met) / len(records)


def window_attainment(records: Sequence[StreamRecord], t0: float,
                      window_s: float, ttft_slo_ms: float
                      ) -> List[Tuple[float, float, int]]:
    """Per-window (offset_s, attainment, n) over send time — how the soak
    sees SLA degrade under the ramp and recover after scale-up."""
    if not records:
        return []
    t_end = max(r.t_send for r in records)
    out = []
    t = t0
    while t < t_end:
        win = [r for r in records if t <= r.t_send < t + window_s]
        if win:
            out.append((t - t0, attainment(win, ttft_slo_ms), len(win)))
        t += window_s
    return out


def goodput_tok_s(records: Sequence[StreamRecord], ttft_slo_ms: float,
                  window_s: Optional[float] = None) -> float:
    """SLA-attained tokens per second attributable to this offered-load
    window — the dynogate acceptance metric (docs/overload.md): tokens
    streamed by requests that finished AND met their TTFT target, over
    the window the load was OFFERED in (first to last send; pass
    `window_s` to pin it to the phase duration). Rejected/failed/late
    requests contribute zero tokens, so convoy collapse — everything
    admitted, everything late — reads as zero goodput, while clean
    shedding keeps the served slice's tokens counted."""
    if not records:
        return 0.0
    attained = [r for r in records if r.ok and r.ttft_ms() <= ttft_slo_ms]
    if window_s is None:
        t0 = min(r.t_send for r in records)
        t1 = max(r.t_send for r in records)
        window_s = max(t1 - t0, 1e-9)
    return sum(r.content_tokens for r in attained) / max(window_s, 1e-9)


def per_tenant_attainment(records: Sequence[StreamRecord],
                          ttft_slo_ms: float) -> dict:
    """TTFT attainment per tenant over SERVED streams (clean gate
    rejections are excluded: the fairness question is whether what each
    tenant WAS served met SLA, not how much of its flood was refused)."""
    served: dict = {}
    for r in records:
        if r.rejected:
            continue
        served.setdefault(r.tenant or "default", []).append(r)
    return {t: attainment(rs, ttft_slo_ms) for t, rs in served.items()}


def contiguity_report(records: Sequence[StreamRecord]) -> List[str]:
    """Flat list of per-stream contiguity violations (empty = zero lost,
    zero duplicated, every stream finished)."""
    problems = []
    for idx, r in enumerate(records):
        for p in r.contiguity_problems():
            problems.append(f"stream {idx} [{r.phase}]: {p}")
    return problems


def replica_trace(decisions) -> List[Tuple[int, int]]:
    """Applied (p, d) targets in order, deduplicated — the soak's
    scale-cycle assertion reads this."""
    out: List[Tuple[int, int]] = []
    for d in decisions:
        if d.applied and (not out or out[-1] != d.target):
            out.append(d.target)
    return out


def assert_no_flapping(decisions, cooldown_intervals: int,
                       adjustment_interval: float) -> None:
    """No A→B→A oscillation inside the cooldown window, and no two applied
    changes closer than the cooldown allows."""
    applied = [d for d in decisions if d.applied]
    for a, b in zip(applied, applied[1:]):
        gap = b.at - a.at
        min_gap = cooldown_intervals * adjustment_interval
        if gap < min_gap * 0.99:  # tolerance for loop-timing slop
            raise AssertionError(
                f"applied changes {a.target}→{b.target} only {gap:.2f}s apart "
                f"(cooldown {min_gap:.2f}s)"
            )
    for a, b, c in zip(applied, applied[1:], applied[2:]):
        if a.target == c.target and a.target != b.target and \
                c.at - a.at <= (cooldown_intervals + 1) * adjustment_interval:
            raise AssertionError(
                f"replica flap {a.target}→{b.target}→{c.target} within "
                f"the cooldown window"
            )
