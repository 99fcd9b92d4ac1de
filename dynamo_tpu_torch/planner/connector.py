"""Planner connectors: turn a replica decision into actual scaling.

Port of `dynamo_tpu/planner/connector.py`. Reference equivalents:
`KubernetesConnector` patches a DynamoGraphDeployment CRD
(components/planner/src/dynamo/planner/kubernetes_connector.py) and
`VirtualConnector` publishes the decision to etcd for an external
orchestrator (virtual_connector.py). Here:

* ``VirtualConnector`` writes the decision to the discovery service KV
  (``v1/planner/decision``) with a monotonically increasing revision —
  any orchestrator (k8s operator, slice manager) watches and acts.
* ``LocalProcessConnector`` scales real worker subprocesses on this host
  (the test/e2e orchestrator, reference's ManagedProcess-style role).
* ``NoopConnector`` records decisions (dryrun / unit tests).
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import signal
import sys
import time
from typing import Awaitable, Callable, Dict, List, Optional, Sequence, Tuple

from ..runtime import faults
from ..runtime.backoff import Backoff, retry_async

logger = logging.getLogger(__name__)

PLANNER_DECISION_KEY = "v1/planner/decision"


class NoopConnector:
    def __init__(self):
        self.decisions: List[Tuple[int, int]] = []
        self.frontend_decisions: List[int] = []

    async def set_replicas(self, prefill: int, decode: int,
                           frontend: Optional[int] = None) -> None:
        self.decisions.append((prefill, decode))
        if frontend is not None:
            self.frontend_decisions.append(frontend)


class NoopMorphConnector(NoopConnector):
    """NoopConnector that also exposes the role-morph capability surface
    (morph_replicas / colocate), recording calls — the planner's re-role
    arm activates only on connectors with these attributes, so the plain
    Noop keeps legacy tests' decision logs byte-stable."""

    def __init__(self):
        super().__init__()
        self.morphs: List[Tuple[str, str, int]] = []
        self.colocations = 0

    async def morph_replicas(self, from_role: str, to_role: str, k: int) -> int:
        f = faults.FAULTS
        if f.enabled:
            await f.on("planner.connector")  # `error` raises; planner retries
        self.morphs.append((from_role, to_role, k))
        return k

    async def colocate(self) -> bool:
        self.colocations += 1
        return True


class VirtualConnector:
    """Publish {num_prefill, num_decode, revision} to discovery KV.
    Revisions continue from whatever is already stored, so they stay
    monotonic across planner restarts."""

    def __init__(self, discovery_client):
        self.client = discovery_client
        self.revision: Optional[int] = None
        # two concurrent publishers would both lazy-load, both increment,
        # and ship duplicate revision numbers — which the revision-gated
        # consumers (operator-lite) silently skip
        self._rev_lock = asyncio.Lock()

    async def _load_revision(self) -> int:
        raw = await self.client.get(PLANNER_DECISION_KEY)
        if raw:
            try:
                return int(json.loads(raw).get("revision", 0))
            except (ValueError, TypeError, AttributeError, json.JSONDecodeError):
                pass  # malformed stored doc: restart revisions from 0
        return 0

    async def set_replicas(self, prefill: int, decode: int,
                           frontend: Optional[int] = None) -> None:
        f = faults.FAULTS
        if f.enabled:
            await f.on("planner.connector")  # `error` raises; planner retries
        async with self._rev_lock:
            if self.revision is None:
                self.revision = await self._load_revision()
            self.revision += 1
            doc = {
                "num_prefill_workers": prefill,
                "num_decode_workers": decode,
                "revision": self.revision,
                "ts": time.time(),
            }
            if frontend is not None:
                # frontend role (docs/frontend_scaleout.md): stateless
                # replicas over shared discovery, scaled like workers.
                # Absent = orchestrators leave the frontend tier alone.
                doc["num_frontends"] = frontend
            await self.client.put(PLANNER_DECISION_KEY, json.dumps(doc).encode())
            logger.info("published planner decision rev=%d p=%d d=%d f=%s",
                        self.revision, prefill, decode, frontend)


class LocalProcessConnector:
    """Scale worker replicas as local subprocesses.

    `prefill_cmd` / `decode_cmd` are argv templates; each spawned replica
    gets the env of the parent plus DYN_WORKER_INDEX. Scaling down kills
    the newest replicas first (SIGTERM → the worker's graceful drain;
    SIGKILL after grace).

    Robustness contract (exercised by the `worker.spawn` fault point and
    the planner soak): a failed exec or a child that dies before reporting
    ready is retried with seeded backoff, bounded by `spawn_retries` per
    set_replicas call — and because the planner re-asserts its target via
    `reconcile()` every interval, even an exhausted budget never strands
    the replica count. With `ready_fn` set (an async `(role) -> int` of
    READY replicas, e.g. `DiscoveryWorkerCounts` — which excludes draining
    workers and, because workers register only after warmup, counts a
    fresh replica only once its warmup gate passed), scale-up additionally
    waits up to `ready_timeout` for the new capacity to actually appear,
    respawning children that died in the window.

    The replica counts given to set_replicas are the connector's OWN
    child-process counts. Workers of the same component managed outside
    the connector still count in `ready_fn`'s discovery-wide number —
    point the planner's `DiscoveryWorkerCounts` at a component only this
    connector manages, or the fleet runs `want + external` replicas.
    """

    def __init__(
        self,
        prefill_cmd: Sequence[str],
        decode_cmd: Sequence[str],
        env: Optional[Dict[str, str]] = None,
        grace_s: float = 5.0,
        spawn_retries: int = 3,
        ready_fn: Optional[Callable[[str], Awaitable[int]]] = None,
        ready_timeout: float = 30.0,
        frontend_cmd: Sequence[str] = (),
        morph_fn: Optional[Callable[[str, str], Awaitable[None]]] = None,
    ):
        self.prefill_cmd = list(prefill_cmd)
        self.decode_cmd = list(decode_cmd)
        # frontend role (docs/frontend_scaleout.md): stateless replicas of
        # `python -m dynamo_tpu_torch.frontend` — each child's DYN_WORKER_INDEX
        # offsets its HTTP/gRPC/metrics ports, so one argv template serves
        # the whole tier. Readiness gating is skipped for this role:
        # frontends register no worker Instance records, so ready_fn's
        # discovery count cannot see them (their liveness check is the
        # alive-children reap + the next reconcile).
        self.frontend_cmd = list(frontend_cmd)
        self.env = env
        self.grace_s = grace_s
        self.spawn_retries = spawn_retries
        self.ready_fn = ready_fn
        self.ready_timeout = ready_timeout
        self.procs: Dict[str, List[asyncio.subprocess.Process]] = {
            "prefill": [],
            "decode": [],
            "frontend": [],
        }
        self._cmds = {
            "prefill": self.prefill_cmd,
            "decode": self.decode_cmd,
            "frontend": self.frontend_cmd,
        }
        # role morphing (docs/autoscaling.md "Role morphing"): an async
        # `(from_role, to_role)` hook that re-roles ONE live worker of
        # from_role (e.g. by calling the worker's morph control endpoint).
        # None = capability absent; the planner's getattr probe then keeps
        # its re-role arm dark and cold-spawns as before.
        self.morph_fn = morph_fn
        if morph_fn is None:
            # capability surface: the planner probes getattr(connector,
            # "morph_replicas") — shadow the method with None when no hook
            # exists, so a hookless connector keeps the re-role arm dark
            self.morph_replicas = None
        # last asked (p, d, f); f None = frontend tier never asked
        self._want: Optional[Tuple[int, int, Optional[int]]] = None

    def counts(self) -> Tuple[int, int]:
        self._reap()
        return len(self.procs["prefill"]), len(self.procs["decode"])

    def frontend_count(self) -> int:
        self._reap()
        return len(self.procs["frontend"])

    def _reap(self) -> None:
        for role in self.procs:
            self.procs[role] = [p for p in self.procs[role] if p.returncode is None]

    def _next_index(self, role: str) -> int:
        """Smallest index not held by a LIVE replica: a kill-then-respawn
        reuses the dead slot's index (ports/names derived from it stay
        stable), and never collides with a living replica's — `len(procs)`
        would hand a churn replacement a duplicate of the survivor's."""
        used = {getattr(p, "_dyn_worker_index", i)
                for i, p in enumerate(self.procs[role])}
        idx = 0
        while idx in used:
            idx += 1
        return idx

    async def _spawn(self, role: str) -> None:
        cmd = self._cmds[role]
        env = dict(os.environ if self.env is None else self.env)
        index = self._next_index(role)
        env["DYN_WORKER_INDEX"] = str(index)
        act = None
        f = faults.FAULTS
        if f.enabled:
            act = await f.on("worker.spawn")  # `error` raises FaultError
        proc = await asyncio.create_subprocess_exec(*cmd, env=env)
        if act == "crash":
            # the child dies before it ever reports ready — the readiness
            # wait (or the next reconcile) must replace it
            proc.kill()
        proc._dyn_worker_index = index
        self.procs[role].append(proc)
        logger.info("spawned %s worker pid=%d index=%d", role, proc.pid, index)

    async def _spawn_with_retry(self, role: str, backoff: Backoff) -> bool:
        try:
            await retry_async(
                lambda: self._spawn(role),
                attempts=self.spawn_retries, backoff=backoff,
                desc=f"spawn {role}", log=logger,
            )
            return True
        except asyncio.CancelledError:
            raise
        except Exception:  # noqa: BLE001 — exhausted; caller decides
            return False

    async def _wait_ready(self, role: str, want: int, backoff: Backoff) -> None:
        """Block until the asked capacity is actually up: all `want` managed
        children ALIVE (a child that died before ready is replaced in the
        window, bounded by the spawn-retry budget) AND `ready_fn(role)`
        reporting at least `want` registered replicas. Bounded by
        ready_timeout so a crash-looping worker can't wedge the loop.

        The alive check is authoritative for the connector's OWN children —
        `ready_fn` typically counts discovery-wide capacity, and in a mixed
        deployment (externally-managed workers of the same component) its
        count alone could mask a dead child; see the class docstring."""
        if self.ready_fn is None:
            return
        deadline = time.monotonic() + self.ready_timeout
        respawns = 0
        while time.monotonic() < deadline:
            self._reap()
            if len(self.procs[role]) < want:
                # a child died before reporting ready: replace it in the
                # window instead of waiting a whole adjustment interval
                if respawns >= max(1, self.spawn_retries):
                    logger.error(
                        "%s replica died before ready %d time(s); giving up "
                        "this interval (reconcile retries)", role, respawns,
                    )
                    return
                respawns += 1
                logger.warning(
                    "%s replica died before ready; respawning (%d/%d)",
                    role, respawns, self.spawn_retries,
                )
                await self._spawn_with_retry(role, backoff)
                continue
            try:
                ready = await self.ready_fn(role)
            except Exception as e:  # noqa: BLE001 — readiness probe is advisory
                logger.warning("ready_fn(%s) failed: %s", role, e)
                ready = 0
            if ready >= want:
                return
            await asyncio.sleep(0.1)
        logger.warning("%s capacity not ready within %.1fs", role, self.ready_timeout)

    async def _kill(self, role: str) -> None:
        proc = self.procs[role].pop()
        if proc.returncode is not None:
            return
        proc.send_signal(signal.SIGTERM)
        try:
            await asyncio.wait_for(proc.wait(), timeout=self.grace_s)
        except asyncio.TimeoutError:
            proc.kill()
            await proc.wait()
        logger.info("stopped %s worker pid=%d", role, proc.pid)

    async def kill_one(self, role: Optional[str] = None) -> Optional[int]:
        """SIGKILL one live managed replica with NO drain — hard worker
        death (the `worker.kill` fault point's action and the soak
        harness's crash arm). The corpse stays in `procs` until the next
        `_reap`/`reconcile`, exactly like a real crash: its lease lingers
        until TTL, in-flight streams sever, and migration must absorb it.
        Returns the killed pid, or None when no live replica exists."""
        roles = [role] if role else ["decode", "prefill"]
        for r in roles:
            for proc in reversed(self.procs.get(r, [])):
                if proc.returncode is None:
                    proc.kill()  # SIGKILL: no SIGTERM, no grace, no drain
                    logger.warning(
                        "worker.kill: SIGKILLed %s worker pid=%d (no drain)",
                        r, proc.pid,
                    )
                    await proc.wait()
                    return proc.pid
        return None

    async def morph_replicas(self, from_role: str, to_role: str,
                             k: int) -> int:
        """Re-role k live managed replicas via the morph hook (shadowed
        to None when no hook was configured). Each success moves
        the replica's bookkeeping between role lists and commits `_want`
        one worker at a time — a failure mid-batch raises with the
        completed morphs already committed, so reconcile re-asserts counts
        that match physical reality and the planner re-decides."""
        f = faults.FAULTS
        if f.enabled:
            await f.on("planner.connector")  # `error` raises; planner retries
        self._reap()
        done = 0
        for _ in range(k):
            if not self.procs[from_role]:
                break
            await self.morph_fn(from_role, to_role)
            proc = self.procs[from_role].pop()
            # re-slot under the new role: bookkeeping indexes are per-role
            # (the child's own DYN_WORKER_INDEX env is fixed at spawn; the
            # hook is responsible for any port/name re-derivation)
            proc._dyn_worker_index = self._next_index(to_role)
            self.procs[to_role].append(proc)
            if self._want is not None:
                p, d, fr = self._want
                p += (1 if to_role == "prefill" else 0) - (
                    1 if from_role == "prefill" else 0)
                d += (1 if to_role == "decode" else 0) - (
                    1 if from_role == "decode" else 0)
                self._want = (p, d, fr)
            done += 1
            logger.info("morphed %s worker pid=%d -> %s",
                        from_role, proc.pid, to_role)
        return done

    async def set_replicas(self, prefill: int, decode: int,
                           frontend: Optional[int] = None) -> None:
        f = faults.FAULTS
        if f.enabled:
            await f.on("planner.connector")  # `error` raises; planner retries
        self._reap()
        backoff = Backoff.seeded("worker.spawn", base=0.05, max_delay=1.0)
        roles = [("prefill", prefill), ("decode", decode)]
        if frontend is not None:
            roles.append(("frontend", frontend))
        for role, want in roles:
            if not self._cmds[role]:
                continue  # role not managed here (e.g. decode-only soak)
            grew = False
            while len(self.procs[role]) < want:
                if not await self._spawn_with_retry(role, backoff):
                    raise RuntimeError(
                        f"could not spawn {role} replica after "
                        f"{self.spawn_retries} attempts"
                    )
                grew = True
            while len(self.procs[role]) > want:
                await self._kill(role)
            if grew and role != "frontend":
                # frontends register no Instance records — ready_fn's
                # discovery count cannot gate them (class docstring)
                await self._wait_ready(role, want, backoff)
        # committed only on SUCCESS: the planner treats a raised
        # set_replicas as uncommitted and holds its own target, so
        # reconcile() must keep re-asserting the LAST SUCCESSFUL counts —
        # advancing _want on a failed apply would let reconcile grow the
        # fleet past what the planner believes exists (and any partial
        # spawns from the failed attempt are culled by the next
        # reconcile's kill-down to the old counts)
        if frontend is None and self._want is not None:
            frontend = self._want[2]  # an unasked tier keeps its target
        self._want = (prefill, decode, frontend)

    async def reconcile(self) -> None:
        """Re-assert the last committed replica counts: respawn replicas
        that died since (the planner calls this every interval)."""
        if self._want is None:
            return
        f = faults.FAULTS
        if f.enabled and f.check("worker.kill") == "kill":
            # dynochaos `worker.kill`: SIGKILL a live replica with no
            # drain on this tick — the respawn below is the recovery
            # path under test, migration absorbs the severed streams
            await self.kill_one()
        p, d, fr = self._want
        self._reap()
        dead = [
            (role, want, len(self.procs[role]))
            for role, want, cmd in (
                ("prefill", p, self.prefill_cmd),
                ("decode", d, self.decode_cmd),
                ("frontend", fr or 0, self.frontend_cmd),
            )
            # only roles this connector actually manages can "die" on it
            if cmd and want is not None and len(self.procs[role]) < want
        ]
        if dead:
            logger.warning(
                "reconcile: replica(s) died: %s",
                ", ".join(f"{r}: have {h}, want {w}" for r, w, h in dead),
            )
        await self.set_replicas(p, d, frontend=fr)

    async def shutdown(self) -> None:
        await self.set_replicas(
            0, 0, frontend=0 if self.frontend_cmd else None
        )


class DiscoveryWorkerCounts:
    """Count READY worker instances from discovery (reference
    get_workers_info, planner_core.py:180-219).

    Two gates make this the planner's capacity truth: workers register in
    discovery only AFTER their warmup/health gate passes (so a freshly
    spawned replica never counts early), and instances in any unroutable
    state — `draining` (scale-down in progress) or `morphing` (role flip
    in progress) — are excluded (so capacity being shed or mid-flip never
    counts in either role).

    A worker counts once however many endpoints it serves: a prefill or
    decode worker registers its `generate` and its `morph` endpoint under
    one instance id. (The reference counts records, so each such worker
    counts twice there; a worker with one endpoint, as the mocker, counts
    the same in both.)"""

    def __init__(self, discovery_client, namespace: str = "dynamo",
                 prefill_component: str = "prefill", decode_component: str = "backend"):
        self.client = discovery_client
        self.namespace = namespace
        self.prefill_component = prefill_component
        self.decode_component = decode_component

    async def count(self) -> Tuple[int, int]:
        from ..runtime.component import INSTANCE_ROOT, UNROUTABLE_STATES

        items = await self.client.get_prefix(INSTANCE_ROOT + self.namespace + "/")
        seen = set()
        n_p = n_d = 0
        for it in items:
            key = it["key"] if isinstance(it, dict) else it[0]
            value = it.get("value", b"") if isinstance(it, dict) else it[1]
            try:
                if json.loads(value).get("state") in UNROUTABLE_STATES:
                    continue
            except (ValueError, TypeError, AttributeError):
                pass  # unparseable record: count it (legacy writers)
            parts = key[len(INSTANCE_ROOT):].split("/")
            comp = parts[1]
            if (comp, parts[-1]) in seen:
                continue  # another endpoint of a worker already counted
            seen.add((comp, parts[-1]))
            if comp == self.prefill_component:
                n_p += 1
            elif comp == self.decode_component:
                n_d += 1
        return n_p, n_d

    def ready_fn(self) -> Callable[[str], Awaitable[int]]:
        """Adapter for LocalProcessConnector(ready_fn=...): per-role READY
        replica count."""

        async def ready(role: str) -> int:
            p, d = await self.count()
            return p if role == "prefill" else d

        return ready
