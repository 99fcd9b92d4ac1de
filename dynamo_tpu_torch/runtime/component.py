"""Component model + DistributedRuntime.

Port of `dynamo_tpu/runtime/component.py`, which mirrors reference
lib/runtime: `Runtime` (lib.rs:70),
`DistributedRuntime::new` (distributed.rs:42), `Namespace` (component.rs:520)
→ `Component` (:120) → `Endpoint` (:358), live `Instance` records (:98)
written to discovery under the process's primary lease, and
`Client`/`InstanceSource` (component/client.rs:40,52) that watch instances.

Discovery layout (the reference's, so both packages' workers and frontends
share one control plane):
  v1/instances/{namespace}/{component}/{endpoint}/{instance_id} -> Instance json
  v1/mdc/{namespace}/{component}/{model-slug}                   -> ModelDeploymentCard

With `DYN_SYSTEM_ENABLED` / `DYN_SYSTEM_PORT` the runtime serves the
system-status server (`runtime/system_status.py`: /health, /live, /metrics;
the port offset by `DYN_WORKER_INDEX`, an ephemeral port when it is taken);
with `DYN_HEALTH_CHECK_ENABLED` it sends canaries to idle endpoints
(`runtime/health_check.py`) and flips /health to 503 when one fails.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
import socket
from dataclasses import dataclass, field
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

from .config import RuntimeConfig, discovery_address
from .discovery import DiscoveryClient, DiscoveryServer, Lease, Watch
from .engine import Context
from .health_check import HealthCheckManager
from .metrics import MetricsRegistry
from .request_plane import (
    EndpointStats,
    Handler,
    RequestPlaneClient,
    RequestPlaneServer,
)
from .system_status import SystemHealth, SystemStatusServer

logger = logging.getLogger(__name__)

INSTANCE_ROOT = "v1/instances/"
MODEL_ROOT = "v1/mdc/"


#: Instance lifecycle states written into the discovery record. `draining`
#: is published by the graceful-shutdown sequence the moment a worker stops
#: accepting new streams, so routers and the planner's capacity counter can
#: skip it WITHOUT waiting for the lease-revoke delete event to propagate.
#: `morphing` is the role-flip analogue (docs/autoscaling.md "Role
#: morphing"): the worker is live but mid prefill<->decode re-role — its
#: OUTGOING role stops taking new streams exactly like draining, except the
#: record flips back to `ready` (under the new component) instead of being
#: deleted.
STATE_READY = "ready"
STATE_DRAINING = "draining"
STATE_MORPHING = "morphing"

#: States a router must not pick for NEW streams: dialing either buys a
#: per-request `draining`-coded rejection (the server severs/refuses), so
#: `ready_instance_ids` filters both (the drain invariant, extended to
#: morphs).
UNROUTABLE_STATES = (STATE_DRAINING, STATE_MORPHING)


@dataclass
class Instance:
    """A live endpoint instance (reference Instance component.rs:98)."""

    namespace: str
    component: str
    endpoint: str
    instance_id: int
    address: str  # host:port of the worker's request-plane server
    subject: str  # routing subject within that server
    state: str = STATE_READY  # STATE_READY | STATE_DRAINING | STATE_MORPHING

    @property
    def path(self) -> str:
        return (
            f"{INSTANCE_ROOT}{self.namespace}/{self.component}/"
            f"{self.endpoint}/{self.instance_id:x}"
        )

    def to_json(self) -> bytes:
        return json.dumps(self.__dict__).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "Instance":
        return cls(**json.loads(raw))


class DistributedRuntime:
    """Process-wide distributed runtime: discovery client + primary lease +
    request-plane server/client (reference DistributedRuntime distributed.rs:42).

    `static_mode=True` skips discovery entirely (reference's etcd=None static
    mode) — endpoints are addressed directly by host:port.
    """

    def __init__(self, config: Optional[RuntimeConfig] = None, static_mode: bool = False):
        self.config = config or RuntimeConfig.from_settings()
        self.static_mode = static_mode
        self.instance_id = int.from_bytes(os.urandom(8), "big") >> 1
        self.discovery: Optional[DiscoveryClient] = None
        self.primary_lease: Optional[Lease] = None
        self._embedded_discovery: Optional[DiscoveryServer] = None
        self.server = RequestPlaneServer(host=self.config.request_plane_host)
        self.client = RequestPlaneClient(
            connect_timeout=self.config.request_plane_connect_timeout
        )
        self._server_started = False
        # two endpoints serving concurrently must not both start the
        # request-plane server: the loser's listening socket would leak
        # and its registrations would point at a dead port
        self._server_lock = asyncio.Lock()
        self._namespaces: Dict[str, Namespace] = {}
        self._leased_keys: Dict[str, bytes] = {}
        self._shutdown = asyncio.Event()
        self.etcd_root = ""  # prefix for multi-tenant stores (unused for now)
        # observability (reference: MetricsRegistry root on the DRT lib.rs:92,
        # SystemHealth, HealthCheckManager)
        self.metrics = MetricsRegistry()
        self.system_health = SystemHealth()
        self.system_status_server: Optional[SystemStatusServer] = None
        self.health_check_manager: Optional[HealthCheckManager] = None
        if self.config.health_check_enabled:
            self.health_check_manager = HealthCheckManager(
                self, self.system_health,
                idle_timeout=self.config.health_check_idle_timeout,
                request_timeout=self.config.health_check_request_timeout,
            )

    @classmethod
    async def create(
        cls,
        config: Optional[RuntimeConfig] = None,
        static_mode: bool = False,
        embed_discovery: bool = False,
    ) -> "DistributedRuntime":
        """Connect to (or embed) the discovery service and grant the primary
        lease. With embed_discovery, this process hosts the control plane —
        typically the frontend does this when no external one is running."""
        drt = cls(config, static_mode)
        if not static_mode:
            host, port = discovery_address(drt.config)
            if embed_discovery:
                drt._embedded_discovery = DiscoveryServer(host="0.0.0.0", port=port)
                try:
                    await drt._embedded_discovery.start()
                except OSError:
                    drt._embedded_discovery = None  # someone else already runs it
            drt.discovery = await DiscoveryClient.connect(host, port)
            drt.primary_lease = await drt.discovery.grant_lease(
                ttl=drt.config.lease_ttl_s
            )
            drt.primary_lease.on_lost = drt._republish_leased_keys
        if drt.config.system_enabled:
            port = drt.config.system_port
            if port > 0:
                # replicas started from one template offset the port by
                # their index so co-located ones do not collide
                port += int(os.environ.get("DYN_WORKER_INDEX") or 0)
            drt.system_status_server = SystemStatusServer(
                drt.system_health, drt.metrics, host=drt.config.system_host, port=port)
            try:
                await drt.system_status_server.start()
            except OSError:
                # a taken port degrades the scrape, never the replica
                logger.warning("system-status port %d already taken; serving metrics "
                               "on an ephemeral port instead", port)
                drt.system_status_server = SystemStatusServer(
                    drt.system_health, drt.metrics, host=drt.config.system_host, port=0)
                await drt.system_status_server.start()
        if drt.health_check_manager is not None:
            drt.health_check_manager.start()
        return drt

    async def _republish_leased_keys(self, lease):
        """The primary lease expired (event loop stalled past TTL, e.g. long
        XLA compile) and was re-granted: restore every registration."""
        for key, value in list(self._leased_keys.items()):
            try:
                await self.discovery.put(key, value, lease)
            except (ConnectionError, RuntimeError):
                logger.warning("failed to re-publish %s after lease re-grant", key)

    async def put_leased(self, key: str, value: bytes):
        """Put a key under the primary lease and remember it so it survives
        lease re-grants."""
        self._leased_keys[key] = value
        if self.discovery is not None:
            await self.discovery.put(key, value, self.primary_lease)

    async def _mark_instances_draining(self):
        """Re-publish every served Instance record with state=`draining`
        BEFORE the lease revoke deletes it: watch consumers (PushRouter,
        planner capacity counts) see the put immediately, closing the
        window where a router still dials a worker that will only answer
        with a `draining` rejection."""
        if self.discovery is None:
            return
        for key, value in list(self._leased_keys.items()):
            if not key.startswith(INSTANCE_ROOT):
                continue
            try:
                inst = Instance.from_json(value)
                inst.state = STATE_DRAINING
                await self.discovery.put(key, inst.to_json(), self.primary_lease)
            except (ConnectionError, RuntimeError, ValueError, TypeError):
                pass  # best-effort: the revoke delete is the authority

    def install_signal_handlers(self):
        """SIGTERM/SIGINT trigger the graceful-shutdown sequence instead of
        the interpreter's default hard exit — this is what turns a planner
        scale-down (`LocalProcessConnector._kill` sends SIGTERM) into the
        drain path (mark draining → revoke lease → finish in-flight) rather
        than a mid-stream kill that every live request pays for."""
        import signal

        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                loop.add_signal_handler(sig, self.shutdown)
            except (NotImplementedError, RuntimeError):
                return  # platform without signal support (or non-main thread)

    async def ensure_server(self) -> str:
        """Start the request-plane server on first use; returns host:port."""
        async with self._server_lock:
            if not self._server_started:
                await self.server.start()
                self._server_started = True
        host = self.server.host
        if host in ("0.0.0.0", "::"):
            host = socket.gethostbyname(socket.gethostname())
        return f"{host}:{self.server.port}"

    def namespace(self, name: str) -> "Namespace":
        ns = self._namespaces.get(name)
        if ns is None:
            ns = Namespace(self, name)
            self._namespaces[name] = ns
        return ns

    def shutdown(self):
        self._shutdown.set()

    async def wait_for_shutdown(self):
        await self._shutdown.wait()

    async def close(self, graceful: bool = True):
        """Shutdown with the drain sequence the reference's graceful-
        shutdown contract requires (DYN_RUNTIME_GRACEFUL_SHUTDOWN_TIMEOUT):

          1. revoke the primary lease — instance keys vanish, routers stop
             picking this process for NEW requests;
          2. stop accepting new streams (listening socket closes, races
             that already hold our address get a `draining` rejection they
             treat as StreamLost);
          3. drain in-flight streams within the graceful timeout;
          4. force-cancel survivors.

        `graceful=False` skips 2-3 (crash-style teardown, used by tests
        that simulate worker death)."""
        self._shutdown.set()
        if self.health_check_manager is not None:
            await self.health_check_manager.stop()
        if graceful:
            await self._mark_instances_draining()
        if self.primary_lease is not None:
            await self.primary_lease.revoke()
        if graceful and self._server_started:
            drained = await self.server.drain(self.config.graceful_shutdown_timeout)
            if not drained:
                logger.warning(
                    "graceful drain timed out after %.1fs; force-cancelling %d stream(s)",
                    self.config.graceful_shutdown_timeout,
                    self.server.active_streams,
                )
        if self.system_status_server is not None:
            await self.system_status_server.stop()
        await self.client.close()
        await self.server.stop()
        if self.discovery is not None:
            await self.discovery.close()
        if self._embedded_discovery is not None:
            await self._embedded_discovery.stop()


class Namespace:
    """Logical grouping of components (reference component.rs:520)."""

    def __init__(self, drt: DistributedRuntime, name: str):
        self.drt = drt
        self.name = name

    def component(self, name: str) -> "Component":
        return Component(self.drt, self.name, name)


class Component:
    """A deployable service unit within a namespace (reference component.rs:120)."""

    def __init__(self, drt: DistributedRuntime, namespace: str, name: str):
        self.drt = drt
        self.namespace = namespace
        self.name = name

    def endpoint(self, name: str) -> "Endpoint":
        return Endpoint(self, name)

    async def create_service(self):
        """No-op placeholder for service-level registration; instances are
        registered per-endpoint at serve time (matches reference semantics
        where the NATS service is created lazily)."""
        return self

    @property
    def path(self) -> str:
        return f"{self.namespace}/{self.name}"


class Endpoint:
    """A named, servable function on a component (reference component.rs:358)."""

    def __init__(self, component: Component, name: str):
        self.component = component
        self.name = name

    @property
    def drt(self) -> DistributedRuntime:
        return self.component.drt

    @property
    def subject(self) -> str:
        return f"{self.component.namespace}.{self.component.name}.{self.name}"

    @property
    def path(self) -> str:
        return f"{self.component.path}/{self.name}"

    async def serve_endpoint(
        self,
        handler: Handler,
        *,
        metrics_labels: Optional[dict] = None,
        graceful: bool = True,
    ) -> "ServedEndpoint":
        """Register the handler on the process request-plane server and write
        the Instance record under the primary lease
        (reference serve_endpoint bindings lib.rs:641 → Ingress)."""
        drt = self.drt
        address = await drt.ensure_server()
        stats = drt.server.register(self.subject, handler)
        instance = Instance(
            namespace=self.component.namespace,
            component=self.component.name,
            endpoint=self.name,
            instance_id=drt.instance_id,
            address=address,
            subject=self.subject,
        )
        await drt.put_leased(instance.path, instance.to_json())
        logger.info("serving endpoint %s at %s (instance %x)", self.subject, address, instance.instance_id)
        return ServedEndpoint(self, instance, stats)

    async def client(self) -> "Client":
        client = Client(self)
        await client.start()
        return client

    def instance_prefix(self) -> str:
        return f"{INSTANCE_ROOT}{self.component.namespace}/{self.component.name}/{self.name}/"


class ServedEndpoint:
    def __init__(self, endpoint: Endpoint, instance: Instance, stats: EndpointStats):
        self.endpoint = endpoint
        self.instance = instance
        self.stats = stats

    async def remove(self):
        drt = self.endpoint.drt
        drt.server.unregister(self.endpoint.subject)
        drt._leased_keys.pop(self.instance.path, None)
        if drt.discovery is not None:
            await drt.discovery.delete(self.instance.path)

    async def set_state(self, state: str):
        """Re-publish this instance's discovery record with a new lifecycle
        state under the same primary lease. The role-morph sequence uses
        this to flip ready -> morphing before the drain (watch consumers
        stop routing new streams here immediately) and morphing -> ready on
        rollback — same put-before-authority discipline as
        `_mark_instances_draining`."""
        drt = self.endpoint.drt
        self.instance.state = state
        await drt.put_leased(self.instance.path, self.instance.to_json())


class Client:
    """Endpoint client with a live instance list
    (reference Client/InstanceSource component/client.rs:40,52).

    Watches the discovery prefix for this endpoint; `instances` is kept
    current as workers come and go.
    """

    def __init__(self, endpoint: Endpoint):
        self.endpoint = endpoint
        self.instances: Dict[int, Instance] = {}
        self._watch: Optional[Watch] = None
        self._watch_task: Optional[asyncio.Task] = None
        self._instances_event = asyncio.Event()
        self._default_router = None  # lazy PushRouter for .generate()
        self._closed = False

    async def start(self):
        drt = self.endpoint.drt
        if drt.discovery is None:
            return
        self._watch = await drt.discovery.watch_prefix(self.endpoint.instance_prefix())
        self._load_snapshot(self._watch.snapshot)
        self._watch_task = asyncio.create_task(self._watch_loop())

    def _load_snapshot(self, snapshot):
        """Reconcile the full instance set from a watch snapshot — on a
        re-watch this REPLACES the map, dropping instances that died while
        the watch was down (their deletes were never delivered)."""
        fresh = {}
        for item in snapshot:
            inst = Instance.from_json(item["value"])
            fresh[inst.instance_id] = inst
        self.instances.clear()
        self.instances.update(fresh)
        if self.instances:
            self._instances_event.set()
        else:
            self._instances_event.clear()

    async def _watch_loop(self):
        from .backoff import Backoff

        assert self._watch is not None
        # stable seed: re-watch timing reproduces across chaos re-runs
        backoff = Backoff.seeded(self.endpoint.subject, base=0.05, max_delay=1.0)
        while not self._closed:
            async for event in self._watch:
                backoff.reset()
                if event.type == "put":
                    inst = Instance.from_json(event.value)
                    self.instances[inst.instance_id] = inst
                    self._instances_event.set()
                elif event.type == "delete":
                    iid = int(event.key.rsplit("/", 1)[-1], 16)
                    self.instances.pop(iid, None)
                    if not self.instances:
                        self._instances_event.clear()
            # the watch ended without cancel(): the discovery connection
            # died. Reconnect + re-watch with backoff — the live instance
            # list is this client's routing authority and must not silently
            # freeze at its last state.
            drt = self.endpoint.drt
            while not self._closed:
                await backoff.wait()
                if not await drt.discovery.ensure_connected():
                    if drt.discovery._closed:
                        return  # runtime shut down under us — nothing to watch
                    continue
                try:
                    self._watch = await drt.discovery.watch_prefix(
                        self.endpoint.instance_prefix()
                    )
                except ConnectionError:
                    continue
                self._load_snapshot(self._watch.snapshot)
                logger.info(
                    "re-watching %s after discovery reconnect (%d instance(s))",
                    self.endpoint.instance_prefix(), len(self.instances),
                )
                break

    def instance_ids(self) -> List[int]:
        return sorted(self.instances.keys())

    def ready_instance_ids(self) -> List[int]:
        """Instances eligible for NEW streams: excludes workers whose
        discovery record is in `draining` state (scale-down in progress)
        or `morphing` state (live role flip in progress — the outgoing
        role's record is about to move under another component) — dialing
        either only buys a per-request rejection."""
        return sorted(
            iid for iid, inst in self.instances.items()
            if inst.state not in UNROUTABLE_STATES
        )

    async def wait_for_instances(self, timeout: float = 30.0) -> List[int]:
        """Block until at least one instance is live (reference
        wait_for_instances semantics used by workers at startup)."""
        await asyncio.wait_for(self._instances_event.wait(), timeout)
        return self.instance_ids()

    def add_static_instance(self, address: str, subject: Optional[str] = None, instance_id: int = 0):
        """Static mode: seed a fixed instance without discovery."""
        inst = Instance(
            namespace=self.endpoint.component.namespace,
            component=self.endpoint.component.name,
            endpoint=self.endpoint.name,
            instance_id=instance_id,
            address=address,
            subject=subject or self.endpoint.subject,
        )
        self.instances[inst.instance_id] = inst  # static mode: no watch task owns the map
        self._instances_event.set()

    async def direct(self, request: Any, instance_id: int, context: Optional[Context] = None):
        """Send to a specific instance (reference RouterMode::Direct)."""
        inst = self.instances.get(instance_id)
        if inst is None:
            from .request_plane import StreamLost

            raise StreamLost(f"instance {instance_id:x} not found for {self.endpoint.subject}")
        if context is not None:
            # migration reads this on StreamLost to exclude the corpse
            # from the retry's re-route (docs/fault_tolerance.md)
            context.routed_instance = int(instance_id)
        return await self.endpoint.drt.client.call(inst.address, inst.subject, request, context)

    async def generate(self, request: Any, context: Optional[Context] = None):
        """Round-robin convenience (full routing lives in PushRouter)."""
        from .push_router import PushRouter, RouterMode

        if self._default_router is None:
            self._default_router = PushRouter(self, RouterMode.ROUND_ROBIN)
        return await self._default_router.generate(request, context)

    async def close(self):
        self._closed = True
        if self._watch_task:
            self._watch_task.cancel()
        if self._watch:
            await self._watch.cancel()
