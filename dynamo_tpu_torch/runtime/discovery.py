"""Built-in discovery / KV-store service: the control-plane "etcd".

Port of `dynamo_tpu/runtime/discovery.py`, the same protocol on the same
codec, so a port worker registers on a reference discovery server and a
reference frontend on the port's. It offers

  * a revisioned key-value store (put / get / get_prefix / delete)
  * atomic create (fails if the key exists — reference `kv_create`)
  * leases with TTL + keepalive; lease death deletes attached keys
  * prefix watches streaming PUT/DELETE events (reference kv_watch_prefix)
  * topic publish/subscribe (KV events, worker metrics)
  * distributed locks built on atomic-create + lease

It can run standalone (`python -m dynamo_tpu_torch.runtime.discovery`) or
embedded in a process (`DistributedRuntime.create(embed_discovery=True)`).
Protocol: two-part frames (codec.py), multiplexed by `req_id`; watch events
are server-pushed with a `watch_id`.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from . import codec, faults
from .backoff import Backoff
from .codec import (
    OP_CREATE,
    OP_DELETE,
    OP_DELETE_PREFIX,
    OP_GET,
    OP_GET_PREFIX,
    OP_LEASE_GRANT,
    OP_LEASE_KEEPALIVE,
    OP_LEASE_REVOKE,
    OP_PUBLISH,
    OP_PUT,
    OP_STATUS,
    OP_SUBSCRIBE,
    OP_UNSUBSCRIBE,
    OP_UNWATCH,
    OP_WATCH,
    PUSH_MSG,
    PUSH_WATCH,
)

logger = logging.getLogger(__name__)

PUT = "put"
DELETE = "delete"


# --------------------------------------------------------------------------- #
# Server
# --------------------------------------------------------------------------- #


@dataclass
class _KeyRecord:
    value: bytes
    lease_id: int
    create_revision: int
    mod_revision: int


@dataclass
class _Lease:
    lease_id: int
    ttl: float
    deadline: float
    keys: set = field(default_factory=set)


@dataclass
class _Watcher:
    watch_id: int
    prefix: str
    writer: asyncio.StreamWriter


class DiscoveryServer:
    """In-process etcd-role server. State is in-memory; durability is not a
    goal (the reference treats etcd state as lease-scoped soft state too)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._kv: Dict[str, _KeyRecord] = {}
        self._leases: Dict[int, _Lease] = {}
        self._watchers: Dict[int, _Watcher] = {}
        self._revision = 0
        self._lease_ids = itertools.count(1)
        self._watch_ids = itertools.count(1)
        self._server: Optional[asyncio.base_events.Server] = None
        self._reaper: Optional[asyncio.Task] = None
        self._connections: set[asyncio.StreamWriter] = set()
        self._subs: Dict[str, List[_Watcher]] = {}  # topic -> subscribers
        self._subs_by_id: Dict[int, _Watcher] = {}

    # -- lifecycle ---------------------------------------------------------- #

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._serve_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._reaper = asyncio.create_task(self._reap_leases())
        logger.info("discovery server listening on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self):
        if self._reaper:
            self._reaper.cancel()
        if self._server:
            self._server.close()
        # close live connections, else wait_closed() blocks on their handlers
        for writer in list(self._connections):
            writer.close()
        if self._server:
            await self._server.wait_closed()

    async def _reap_leases(self):
        while True:
            await asyncio.sleep(0.5)
            now = time.monotonic()
            dead = [l for l in self._leases.values() if l.deadline < now]
            for lease in dead:
                # revoking awaits (watch notifications) — a keepalive can
                # land between the scan above and this revoke, and killing
                # a just-refreshed lease would drop a live worker from the
                # serving set. Re-check the CURRENT deadline.
                if lease.lease_id not in self._leases:
                    continue
                if self._leases[lease.lease_id].deadline >= now:
                    continue
                logger.info("lease %d expired; deleting %d keys", lease.lease_id, len(lease.keys))
                await self._revoke(lease.lease_id)

    async def _revoke(self, lease_id: int):
        lease = self._leases.pop(lease_id, None)
        if lease is None:
            return
        for key in list(lease.keys):
            await self._delete_key(key)

    # -- kv ops ------------------------------------------------------------- #

    async def _put(self, key: str, value: bytes, lease_id: int, create_only: bool) -> dict:
        existing = self._kv.get(key)
        if create_only and existing is not None:
            return {"ok": False, "error": "key exists"}
        if lease_id and lease_id not in self._leases:
            return {"ok": False, "error": f"unknown lease {lease_id}"}
        self._revision += 1
        rec = _KeyRecord(
            value=value,
            lease_id=lease_id,
            create_revision=existing.create_revision if existing else self._revision,
            mod_revision=self._revision,
        )
        self._kv[key] = rec
        if existing and existing.lease_id and existing.lease_id != lease_id:
            old = self._leases.get(existing.lease_id)
            if old:
                old.keys.discard(key)
        if lease_id:
            self._leases[lease_id].keys.add(key)
        await self._notify(PUT, key, value)
        return {"ok": True, "revision": self._revision}

    async def _delete_key(self, key: str) -> bool:
        rec = self._kv.pop(key, None)
        if rec is None:
            return False
        self._revision += 1
        if rec.lease_id:
            lease = self._leases.get(rec.lease_id)
            if lease:
                lease.keys.discard(key)
        await self._notify(DELETE, key, b"")
        return True

    async def _notify(self, ev_type: str, key: str, value: bytes):
        for w in list(self._watchers.values()):
            if key.startswith(w.prefix):
                try:
                    await codec.write_frame(
                        w.writer,
                        {"push": PUSH_WATCH, "watch_id": w.watch_id, "type": ev_type, "key": key},
                        value,
                    )
                except (ConnectionError, RuntimeError):
                    self._watchers.pop(w.watch_id, None)

    def _drop_sub(self, sub: _Watcher):
        self._subs_by_id.pop(sub.watch_id, None)
        lst = self._subs.get(sub.prefix)
        if lst and sub in lst:
            lst.remove(sub)

    # -- connection handling ------------------------------------------------ #

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        conn_watches: List[int] = []
        self._connections.add(writer)
        try:
            while True:
                frame = await codec.read_frame(reader)
                if frame is None:
                    break
                control, payload = frame
                resp, resp_payload = await self._dispatch(
                    control, payload, writer, conn_watches
                )
                resp["req_id"] = control.get("req_id")
                await codec.write_frame(writer, resp, resp_payload)
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except ValueError as e:
            logger.warning("dropping connection speaking a bad protocol: %s", e)
        finally:
            for wid in conn_watches:
                if wid < 0:
                    sub = self._subs_by_id.get(-wid)
                    if sub:
                        self._drop_sub(sub)
                else:
                    self._watchers.pop(wid, None)
            # Leases survive connection loss until TTL expiry (like etcd):
            # a client that reconnects fast enough keeps its registration.
            self._connections.discard(writer)
            writer.close()

    async def _dispatch(
        self, control: dict, payload: bytes, writer, conn_watches
    ) -> Tuple[dict, bytes]:
        op = control.get("op")
        if op == OP_PUT:
            r = await self._put(
                control["key"], payload, control.get("lease_id", 0), create_only=False
            )
            return r, b""
        if op == OP_CREATE:
            r = await self._put(
                control["key"], payload, control.get("lease_id", 0), create_only=True
            )
            return r, b""
        if op == OP_GET:
            rec = self._kv.get(control["key"])
            if rec is None:
                return {"ok": True, "found": False}, b""
            return {"ok": True, "found": True, "revision": rec.mod_revision}, rec.value
        if op == OP_GET_PREFIX:
            prefix = control["prefix"]
            items = [
                {"key": k, "value": rec.value, "revision": rec.mod_revision}
                for k, rec in sorted(self._kv.items())
                if k.startswith(prefix)
            ]
            return {"ok": True, "revision": self._revision}, codec.pack(items)
        if op == OP_DELETE:
            deleted = await self._delete_key(control["key"])
            return {"ok": True, "deleted": deleted}, b""
        if op == OP_DELETE_PREFIX:
            keys = [k for k in list(self._kv) if k.startswith(control["prefix"])]
            deleted = 0
            for k in keys:
                # each delete awaits watcher notification — skip keys a
                # concurrent op already removed during an earlier await
                if k not in self._kv:
                    continue
                await self._delete_key(k)
                deleted += 1
            return {"ok": True, "deleted": deleted}, b""
        if op == OP_LEASE_GRANT:
            ttl = float(control.get("ttl", 10.0))
            lease = _Lease(next(self._lease_ids), ttl, time.monotonic() + ttl)
            self._leases[lease.lease_id] = lease
            return {"ok": True, "lease_id": lease.lease_id, "ttl": ttl}, b""
        if op == OP_LEASE_KEEPALIVE:
            lease = self._leases.get(control["lease_id"])
            if lease is None:
                return {"ok": False, "error": "lease expired"}, b""
            lease.deadline = time.monotonic() + lease.ttl
            return {"ok": True, "ttl": lease.ttl}, b""
        if op == OP_LEASE_REVOKE:
            await self._revoke(control["lease_id"])
            return {"ok": True}, b""
        if op == OP_WATCH:
            wid = next(self._watch_ids)
            self._watchers[wid] = _Watcher(wid, control["prefix"], writer)
            conn_watches.append(wid)
            # initial snapshot so watchers don't race registration
            items = [
                {"key": k, "value": rec.value, "revision": rec.mod_revision}
                for k, rec in sorted(self._kv.items())
                if k.startswith(control["prefix"])
            ]
            return {"ok": True, "watch_id": wid}, codec.pack(items)
        if op == OP_UNWATCH:
            self._watchers.pop(control["watch_id"], None)
            return {"ok": True}, b""
        if op == OP_PUBLISH:
            # NATS-core-role pub/sub: fan out to live topic subscribers, no
            # persistence (KV events, metrics broadcast)
            topic = control["topic"]
            for sub in list(self._subs.get(topic, [])):
                try:
                    await codec.write_frame(
                        sub.writer,
                        {"push": PUSH_MSG, "sub_id": sub.watch_id, "topic": topic},
                        payload,
                    )
                except (ConnectionError, RuntimeError):
                    self._drop_sub(sub)
            return {"ok": True}, b""
        if op == OP_SUBSCRIBE:
            wid = next(self._watch_ids)
            sub = _Watcher(wid, control["topic"], writer)
            self._subs.setdefault(control["topic"], []).append(sub)
            self._subs_by_id[wid] = sub
            conn_watches.append(-wid)  # negative marks a topic sub
            return {"ok": True, "sub_id": wid}, b""
        if op == OP_UNSUBSCRIBE:
            sub = self._subs_by_id.get(control["sub_id"])
            if sub:
                self._drop_sub(sub)
            return {"ok": True}, b""
        if op == OP_STATUS:
            return {
                "ok": True,
                "revision": self._revision,
                "keys": len(self._kv),
                "leases": len(self._leases),
            }, b""
        return {"ok": False, "error": f"unknown op {op}"}, b""


# --------------------------------------------------------------------------- #
# Client
# --------------------------------------------------------------------------- #


@dataclass
class WatchEvent:
    type: str  # "put" | "delete"
    key: str
    value: bytes


class Watch:
    """A live prefix watch: initial snapshot + async event stream."""

    def __init__(self, watch_id: int, snapshot: List[dict], client: "DiscoveryClient"):
        self.watch_id = watch_id
        self.snapshot = snapshot
        self._queue: asyncio.Queue[Optional[WatchEvent]] = asyncio.Queue()
        self._client = client

    def __aiter__(self):
        return self

    async def __anext__(self) -> WatchEvent:
        ev = await self._queue.get()
        if ev is None:
            raise StopAsyncIteration
        return ev

    async def get(self, timeout: Optional[float] = None) -> Optional[WatchEvent]:
        if timeout is None:
            return await self._queue.get()
        try:
            return await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            return None

    async def cancel(self):
        await self._client._unwatch(self.watch_id)
        self._queue.put_nowait(None)


class Subscription:
    """A live topic subscription (NATS-core role): async stream of payloads."""

    def __init__(self, sub_id: int, topic: str, client: "DiscoveryClient"):
        self.sub_id = sub_id
        self.topic = topic
        self._queue: asyncio.Queue[Optional[bytes]] = asyncio.Queue()
        self._client = client

    def __aiter__(self):
        return self

    async def __anext__(self) -> bytes:
        item = await self._queue.get()
        if item is None:
            raise StopAsyncIteration
        return item

    async def get(self, timeout: Optional[float] = None) -> Optional[bytes]:
        if timeout is None:
            return await self._queue.get()
        try:
            return await asyncio.wait_for(self._queue.get(), timeout)
        except asyncio.TimeoutError:
            return None

    async def cancel(self):
        self._client._subs.pop(self.sub_id, None)
        try:
            await self._client._call({"op": OP_UNSUBSCRIBE, "sub_id": self.sub_id})
        except ConnectionError:
            pass
        self._queue.put_nowait(None)


class Lease:
    """Client-side lease handle with a background keepalive task
    (reference: Lease etcd.rs:43 — primary lease keeps instances alive).

    If a keepalive discovers the lease expired server-side (e.g. the event
    loop was blocked past the TTL by a long XLA compile), `on_lost` is
    invoked so the owner can re-grant and re-publish its keys."""

    def __init__(self, lease_id: int, ttl: float, client: "DiscoveryClient"):
        self.lease_id = lease_id
        self.ttl = ttl
        self._client = client
        self._task: Optional[asyncio.Task] = None
        self.alive = True
        self.on_lost: Optional[Callable] = None  # async callback

    def start_keepalive(self):
        self._task = asyncio.create_task(self._keepalive_loop())

    async def _keepalive_loop(self):
        interval = max(self.ttl / 3.0, 0.2)
        while self.alive:
            await asyncio.sleep(interval)
            f = faults.FAULTS
            if f.enabled and f.check("discovery.lease") == "drop":
                # simulate server-side expiry (reaped TTL): revoke behind our
                # own back so the NEXT keepalive walks the lost/re-grant path
                try:
                    await self._client._call(
                        {"op": OP_LEASE_REVOKE, "lease_id": self.lease_id}
                    )
                except ConnectionError:
                    pass
            try:
                resp = await self._client._call({"op": OP_LEASE_KEEPALIVE, "lease_id": self.lease_id})
                if not resp[0].get("ok"):
                    logger.warning(
                        "lease %d lost (%s); attempting re-grant",
                        self.lease_id,
                        resp[0].get("error"),
                    )
                    if await self._regrant():
                        continue
                    self.alive = False
            except ConnectionError:
                # the discovery socket died, not the lease: reconnect with
                # backoff inside the TTL budget, then re-grant — a worker
                # must not silently fall out of the serving set because of
                # one TCP reset
                logger.warning(
                    "lease %d keepalive connection lost; reconnecting", self.lease_id
                )
                deadline = time.monotonic() + self.ttl
                if await self._client.ensure_connected(deadline=deadline) and \
                        await self._regrant():
                    continue
                self.alive = False

    async def _regrant(self) -> bool:
        try:
            resp, _ = await self._client._call({"op": OP_LEASE_GRANT, "ttl": self.ttl})
            if not resp.get("ok"):
                return False
            self.lease_id = resp["lease_id"]
            if self.on_lost is not None:
                await self.on_lost(self)
            logger.info("lease re-granted as %d; keys re-published", self.lease_id)
            return True
        except ConnectionError:
            return False

    async def revoke(self):
        self.alive = False
        if self._task:
            self._task.cancel()
        try:
            await self._client._call({"op": OP_LEASE_REVOKE, "lease_id": self.lease_id})
        except ConnectionError:
            pass


class DiscoveryClient:
    """Async client for the discovery service. One TCP connection,
    multiplexed by req_id; watch pushes are routed to Watch queues."""

    def __init__(self, host: str, port: int):
        self.host, self.port = host, port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._req_ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        self._watches: Dict[int, Watch] = {}
        self._subs: Dict[int, Subscription] = {}
        self._recv_task: Optional[asyncio.Task] = None
        self._lock = asyncio.Lock()
        self._closed = False
        self._reconnect_lock = asyncio.Lock()

    @classmethod
    async def connect(
        cls, host: str, port: int, retries: int = 50, delay: float = 0.1
    ) -> "DiscoveryClient":
        client = cls(host, port)
        last_err: Optional[Exception] = None
        for _ in range(retries):
            try:
                client._reader, client._writer = await asyncio.open_connection(host, port)
                client._recv_task = asyncio.create_task(client._recv_loop())
                return client
            except OSError as e:
                last_err = e
                await asyncio.sleep(delay)
        raise ConnectionError(f"cannot reach discovery service at {host}:{port}: {last_err}")

    async def close(self):
        self._closed = True
        if self._recv_task:
            self._recv_task.cancel()
        if self._writer:
            self._writer.close()
        # the recv loop may have ALREADY exited (connection died earlier,
        # subscriptions left parked awaiting a reconnect that now never
        # comes): flush terminators unconditionally — a duplicate None
        # past the first is harmless
        for watch in self._watches.values():
            watch._queue.put_nowait(None)
        for sub in self._subs.values():
            sub._queue.put_nowait(None)

    async def ensure_connected(
        self, deadline: Optional[float] = None, backoff: Optional[Backoff] = None
    ) -> bool:
        """Re-establish the discovery socket after a loss, with backoff.

        Watches do NOT survive (the server binds them to the connection) —
        holders re-watch via `watch_prefix` (component.Client does this);
        topic subscriptions are re-established here in place, keeping the
        Subscription objects valid. Returns False once `deadline` passes
        or the client was deliberately closed."""
        if self._closed:
            return False
        if self._writer is not None and not self._writer.is_closing():
            return True
        async with self._reconnect_lock:
            if self._closed:
                return False
            if self._writer is not None and not self._writer.is_closing():
                return True  # another caller reconnected while we waited
            if backoff is None:
                # stable seed: reconnect timing reproduces across re-runs
                backoff = Backoff.seeded(
                    f"{self.host}:{self.port}", base=0.05, max_delay=1.0
                )
            while not self._closed:
                try:
                    self._reader, self._writer = await asyncio.open_connection(
                        self.host, self.port
                    )
                    self._recv_task = asyncio.create_task(self._recv_loop())
                    break
                except OSError:
                    if not await backoff.wait(deadline):
                        return False
            if self._closed:
                return False
            for sub in list(self._subs.values()):
                try:
                    resp, _ = await self._call({"op": OP_SUBSCRIBE, "topic": sub.topic})
                    self._subs.pop(sub.sub_id, None)
                    sub.sub_id = resp["sub_id"]
                    self._subs[sub.sub_id] = sub
                except (ConnectionError, KeyError):
                    logger.warning("failed to re-subscribe %s after reconnect", sub.topic)
            logger.info("discovery connection re-established to %s:%d", self.host, self.port)
            return True

    async def _recv_loop(self):
        # capture THIS connection's streams: after a reconnect the old
        # loop's finally must close the dead writer, never the fresh one
        reader, writer = self._reader, self._writer
        assert reader is not None
        try:
            while True:
                frame = await codec.read_frame(reader)
                if frame is None:
                    break
                f = faults.FAULTS
                if f.enabled and f.check("discovery.watch") == "disconnect":
                    # drop the whole control-plane connection: watches end,
                    # pending calls fail — exercising the re-watch path
                    writer.close()
                    break
                control, payload = frame
                if control.get("push") == PUSH_WATCH:
                    watch = self._watches.get(control["watch_id"])
                    if watch:
                        watch._queue.put_nowait(
                            WatchEvent(control["type"], control["key"], payload)
                        )
                    continue
                if control.get("push") == PUSH_MSG:
                    sub = self._subs.get(control["sub_id"])
                    if sub:
                        sub._queue.put_nowait(payload)
                    continue
                fut = self._pending.pop(control.get("req_id"), None)
                if fut and not fut.done():
                    fut.set_result((control, payload))
        except ConnectionError:
            pass
        except asyncio.CancelledError:
            raise  # cleanup below still runs; the task records cancelled
        finally:
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(ConnectionError("discovery connection lost"))
            self._pending.clear()
            # watches end (server state died with the connection): holders
            # notice the None and re-watch after ensure_connected
            for watch in list(self._watches.values()):
                watch._queue.put_nowait(None)
            self._watches.clear()
            if self._closed:
                # deliberate close: end subscription iterators too. On an
                # accidental loss they stay parked — ensure_connected
                # re-subscribes them in place.
                for sub in self._subs.values():
                    sub._queue.put_nowait(None)
            # an organic EOF (server died/restarted) must mark this
            # connection dead, or ensure_connected() would report the
            # corpse healthy and every later _call() would park forever
            writer.close()

    async def _call(self, control: dict, payload: bytes = b"") -> Tuple[dict, bytes]:
        if self._writer is None or self._writer.is_closing():
            raise ConnectionError("discovery client not connected")
        req_id = next(self._req_ids)
        control["req_id"] = req_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[req_id] = fut
        try:
            async with self._lock:
                await codec.write_frame(self._writer, control, payload)
        except (ConnectionError, OSError):
            self._pending.pop(req_id, None)
            raise ConnectionError("discovery connection lost")
        resp, resp_payload = await fut
        if not resp.get("ok", False) and "error" in resp:
            # callers inspect; we only raise for connection-level problems
            pass
        return resp, resp_payload

    # -- public api --------------------------------------------------------- #

    async def put(self, key: str, value: bytes, lease: Optional[Lease] = None):
        resp, _ = await self._call(
            {"op": OP_PUT, "key": key, "lease_id": lease.lease_id if lease else 0}, value
        )
        if not resp["ok"]:
            raise RuntimeError(f"put {key} failed: {resp.get('error')}")

    async def create(self, key: str, value: bytes, lease: Optional[Lease] = None) -> bool:
        """Atomic create; returns False if the key already exists
        (reference etcd kv_create)."""
        resp, _ = await self._call(
            {"op": OP_CREATE, "key": key, "lease_id": lease.lease_id if lease else 0}, value
        )
        if not resp["ok"] and resp.get("error") == "key exists":
            return False
        if not resp["ok"]:
            raise RuntimeError(f"create {key} failed: {resp.get('error')}")
        return True

    async def get(self, key: str) -> Optional[bytes]:
        resp, payload = await self._call({"op": OP_GET, "key": key})
        return payload if resp.get("found") else None

    async def get_prefix(self, prefix: str) -> List[dict]:
        _, payload = await self._call({"op": OP_GET_PREFIX, "prefix": prefix})
        return codec.unpack(payload)

    async def delete(self, key: str) -> bool:
        resp, _ = await self._call({"op": OP_DELETE, "key": key})
        return bool(resp.get("deleted"))

    async def delete_prefix(self, prefix: str) -> int:
        resp, _ = await self._call({"op": OP_DELETE_PREFIX, "prefix": prefix})
        return int(resp.get("deleted", 0))

    async def grant_lease(self, ttl: float = 10.0, keepalive: bool = True) -> Lease:
        resp, _ = await self._call({"op": OP_LEASE_GRANT, "ttl": ttl})
        lease = Lease(resp["lease_id"], resp["ttl"], self)
        if keepalive:
            lease.start_keepalive()
        return lease

    async def watch_prefix(self, prefix: str) -> Watch:
        resp, payload = await self._call({"op": OP_WATCH, "prefix": prefix})
        watch = Watch(resp["watch_id"], codec.unpack(payload), self)
        self._watches[watch.watch_id] = watch
        return watch

    async def _unwatch(self, watch_id: int):
        self._watches.pop(watch_id, None)
        try:
            await self._call({"op": OP_UNWATCH, "watch_id": watch_id})
        except ConnectionError:
            pass

    async def publish(self, topic: str, payload: bytes):
        """Fire-and-forget topic publish (NATS-core role)."""
        await self._call({"op": OP_PUBLISH, "topic": topic}, payload)

    async def subscribe(self, topic: str) -> Subscription:
        resp, _ = await self._call({"op": OP_SUBSCRIBE, "topic": topic})
        sub = Subscription(resp["sub_id"], topic, self)
        self._subs[sub.sub_id] = sub
        return sub

    async def lock(self, name: str, lease: Lease, retries: int = 100, delay: float = 0.05) -> bool:
        """Simple distributed lock: atomic-create a lock key under a lease
        (released on lease death), retrying until acquired."""
        key = f"v1/locks/{name}"
        for _ in range(retries):
            if await self.create(key, str(lease.lease_id).encode(), lease):
                return True
            await asyncio.sleep(delay)
        return False

    async def unlock(self, name: str):
        await self.delete(f"v1/locks/{name}")

    async def status(self) -> dict:
        resp, _ = await self._call({"op": OP_STATUS})
        return resp


# --------------------------------------------------------------------------- #
# Standalone entrypoint
# --------------------------------------------------------------------------- #


def main():
    import argparse

    from .logging import init_logging

    init_logging()
    ap = argparse.ArgumentParser(description="dynamo-tpu discovery service (PyTorch/CUDA port)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=2379)
    args = ap.parse_args()

    async def run():
        server = DiscoveryServer(args.host, args.port)
        await server.start()
        await asyncio.Event().wait()

    asyncio.run(run())


if __name__ == "__main__":
    main()
