"""TCP request plane: how requests reach workers and responses stream back.

Port of `dynamo_tpu/runtime/request_plane.py`, the same frames on the same
codec: each worker process runs ONE `RequestPlaneServer` exposing all of its
endpoints, registered in discovery as `host:port` + subject. Callers hold
pooled connections and multiplex many in-flight streams on each.

Wire protocol (two-part frames, codec.py):
  request :  {t:"req", stream:<id>, subject:<str>, traceparent?:<str>}  + payload
  cancel  :  {t:"cancel", stream:<id>, kill:<bool>}
  response:  {t:"data", stream:<id>} + payload        (one stream item)
             {t:"data", stream:<id>, n:<k>} + payload (k coalesced items,
                                                       payload = packed list)
             {t:"done", stream:<id>}                  (clean end)
             {t:"err",  stream:<id>, error:<str>}     (terminal error)
  liveness:  {t:"ping", stream:<id>} -> {t:"pong", stream:<id>}

Tag spellings are the constants in codec.py's FRAME_TAGS registry
(docs/wire_protocol.md).

Token-path batching: the response writer gathers every stream item that is
already ready (same event-loop tick, optionally up to DYN_STREAM_COALESCE_MS
longer) into ONE multi-item frame — one msgpack pack, one corked write — so
steady-state decode pays O(1) serving-plane work per engine dispatch instead
of per token. Item order is preserved; a frame is committed atomically
(a mid-stream sever loses whole frames, never splits one), so migration's
contiguity accounting is unchanged.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import socket as _socket
import time
from typing import Any, AsyncIterator, Awaitable, Callable, Dict, Optional, Tuple

from . import codec, faults
from .codec import (
    ENC_TOK,
    ERR_DEADLINE,
    ERR_DRAINING,
    T_CANCEL,
    T_DATA,
    T_DONE,
    T_ERR,
    T_LOST,
    T_PING,
    T_PONG,
    T_REQ,
)
from .config import _env
from .engine import Context
from .logging import DistributedTraceContext, current_trace, parse_traceparent, set_trace

logger = logging.getLogger(__name__)

Handler = Callable[[Any, Context], AsyncIterator[Any]]

#: back-compat alias — the registered spelling lives in codec.ERR_CODES
DRAINING = ERR_DRAINING


def tune_transport(writer: asyncio.StreamWriter):
    """TCP_NODELAY + bounded write buffer on a request-plane socket.

    Token frames are small and latency-critical — Nagle can hold one back
    a full RTT waiting for an ACK; the high-water mark makes drain() block
    against a stalled peer instead of buffering frames unbounded in
    userspace."""
    sock = writer.get_extra_info("socket")
    if sock is not None:
        try:
            sock.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        except (OSError, AttributeError):
            pass  # unix sockets / test doubles have no TCP layer
    try:
        writer.transport.set_write_buffer_limits(high=1 << 20)
    except (AttributeError, RuntimeError, NotImplementedError):
        pass


class EndpointStats:
    """Per-endpoint counters, scraped by metrics + KV-router metrics
    aggregation (reference: NATS $SRV.STATS scraping, transports/nats.rs:107)."""

    def __init__(self):
        self.requests_total = 0
        self.requests_active = 0
        self.errors_total = 0
        # coalescing visibility: items/frames > 1 means the writer is
        # batching; the router/planner metrics topic republishes these so
        # hardware e2e rows self-diagnose serving-plane overhead
        self.frames_total = 0
        self.items_total = 0
        # zero-copy token path visibility: frames that rode the ENC_TOK
        # binary payload instead of msgpack (docs/wire_protocol.md)
        self.frames_binary = 0
        self.last_request_at = time.monotonic()  # idle tracking (health canary)
        self.data = {}  # engine-published stats blob (ForwardPassMetrics)

    def snapshot(self) -> dict:
        return {
            "requests_total": self.requests_total,
            "requests_active": self.requests_active,
            "errors_total": self.errors_total,
            "frames_total": self.frames_total,
            "items_total": self.items_total,
            "frames_binary": self.frames_binary,
            "data": self.data,
        }


class RequestPlaneServer:
    """Per-process TCP server hosting all served endpoints
    (reference: Ingress/PushEndpoint push_endpoint.rs:36)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.host, self.port = host, port
        self._handlers: Dict[str, Handler] = {}
        self._stats: Dict[str, EndpointStats] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._active: Dict[Tuple[asyncio.StreamWriter, int], Context] = {}
        self._connections: set = set()
        self._draining = False
        # read per-server (not at import) so test clusters can set the env
        # after the module is loaded
        self.coalesce_s = max(_env("DYN_STREAM_COALESCE_MS", 0.0, float), 0.0) / 1e3
        self.coalesce_max = max(_env("DYN_STREAM_COALESCE_MAX_ITEMS", 64, int), 1)

    @property
    def active_streams(self) -> int:
        return len(self._active)

    def register(self, subject: str, handler: Handler) -> EndpointStats:
        self._handlers[subject] = handler
        self._stats[subject] = EndpointStats()
        return self._stats[subject]

    def unregister(self, subject: str):
        self._handlers.pop(subject, None)
        self._stats.pop(subject, None)

    def stats(self, subject: str) -> Optional[EndpointStats]:
        return self._stats.get(subject)

    def all_stats(self) -> Dict[str, dict]:
        return {s: st.snapshot() for s, st in self._stats.items()}

    async def start(self) -> Tuple[str, int]:
        self._server = await asyncio.start_server(self._serve_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self.host, self.port

    async def drain(self, timeout: float) -> bool:
        """Graceful-shutdown step 2 and 3 (step 1, lease revocation, is the
        runtime's job): stop accepting NEW streams — the listening socket
        closes and connected callers get a `draining` error they treat as
        StreamLost — then wait up to `timeout` for in-flight streams to
        finish. Returns True when fully drained; False means survivors
        remain for stop() to force-kill."""
        self._draining = True
        if self._server:
            self._server.close()
        deadline = time.monotonic() + timeout
        while self._active and time.monotonic() < deadline:
            await asyncio.sleep(0.02)
        return not self._active

    async def stop(self):
        for ctx in self._active.values():
            ctx.kill()
        if self._server:
            self._server.close()
        for writer in list(self._connections):
            writer.close()
        if self._server:
            await self._server.wait_closed()

    async def _serve_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        tune_transport(writer)
        write_lock = asyncio.Lock()
        tasks: Dict[int, asyncio.Task] = {}
        self._connections.add(writer)
        try:
            while True:
                frame = await codec.read_frame(reader)
                if frame is None:
                    break
                control, payload = frame
                t = control.get("t")
                if t == T_REQ:
                    stream_id = control["stream"]
                    if self._draining:
                        async with write_lock:
                            await codec.write_frame(writer, {
                                "t": T_ERR, "stream": stream_id,
                                "code": ERR_DRAINING,
                                "error": "worker draining: not accepting new streams",
                            })
                        continue
                    task = asyncio.create_task(
                        self._run_stream(control, payload, writer, write_lock)
                    )
                    tasks[stream_id] = task
                    task.add_done_callback(lambda _, sid=stream_id: tasks.pop(sid, None))
                elif t == T_CANCEL:
                    ctx = self._active.get((writer, control["stream"]))
                    if ctx is not None:
                        if control.get("kill"):
                            ctx.kill()
                        else:
                            ctx.stop_generating()
                elif t == T_PING:
                    async with write_lock:
                        # echo the stream id so the pinger's reply queue
                        # (RequestPlaneClient.ping) can route the pong
                        await codec.write_frame(
                            writer,
                            {"t": T_PONG, "stream": control.get("stream")},
                        )
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        except ValueError as e:
            logger.warning("dropping connection speaking a bad protocol: %s", e)
        finally:
            for task in tasks.values():
                task.cancel()
            for (w, sid), ctx in list(self._active.items()):
                if w is writer:
                    ctx.kill()
                    self._active.pop((w, sid), None)
            self._connections.discard(writer)
            writer.close()

    async def _run_stream(
        self,
        control: dict,
        payload: bytes,
        writer: asyncio.StreamWriter,
        write_lock: asyncio.Lock,
    ):
        stream_id = control["stream"]
        subject = control.get("subject", "")
        handler = self._handlers.get(subject)
        stats = self._stats.get(subject)
        # zero-copy token path negotiation: the caller's T_REQ advertises
        # `bin` when it can decode ENC_TOK payloads; the writer loop below
        # then ships pure token-delta batches as packed u32s instead of
        # msgpack dicts, falling back per frame for anything else
        want_binary = bool(control.get("bin"))

        async def send(ctrl: dict, pl: bytes = b""):
            ctrl["stream"] = stream_id
            async with write_lock:
                await codec.write_frame(writer, ctrl, pl)

        if handler is None:
            await send({"t": T_ERR, "error": f"no such endpoint: {subject}"})
            return

        ctx = Context(id=control.get("ctx_id"))
        deadline_ms = control.get("deadline_ms")
        if deadline_ms is not None:
            # the caller's remaining budget, rebased onto this host's clock
            ctx.set_deadline(max(0.0, deadline_ms / 1000.0))
        self._active[(writer, stream_id)] = ctx
        tp = control.get("traceparent")
        if tp:
            parsed = parse_traceparent(tp)
            if parsed:
                set_trace(parsed.child())
        if stats:
            stats.requests_total += 1
            stats.requests_active += 1
            stats.last_request_at = time.monotonic()
        # response coalescing: a pump task drains the handler while the
        # writer loop below packs every already-ready item into ONE
        # multi-item frame. The engine emits a whole decode block between
        # event-loop ticks, so steady state is one frame per dispatch, not
        # one per token. DYN_STREAM_COALESCE_MS (default 0) optionally
        # waits a bounded window for more items — off by default so a slow
        # stream's TTFT/ITL is untouched.
        _DATA, _DONE, _ERR = 0, 1, 2
        queue: asyncio.Queue = asyncio.Queue()

        async def pump():
            try:
                async for item in handler(request, ctx):
                    if ctx.is_killed():
                        break
                    queue.put_nowait((_DATA, item))
                queue.put_nowait((_DONE, None))
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001 — forwarded to the caller
                queue.put_nowait((_ERR, e))

        pump_task: Optional[asyncio.Task] = None
        try:
            request = codec.unpack(payload)
            pump_task = asyncio.create_task(pump())
            terminal: Optional[tuple] = None
            while terminal is None:
                kind, item = await queue.get()
                if kind != _DATA:
                    terminal = (kind, item)
                    break
                items = [item]
                waited = self.coalesce_s <= 0.0
                while len(items) < self.coalesce_max:
                    try:
                        kind, item = queue.get_nowait()
                    except asyncio.QueueEmpty:
                        if waited:
                            break
                        waited = True
                        await asyncio.sleep(self.coalesce_s)
                        continue
                    if kind != _DATA:
                        terminal = (kind, item)
                        break
                    items.append(item)
                if stats:
                    stats.items_total += len(items)
                pos = 0
                if want_binary:
                    # leading run of pure token deltas (of one wrapper
                    # shape) rides ENC_TOK: the steady-state decode frame
                    # is one flat u32 pack, no per-item dict encode (and
                    # ONE merged dict to decode caller-side); the
                    # remainder — typically just the finish item — falls
                    # back to msgpack below
                    packed = codec.try_pack_token_run(items)
                    if packed is not None:
                        payload_bin, pos = packed
                        if stats:
                            stats.frames_total += 1
                            stats.frames_binary += 1
                        await send(
                            {"t": T_DATA, "n": pos, "enc": ENC_TOK},
                            payload_bin,
                        )
                rest = items[pos:]
                if rest:
                    if stats:
                        stats.frames_total += 1
                    if len(rest) == 1:
                        await send({"t": T_DATA}, codec.pack(rest[0]))
                    else:
                        await send({"t": T_DATA, "n": len(rest)}, codec.pack(rest))
            kind, item = terminal
            if kind == _DONE:
                await send({"t": T_DONE})
            else:
                raise item  # handler exception: report like the inline path
        except asyncio.CancelledError:
            raise
        except Exception as e:  # noqa: BLE001 — stream errors go to the caller
            logger.exception("handler error on %s", subject)
            if stats:
                stats.errors_total += 1
            if isinstance(e, DeadlineExceeded):
                # machine-readable: the caller re-raises DeadlineExceeded
                # (not a generic EngineError) so its migration/retry loops
                # STOP instead of burning another worker slot
                ctrl = {
                    "t": T_ERR, "code": ERR_DEADLINE,
                    "error": f"{type(e).__name__}: {e}",
                }
            elif isinstance(e, StreamSevered):
                # deliberate mid-stream sever (role-morph drain): ride the
                # `draining` code so the CALLER raises StreamLost and its
                # migration machinery resumes the session on a peer from
                # the checkpointed tail — a plain T_ERR would surface as a
                # terminal EngineError and kill the stream instead
                ctrl = {
                    "t": T_ERR, "code": ERR_DRAINING,
                    "error": f"{type(e).__name__}: {e}",
                }
            else:
                ctrl = {"t": T_ERR, "error": f"{type(e).__name__}: {e}"}
            try:
                await send(ctrl)
            except (ConnectionError, RuntimeError):
                pass
        finally:
            if pump_task is not None:
                pump_task.cancel()
            if stats:
                stats.requests_active -= 1
            self._active.pop((writer, stream_id), None)


class EngineError(RuntimeError):
    """Terminal error surfaced from a remote engine stream."""


class StreamLost(EngineError):
    """Connection to the worker died mid-stream — the trigger for request
    migration (reference migration.rs)."""


class StreamSevered(EngineError):
    """Raised BY a worker's handler to deliberately cut an in-flight
    stream (role-morph drain: the outgoing role's lanes must move to a
    peer NOW, not when their decodes finish). The server maps it to a
    `draining`-coded T_ERR, which the caller raises as StreamLost — so
    the frontend's migration loop re-routes the session and it resumes
    from its durable checkpoint instead of dying with the role."""


class DeadlineExceeded(EngineError):
    """The context's end-to-end deadline passed. Clean and terminal:
    retry loops (migration, reconnects) must stop, not spin."""


class _Connection:
    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.reader = reader
        self.writer = writer
        self.write_lock = asyncio.Lock()
        self.streams: Dict[int, asyncio.Queue] = {}
        self.recv_task: Optional[asyncio.Task] = None
        self.closed = False

    async def recv_loop(self):
        try:
            while True:
                frame = await codec.read_frame(self.reader)
                if frame is None:
                    break
                control, payload = frame
                q = self.streams.get(control.get("stream"))
                if q is not None:
                    q.put_nowait((control, payload))
        except ConnectionError:
            pass
        except asyncio.CancelledError:
            raise  # cleanup below still runs; the task records cancelled
        finally:
            self.closed = True
            for q in self.streams.values():
                q.put_nowait(({"t": T_LOST}, b""))
            self.writer.close()


class RequestPlaneClient:
    """Caller side: pooled connections to worker request-plane servers,
    many concurrent streams multiplexed per connection
    (reference AddressedPushRouter addressed_router.rs:52)."""

    def __init__(self, connect_timeout: float = 5.0):
        self._conns: Dict[str, _Connection] = {}
        self._stream_ids = itertools.count(1)
        # zero-copy token path: advertise ENC_TOK decoding on every stream
        # we open (per-client so test clusters can flip the env after
        # import, like the server's coalesce knobs)
        self.binary_tokens = bool(_env("DYN_WIRE_BINARY_TOKENS", True, bool))
        # per-address dial serialization.  Entries are PRUNED when the
        # address's connection dies (recv-loop done-callback below): under
        # worker churn the router dials a new host:port per replacement,
        # and a setdefault-only dict would grow one lock per address ever
        # seen, forever.
        self._conn_locks: Dict[str, asyncio.Lock] = {}
        self.connect_timeout = connect_timeout

    def _evict_conn(self, address: str, conn: _Connection):
        """The connection's recv loop ended: it can never carry another
        stream.  Drop it from the pool (identity-checked — a newer dial
        may already own the slot) and prune the address's dial lock once
        no dial is in flight."""
        if self._conns.get(address) is conn:
            self._conns.pop(address, None)
        lock = self._conn_locks.get(address)
        if lock is not None and not lock.locked() \
                and address not in self._conns:
            self._conn_locks.pop(address, None)

    async def _get_conn(
        self, address: str, deadline: Optional[float] = None
    ) -> _Connection:
        conn = self._conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        lock = self._conn_locks.setdefault(address, asyncio.Lock())
        try:
            return await self._dial_locked(address, lock, deadline)
        except BaseException:
            # no connection materialized (refused/timed out/black-holed):
            # a lock kept for an address we never reached is pure growth
            if address not in self._conns and not lock.locked() \
                    and self._conn_locks.get(address) is lock:
                self._conn_locks.pop(address, None)
            raise

    async def _dial_locked(
        self, address: str, lock: asyncio.Lock, deadline: Optional[float]
    ) -> _Connection:
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and not conn.closed:
                return conn
            host, _, port = address.rpartition(":")
            # a black-holed address (dead host, dropped SYN) must raise
            # StreamLost within the connect budget, never hang the caller;
            # the context deadline tightens the budget further
            timeout = self.connect_timeout
            if deadline is not None:
                timeout = min(timeout, max(0.0, deadline - time.monotonic()))

            async def _dial():
                f = faults.FAULTS
                if f.enabled:
                    act = await f.on("request_plane.connect")
                    if act == "refuse":
                        raise ConnectionRefusedError(
                            f"injected: connect to {address} refused"
                        )
                return await asyncio.open_connection(host, int(port))

            try:
                reader, writer = await asyncio.wait_for(_dial(), timeout)
            except asyncio.TimeoutError:
                raise StreamLost(
                    f"connect to {address} timed out after {timeout:.1f}s"
                ) from None
            tune_transport(writer)
            current = self._conns.get(address)
            if current is not None and not current.closed:
                # a racing dial through a just-pruned lock won: keep ONE
                # connection per address, drop ours unused
                writer.close()
                return current
            conn = _Connection(reader, writer)
            conn.recv_task = asyncio.create_task(conn.recv_loop())
            conn.recv_task.add_done_callback(
                lambda _t, a=address, c=conn: self._evict_conn(a, c)
            )
            self._conns[address] = conn
            return conn

    async def close(self):
        for conn in self._conns.values():
            # unblock consumers parked on queue.get() FIRST: they unwind
            # via the normal StreamLost path instead of hanging on a queue
            # nobody will ever fill again
            conn.closed = True
            for q in conn.streams.values():
                q.put_nowait(({"t": T_LOST}, b""))
            if conn.recv_task:
                conn.recv_task.cancel()
            conn.writer.close()
        self._conns.clear()
        self._conn_locks.clear()

    async def ping(self, address: str, timeout: float = 5.0) -> float:
        """Transport liveness probe: one ping/pong round-trip on the pooled
        connection (no handler dispatch — cheaper than a canary request
        and usable against a draining worker). Returns the RTT in seconds;
        raises StreamLost when the peer is unreachable or silent past
        `timeout`."""
        try:
            # the dial shares the probe's budget, not the default connect
            # timeout — a black-holed host answers within `timeout` too
            conn = await self._get_conn(
                address, deadline=time.monotonic() + timeout
            )
        except OSError as e:
            raise StreamLost(f"cannot connect to {address}: {e}") from e
        stream_id = next(self._stream_ids)
        queue: asyncio.Queue = asyncio.Queue()
        conn.streams[stream_id] = queue
        t0 = time.monotonic()
        try:
            async with conn.write_lock:
                await codec.write_frame(
                    conn.writer, {"t": T_PING, "stream": stream_id}
                )
            try:
                control, _ = await asyncio.wait_for(queue.get(), timeout)
            except asyncio.TimeoutError:
                raise StreamLost(
                    f"ping to {address} timed out after {timeout:.1f}s"
                ) from None
            t = control.get("t")
            if t == T_PONG:
                return time.monotonic() - t0
            raise StreamLost(f"ping to {address} answered '{t}', not pong")
        except (ConnectionError, OSError) as e:
            raise StreamLost(f"ping to {address} failed: {e}") from e
        finally:
            conn.streams.pop(stream_id, None)

    async def call(
        self,
        address: str,
        subject: str,
        request: Any,
        context: Optional[Context] = None,
    ) -> AsyncIterator[Any]:
        """Issue a request; returns the async response stream. Cancelling the
        context sends a cancel frame to the worker."""
        ctx = context or Context()
        if ctx.deadline_exceeded():
            raise DeadlineExceeded(f"deadline passed before calling {address}")
        try:
            conn = await self._get_conn(address, deadline=ctx.deadline)
        except OSError as e:
            raise StreamLost(f"cannot connect to {address}: {e}") from e
        stream_id = next(self._stream_ids)
        queue: asyncio.Queue = asyncio.Queue()
        conn.streams[stream_id] = queue

        control = {"t": T_REQ, "stream": stream_id, "subject": subject, "ctx_id": ctx.id}
        if self.binary_tokens:
            control["bin"] = 1
        remaining = ctx.time_remaining()
        if remaining is not None:
            # ship the REMAINING budget, not an absolute time: monotonic
            # clocks don't compare across hosts
            control["deadline_ms"] = int(remaining * 1000)
        trace = current_trace()
        if trace is not None:
            control["traceparent"] = trace.traceparent()
        try:
            async with conn.write_lock:
                await codec.write_frame(conn.writer, control, codec.pack(request))
        except (ConnectionError, OSError) as e:
            conn.streams.pop(stream_id, None)
            raise StreamLost(f"send to {address} failed: {e}") from e

        return self._stream(conn, stream_id, queue, ctx)

    async def _stream(
        self, conn: _Connection, stream_id: int, queue: asyncio.Queue, ctx: Context
    ) -> AsyncIterator[Any]:
        cancel_sent = False
        ended = False  # the worker ended the stream, or was told to
        kill_task = asyncio.create_task(ctx.killed())
        stop_task = asyncio.create_task(ctx.stopped())
        get_task: Optional[asyncio.Task] = None
        try:
            while True:
                get_task = asyncio.create_task(queue.get())
                waiters = {get_task, kill_task}
                if not cancel_sent:
                    waiters.add(stop_task)
                done, _pending = await asyncio.wait(
                    waiters, return_when=asyncio.FIRST_COMPLETED
                )
                if kill_task in done:
                    ended = True
                    await self._send_cancel(conn, stream_id, kill=True)
                    return
                if stop_task in done and not cancel_sent:
                    # graceful stop: tell the worker, then keep draining so the
                    # engine can emit its final (usage) chunk
                    cancel_sent = True
                    await self._send_cancel(conn, stream_id, kill=False)
                if get_task not in done:
                    get_task.cancel()
                    continue
                # the task is in asyncio.wait's done set, so result()
                # returns immediately — it never blocks here
                control, payload = get_task.result()
                get_task = None
                t = control.get("t")
                if t == T_DATA:
                    f = faults.FAULTS
                    if f.enabled:
                        act = await f.on("request_plane.frame")
                        if act == "sever":
                            # sever the CONNECTION, not just this stream:
                            # every stream multiplexed on it sees a real
                            # mid-flight loss, exactly like a worker SIGKILL.
                            # Mark it dead NOW so a concurrent _get_conn
                            # never hands out the dying transport in the
                            # window before recv_loop's finally runs
                            conn.closed = True
                            conn.writer.close()
                            raise StreamLost("injected: connection severed mid-stream")
                    enc = control.get("enc")
                    if enc == ENC_TOK:
                        # binary token-delta batch: flat u32 decode into
                        # ONE merged delta — the same concatenation the
                        # frontend's merge_token_deltas would apply to the
                        # frame's items (token counts/order preserved)
                        for it in codec.unpack_token_items(
                            payload, merge=True
                        ):
                            yield it
                    elif enc is not None:
                        raise EngineError(
                            f"unknown payload encoding {enc!r} (worker "
                            "newer than this client?)"
                        )
                    elif control.get("n"):
                        # coalesced multi-item frame: the payload is the
                        # packed item list, committed atomically on the
                        # wire — yield in order
                        for it in codec.unpack(payload):
                            yield it
                    else:
                        yield codec.unpack(payload)
                elif t == T_DONE:
                    ended = True
                    return
                elif t == T_ERR:
                    ended = True
                    code = control.get("code")
                    if code == ERR_DRAINING:
                        # a draining worker is connection-level unavailable:
                        # routers and migration retry another instance
                        raise StreamLost(control.get("error", "worker draining"))
                    if code == ERR_DEADLINE:
                        # terminal, not retryable: the request's own budget
                        # ran out worker-side
                        raise DeadlineExceeded(
                            control.get("error", "deadline exceeded")
                        )
                    raise EngineError(control.get("error", "engine error"))
                elif t == T_LOST:
                    ended = True
                    raise StreamLost("connection to worker lost mid-stream")
        finally:
            for task in (kill_task, stop_task, get_task):
                if task is not None:
                    task.cancel()
            conn.streams.pop(stream_id, None)
            if not ended and (ctx.is_killed() or (ctx.is_stopped() and not cancel_sent)):
                # the consumer was torn down (a client that left cancels the
                # whole pipeline) before this loop saw its kill or stop: tell
                # the worker now, or it decodes on for no one. One write
                # call, so the frame cannot interleave with another's.
                if not conn.closed and not conn.writer.is_closing():
                    conn.writer.write(codec.encode_frame(
                        {"t": T_CANCEL, "stream": stream_id, "kill": ctx.is_killed()}))

    async def _send_cancel(self, conn: _Connection, stream_id: int, kill: bool):
        try:
            async with conn.write_lock:
                await codec.write_frame(
                    conn.writer, {"t": T_CANCEL, "stream": stream_id, "kill": kill}
                )
        except (ConnectionError, OSError):
            pass
