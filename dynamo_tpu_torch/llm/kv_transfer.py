"""KV-cache data plane: the prefill -> decode page handoff.

Port of `dynamo_tpu/llm/kv_transfer.py` with the same wire: the frame magics
(0xD7A04B1D full-stream pull, 0xD7A04B1E ranged request), the `<II` header
(magic, header length), msgpack headers (here `runtime/msgpack_lite.py`)
and the frame order, so a port worker and a JAX worker stand on either side
of one handoff.

  * **staged pull over a dedicated TCP data plane**: the prefill worker runs
    a `KvDataPlaneServer` on its own port. Finishing a remote prefill
    *stages* the slot's pages and returns a small descriptor on the response
    stream; the decode worker connects and pulls page CHUNKS, injecting
    each while later chunks are still in flight (the server extracts chunk
    i+1 while chunk i drains into the socket). A chunk is a header
    `{"off", "n", "k_bytes", "v_bytes"}` followed by the raw K then V bytes
    in the layer-major `[L, n, ...]` layout; `{"eof": true}` ends the
    stream, `{"error": ...}` refuses it.
  * **in-process device path**: when both engines share a process, the
    descriptor resolves through the process-local `_LOCAL` registry and
    chunks hand over as device tensors — on the card, CUDA tensors with no
    host copy.

Pages travel in the dtype the descriptor names. The reference sizes frames
with numpy's itemsize and reads bf16 through `ml_dtypes`; here a name ->
(torch dtype, itemsize) table does both (`WIRE_DTYPES`), and bytes become
tensors through `torch.frombuffer` (a bf16 tensor is 16-bit words read as
bf16).

KVBM block pulls ride the ranged handshake: `{"blocks": [hashes], "fmt":
kv_format}` is answered from the worker's tiers (`kvbm_source`, set by
kvbm/distributed.py) with ONE frame — a header `{"n", "k_bytes", "v_bytes",
"shape", "dtype", "fmt"}` then the stacked K and V bytes — or refused typed
(no tiers, a block miss, a `kv_format` mismatch) before a byte moves;
`pull_kvbm_blocks` is the client. Session-checkpoint pushes ride the same
handshake the other way: `{"ckpt": {"blocks", "parents", "fmt", "k_bytes",
"v_bytes"}}` followed by the stacked K and V bytes is stored into the
worker's tiers and answered `{"ok": true, "stored": n}`, or drained and
refused typed (no tiers, another `kv_format`, another block geometry, a
payload over CHECKPOINT_MAX_PAYLOAD); `push_checkpoint_blocks` is the
client (kvbm/checkpoint.py). Not ported yet: the multi-host shard path
(descriptors with `shards`), which the engine refuses.
"""

from __future__ import annotations

import asyncio
import logging
import secrets
import socket
import struct
import time
import warnings
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import faults, msgpack_lite

logger = logging.getLogger(__name__)


class KvTransferError(RuntimeError):
    """A KV data-plane transfer failed (peer unreachable, addr no longer
    resolving, severed stream, protocol violation). Typed so the disagg
    path converts it to a local-prefill fallback instead of letting a raw
    ConnectionError escape into the step loop."""


class KvFormatError(KvTransferError):
    """The two ends of a KV transfer run different page formats (a
    mixed-precision fleet). Raised BEFORE any payload byte is interpreted:
    quantized bytes are never read as fp pages, or the reverse."""


_MAGIC = 0xD7A04B1D  # frame magic (full-stream pull handshake)
_MAGIC_RANGE = 0xD7A04B1E  # ranged pull handshake
_HDR = struct.Struct("<II")  # magic, header length

DATA_PLANE_ROOT = "v1/kv_data_plane/"

# the server's cap on one checkpoint push's block payload; the checkpointer
# sizes its batches to half of it
CHECKPOINT_MAX_PAYLOAD = 512 << 20

# process-local rendezvous: (addr, transfer_id) -> _Staged. The in-process
# device-direct path (co-located prefill/decode engines) resolves here and
# never touches the socket.
_LOCAL: Dict[Tuple[str, str], "_Staged"] = {}

# dtype names as descriptors carry them (numpy's names, "bfloat16" as
# ml_dtypes spells it) -> torch dtype
WIRE_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "uint8": torch.uint8,
    "int8": torch.int8,
}
_DTYPE_NAMES = {v: k for k, v in WIRE_DTYPES.items()}


def wire_dtype(name: str) -> torch.dtype:
    try:
        return WIRE_DTYPES[name]
    except KeyError:
        raise KvTransferError(f"unknown KV wire dtype {name!r}") from None


def wire_itemsize(name: str) -> int:
    return wire_dtype(name).itemsize


def dtype_name(dtype: torch.dtype) -> str:
    """The wire name of a torch dtype (the inverse of wire_dtype)."""
    return _DTYPE_NAMES[dtype]


def host_bytes(x, dtype: str) -> memoryview:
    """Zero-copy bytes of a host array in the wire dtype `dtype`: a CPU
    tensor (moved to the host and cast if it is not one) or a numpy array
    (fp extract callbacks in tests)."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
        return x.reshape(-1).view(np.uint8).data
    x = x.detach().to("cpu", wire_dtype(dtype)).contiguous()
    return x.reshape(-1).view(torch.uint8).numpy().data


def tensor_from_bytes(raw, dtype: str, shape) -> torch.Tensor:
    """A CPU tensor over `raw` (no copy) in the wire dtype, reshaped."""
    with warnings.catch_warnings():
        # the buffer is read-only: the tensor is only ever copied from
        warnings.simplefilter("ignore", UserWarning)
        flat = torch.frombuffer(raw, dtype=torch.uint8)
    return flat.view(wire_dtype(dtype)).reshape(tuple(shape))


def _set_nodelay(writer: asyncio.StreamWriter):
    """Disable Nagle on a KV data-plane socket: a coalescing delay on
    either end stalls the pull round trip."""
    try:
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


def routable_host() -> str:
    """Best-effort routable address for descriptor advertisement: binding
    to 0.0.0.0 and advertising 127.0.0.1 would make every remote pull
    connect to itself."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    try:
        # no packet is sent; this only asks the kernel for the route
        s.connect(("10.255.255.255", 1))
        return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"
    finally:
        s.close()


@dataclass
class KvTransferDescriptor:
    """What rides the response stream instead of the KV payload."""

    transfer_id: str
    addr: str  # host:port of the staging worker's data plane
    n_pages: int
    n_tokens: int
    page_size: int
    page_shape: list  # per-page block shape [L, page, KH, D]; a chunk of n
    # pages is layer-major [L, n, page, KH, D] (the engine's KV layout)
    dtype: str
    chunk_pages: int
    # multi-host shard rendezvous ([{"host_id", "addr"}]); None = one
    # staging endpoint. Carried for the wire's sake: the port refuses it.
    shards: Optional[list] = None
    # streamed staging: the producer is still prefilling when this
    # descriptor ships; chunks become pullable as pages commit
    streamed: bool = False
    # page format ("none" | "int8" | "int4"): under quant, page_shape is the
    # packed host layout [L, PAGE_BYTES] uint8 and the puller must run the
    # same format (checked, KvFormatError, before pulling)
    kv_format: str = "none"

    def to_dict(self) -> dict:
        return dict(self.__dict__)

    @classmethod
    def from_dict(cls, d: dict) -> "KvTransferDescriptor":
        import dataclasses as _dc

        known = {f.name for f in _dc.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


# extract(page_offset, n_pages, device) -> (k, v) with n_pages on axis 1:
# host tensors (or numpy arrays) when device=False, device tensors allowed
# when device=True (in-process path)
ExtractFn = Callable[[int, int, bool], Awaitable[Tuple[Any, Any]]]


@dataclass
class _Staged:
    desc: KvTransferDescriptor
    extract: ExtractFn
    on_done: Callable[[bool], None]  # called exactly once; arg = pulled ok
    deadline: float
    max_transfer_time: float = 120.0  # per-chunk deadline extension budget
    started: bool = False
    finished: bool = False
    server: Optional["KvDataPlaneServer"] = None  # for serve accounting
    # streamed staging: `available` = pages valid so far (None = all pages);
    # the producer advances it as prefill chunks commit and the serve loop
    # waits on `avail_event` before extracting past it. `failed` aborts
    # waiting pullers (producer died / preempted mid-stream).
    available: Optional[int] = None
    failed: bool = False
    avail_event: Optional[asyncio.Event] = None

    def set_available(self, n_pages: int):
        if self.available is not None and n_pages > self.available:
            self.available = min(n_pages, self.desc.n_pages)
            # a progressing producer keeps the transfer alive
            self.deadline = time.monotonic() + self.max_transfer_time
            if self.avail_event is not None:
                self.avail_event.set()

    def fail_stream(self):
        self.failed = True
        if self.avail_event is not None:
            self.avail_event.set()

    async def wait_pages(self, upto: int):
        """Block until pages [0, upto) are valid (streamed staging); no-op
        for fully staged transfers. Raises KvTransferError when the
        producer fails or the transfer is reaped mid-wait."""
        while True:
            if self.failed:
                raise KvTransferError("streamed kv transfer failed at source")
            if self.finished:
                raise KvTransferError("kv transfer reaped mid-stream")
            if self.available is None or self.available >= upto:
                return
            self.avail_event.clear()
            try:
                await asyncio.wait_for(self.avail_event.wait(), self.max_transfer_time)
            except asyncio.TimeoutError as e:
                raise KvTransferError(
                    "streamed kv transfer stalled (producer made no "
                    f"progress past page {self.available})"
                ) from e

    def count_serve(self, nbytes: int):
        """Account a served chunk (socket or in-process) on the owning
        server's counters."""
        if self.server is not None:
            self.server.transfers_served += 1
            self.server.bytes_served += nbytes

    def finish(self, ok: bool):
        if not self.finished:
            self.finished = True
            try:
                self.on_done(ok)
            except Exception:  # noqa: BLE001 — release callbacks must not kill the server
                logger.exception("kv transfer on_done failed")


class KvDataPlaneServer:
    """Prefill-side staging server: holds pinned transfers, streams chunks
    to pulling peers, reaps abandoned transfers so their pages free."""

    def __init__(self, host: str = "0.0.0.0", advertise_host: Optional[str] = None,
                 port: int = 0, ttl: float = 30.0, max_transfer_time: float = 120.0,
                 chunk_timeout: float = 30.0):
        self._host = host
        self._advertise_host = advertise_host or (
            routable_host() if host in ("0.0.0.0", "") else host
        )
        self._port = port
        self.ttl = ttl
        # a pull that has started gets this long to finish before the
        # reaper unstages it (half-open peers must not pin pages forever)
        self.max_transfer_time = max_transfer_time
        self.chunk_timeout = chunk_timeout
        self._server: Optional[asyncio.AbstractServer] = None
        self._staged: Dict[str, _Staged] = {}
        self._reaper: Optional[asyncio.Task] = None
        self._conns: set = set()  # open connections (kept ranged ones too)
        # evidence that this data plane moved bytes (a silent local-prefill
        # fallback must not pass for a working handoff)
        self.transfers_served = 0
        self.bytes_served = 0
        # session-checkpoint pushes stored into this worker's tiers
        self.checkpoint_pushes = 0
        self.checkpoint_blocks_received = 0
        # distributed KVBM (kvbm/distributed.py): when set, `{"blocks": [...]}`
        # requests are served from these tiers
        self.kvbm_source = None
        self.kvbm_distributed = None

    @property
    def addr(self) -> str:
        return f"{self._advertise_host}:{self._port}"

    async def start(self):
        self._server = await asyncio.start_server(self._serve, self._host, self._port)
        self._port = self._server.sockets[0].getsockname()[1]
        self._reaper = asyncio.create_task(self._reap_loop())

    async def close(self):
        if self._reaper is not None:
            self._reaper.cancel()
        for t in list(self._staged.values()):
            self._unstage(t, ok=False)
        if self._server is not None:
            self._server.close()
            # a peer's kept connection would hold wait_closed() until its
            # idle timeout
            for writer in list(self._conns):
                writer.close()
            await self._server.wait_closed()

    async def register(self, drt):
        """Advertise this data plane in discovery under the reference's key."""
        import json

        try:
            await drt.put_leased(
                f"{DATA_PLANE_ROOT}{drt.instance_id:x}",
                json.dumps({"addr": self.addr}).encode(),
            )
        except Exception:  # noqa: BLE001 — advertisement is best-effort
            logger.warning("could not advertise kv data plane", exc_info=True)

    def stage(
        self,
        *,
        n_pages: int,
        n_tokens: int,
        page_size: int,
        page_shape: list,
        dtype: str,
        extract: ExtractFn,
        on_done: Callable[[bool], None],
        chunk_pages: int = 0,
        ttl: Optional[float] = None,
        transfer_id: Optional[str] = None,
        streamed: bool = False,
        available_pages: int = 0,
        kv_format: str = "none",
    ) -> KvTransferDescriptor:
        """Pin a finished prefill's pages for pulling; returns the descriptor
        to send on the response stream. `on_done(ok)` fires exactly once —
        on a successful pull, a failed one, or TTL expiry — and is where the
        engine releases the slot's pages. `streamed=True` stages a transfer
        whose producer is still running: only `available_pages` are valid
        yet, and the producer advances the watermark (`advance_streamed`)."""
        if chunk_pages <= 0:
            # ~4 MiB a chunk of K (plus V): small enough to overlap, large
            # enough that framing costs nothing
            per_page = int(np.prod(page_shape)) * wire_itemsize(dtype)
            chunk_pages = max(1, (4 << 20) // max(per_page, 1))
        transfer_id = transfer_id or secrets.token_hex(8)
        desc = KvTransferDescriptor(
            transfer_id=transfer_id, addr=self.addr, n_pages=n_pages,
            n_tokens=n_tokens, page_size=page_size, page_shape=list(page_shape),
            dtype=dtype, chunk_pages=chunk_pages, streamed=streamed,
            kv_format=kv_format,
        )
        staged = _Staged(
            desc=desc, extract=extract, on_done=on_done,
            deadline=time.monotonic() + (ttl if ttl is not None else self.ttl),
            max_transfer_time=self.max_transfer_time, server=self,
            available=min(max(available_pages, 0), n_pages) if streamed else None,
            avail_event=asyncio.Event() if streamed else None,
        )
        self._staged[transfer_id] = staged
        _LOCAL[(self.addr, transfer_id)] = staged
        return desc

    def advance_streamed(self, transfer_id: str, available_pages: int):
        """Producer-side watermark: pages [0, available_pages) are valid."""
        staged = self._staged.get(transfer_id)
        if staged is not None:
            staged.set_available(available_pages)

    def abort_streamed(self, transfer_id: str):
        """The producer died mid-stream: fail any waiting puller and
        release the stage."""
        staged = self._staged.get(transfer_id)
        if staged is not None:
            staged.fail_stream()
            self._unstage(staged, ok=False)

    def _unstage(self, staged: _Staged, ok: bool):
        self._staged.pop(staged.desc.transfer_id, None)
        _LOCAL.pop((self.addr, staged.desc.transfer_id), None)
        staged.finish(ok)

    def unstage_by_id(self, transfer_id: str, ok: bool) -> None:
        """Explicit release (ranged pulls have no single is-done connection)."""
        staged = self._staged.get(transfer_id)
        if staged is not None:
            self._unstage(staged, ok)

    async def _reap_loop(self):
        while True:
            # every second, or twice a TTL when that is shorter
            await asyncio.sleep(min(1.0, self.ttl / 2))
            now = time.monotonic()
            for t in list(self._staged.values()):
                if t.finished:
                    # in-process pulls finish without passing through _serve
                    self._staged.pop(t.desc.transfer_id, None)
                elif now > t.deadline:
                    logger.warning(
                        "kv transfer %s %s; releasing", t.desc.transfer_id,
                        "stalled mid-pull" if t.started else "never pulled",
                    )
                    self._unstage(t, ok=False)

    async def _serve(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        _set_nodelay(writer)
        self._conns.add(writer)
        try:
            # ranged requests are request-response and keep the connection
            # (idle ones die at the chunk timeout); a full-stream pull
            # closes after its one transfer
            while True:
                try:
                    hdr = await asyncio.wait_for(
                        reader.readexactly(_HDR.size), self.chunk_timeout)
                except (asyncio.TimeoutError, asyncio.IncompleteReadError):
                    return  # idle keep-alive or clean peer close
                magic, length = _HDR.unpack(hdr)
                if magic not in (_MAGIC, _MAGIC_RANGE):
                    raise RuntimeError(f"bad kv data plane magic {magic:#x}")
                cap = 65536 if magic == _MAGIC_RANGE else 4096
                if length > cap:
                    raise RuntimeError(f"oversized kv handshake ({length} bytes)")
                body = await asyncio.wait_for(reader.readexactly(length), self.chunk_timeout)
                if magic == _MAGIC_RANGE:
                    await self._serve_range(body, writer, reader)
                    continue
                await self._serve_transfer(body, writer)
                return
        except (asyncio.IncompleteReadError, ConnectionError):
            pass  # peer vanished; reaper/unstage already handled pages
        except Exception:  # noqa: BLE001 — one bad peer must not kill the server
            logger.exception("kv data plane connection failed")
        finally:
            self._conns.discard(writer)
            writer.close()

    async def _serve_transfer(self, body: bytes, writer: asyncio.StreamWriter):
        """Full-stream transfer pull (one per connection)."""
        transfer_id = body.decode()
        staged = self._staged.get(transfer_id)
        if staged is None or staged.started:
            await self._send_header(writer, {"error": f"unknown transfer {transfer_id}"})
            return
        staged.started = True
        staged.deadline = time.monotonic() + self.max_transfer_time
        try:
            await self._stream(staged, writer)
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError,
                KvTransferError):
            self._unstage(staged, ok=False)
            raise
        self.transfers_served += 1
        self._unstage(staged, ok=True)

    async def _serve_range(self, body: bytes, writer: asyncio.StreamWriter,
                           reader: asyncio.StreamReader):
        """One ranged request -> one (k, v) frame; `fin` releases the
        transfer; `blocks` pulls KVBM blocks; `ckpt` pushes them here."""
        req = msgpack_lite.unpackb(body)
        if req.get("ckpt") is not None:
            await self._serve_checkpoint(req["ckpt"], reader, writer)
            return
        if req.get("blocks") is not None:
            await self._serve_kvbm_blocks(req, writer)
            return
        transfer_id = req.get("tid", "")
        staged = self._staged.get(transfer_id)
        if staged is None:
            await self._send_header(writer, {"error": f"unknown transfer {transfer_id}"})
            return
        if req.get("fin"):
            # puller-side completion: release now instead of at TTL (a
            # control message, not a served transfer)
            self._unstage(staged, ok=True)
            await self._send_header(writer, {"ok": True})
            return
        off, n = int(req.get("off", 0)), int(req.get("n", 0))
        if not (0 <= off and 0 < n and off + n <= staged.desc.n_pages):
            await self._send_header(writer, {"error": f"range out of bounds ({off},{n})"})
            return
        if staged.available is not None and off + n > staged.available:
            await self._send_header(
                writer, {"error": f"range past stream watermark ({off},{n})"})
            return
        staged.deadline = time.monotonic() + self.max_transfer_time
        k, v = await staged.extract(off, n, False)
        kb, vb = host_bytes(k, staged.desc.dtype), host_bytes(v, staged.desc.dtype)
        await self._send_header(
            writer, {"off": off, "n": n, "k_bytes": len(kb), "v_bytes": len(vb)})
        writer.write(kb)
        writer.write(vb)
        await asyncio.wait_for(writer.drain(), self.chunk_timeout)
        staged.count_serve(len(kb) + len(vb))

    async def _serve_kvbm_blocks(self, req: dict, writer: asyncio.StreamWriter):
        """Serve tiered KV blocks by hash (the distributed KVBM onboard).
        One request -> one stacked (k, v) frame."""
        if self.kvbm_source is None:
            await self._send_header(writer, {"error": "no kvbm tier here"})
            return
        hashes = [int(h) for h in req["blocks"]]
        if not hashes or len(hashes) > 4096:
            await self._send_header(writer, {"error": f"bad block count {len(hashes)}"})
            return
        src = self.kvbm_source
        my_fmt = str(getattr(src, "kv_format", "none"))
        want_fmt = str(req.get("fmt", "none"))
        if want_fmt != my_fmt:
            # a mixed-precision fleet: refused typed before any block moves
            await self._send_header(writer, {
                "error": f"kv_format mismatch: serving {my_fmt}, peer wants {want_fmt}",
                "fmt_mismatch": True, "fmt": my_fmt})
            return
        try:
            # tier reads copy host memory or read the disk: off the event
            # loop, except small host-only reads (the executor round trip
            # would cost more than the copy)
            small = (getattr(src, "disk", None) is None
                     and getattr(src, "block_nbytes", 1 << 30) * len(hashes) <= (256 << 10))
            if small:
                k, v = src.load_blocks(hashes)
            else:
                k, v = await asyncio.get_running_loop().run_in_executor(
                    None, src.load_blocks, hashes)
        except KeyError as e:
            await self._send_header(writer, {"error": f"block miss: {e}"})
            return
        name = dtype_name(k.dtype)
        kb, vb = host_bytes(k, name), host_bytes(v, name)
        # header + payload in one buffered write and drain
        hdr_body = msgpack_lite.packb(
            {"n": len(hashes), "k_bytes": len(kb), "v_bytes": len(vb),
             "shape": list(k.shape), "dtype": name, "fmt": my_fmt})
        writer.write(_HDR.pack(_MAGIC, len(hdr_body)) + hdr_body)
        writer.write(kb)
        writer.write(vb)
        await asyncio.wait_for(writer.drain(), self.chunk_timeout)
        self.transfers_served += 1
        self.bytes_served += len(kb) + len(vb)

    async def _drain_payload(self, reader: asyncio.StreamReader, n: int):
        """Read and discard the `n` bytes of a refused push, so the kept
        connection stays framed for the next request."""
        while n > 0:
            chunk = await asyncio.wait_for(reader.read(min(n, 1 << 20)), self.chunk_timeout)
            if not chunk:
                raise asyncio.IncompleteReadError(b"", n)
            n -= len(chunk)

    async def _serve_checkpoint(self, meta: dict, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter):
        """A peer's session-checkpoint push into OUR tiers: the header names
        the hashes, their chain parents, the format and the sizes; the
        block bytes follow on the connection. A refusal drains the payload
        and answers typed before any byte is interpreted."""
        hashes = [int(h) for h in meta.get("blocks") or []]
        parents = [None if p is None else int(p)
                   for p in (meta.get("parents") or [None] * len(hashes))]
        k_bytes = int(meta.get("k_bytes") or 0)
        v_bytes = int(meta.get("v_bytes") or 0)
        payload = k_bytes + v_bytes
        if not hashes or len(hashes) > 4096 or len(parents) != len(hashes) or payload <= 0:
            raise RuntimeError(f"bad checkpoint push ({len(hashes)} blocks, {payload} bytes)")
        cap = CHECKPOINT_MAX_PAYLOAD
        if payload > cap:
            # well-formed but oversized: the pusher's sizing bug, answered on
            # the kept connection (a torn one would read as a dead peer)
            if payload > 2 * cap:
                raise RuntimeError(f"checkpoint push payload absurd ({payload} bytes)")
            await self._drain_payload(reader, payload)
            await self._send_header(writer, {
                "error": f"checkpoint payload too large ({payload} > {cap})",
                "peer_blameless": True})
            return
        src = self.kvbm_source
        if src is None:
            await self._drain_payload(reader, payload)
            await self._send_header(writer, {"error": "no kvbm tier here",
                                             "ckpt_ineligible": True})
            return
        my_fmt = str(getattr(src, "kv_format", "none"))
        want_fmt = str(meta.get("fmt", "none"))
        if want_fmt != my_fmt:
            await self._drain_payload(reader, payload)
            await self._send_header(writer, {
                "error": f"kv_format mismatch: holding {my_fmt}, peer pushes {want_fmt}",
                "fmt_mismatch": True, "fmt": my_fmt})
            return
        expect = int(np.prod(src.block_shape)) * src.dtype.itemsize * len(hashes)
        if k_bytes != expect or v_bytes != expect:
            # the block geometry is fixed for this process: structural
            await self._drain_payload(reader, payload)
            await self._send_header(writer, {
                "error": f"checkpoint size mismatch ({k_bytes}+{v_bytes} != 2x{expect})",
                "ckpt_ineligible": True})
            return
        raw = memoryview(await asyncio.wait_for(reader.readexactly(payload),
                                                self.chunk_timeout))
        name = dtype_name(src.dtype)
        shape = (len(hashes), *src.block_shape)
        k = tensor_from_bytes(raw[:k_bytes], name, shape)
        v = tensor_from_bytes(raw[k_bytes:], name, shape)

        def store():
            for i, h in enumerate(hashes):
                src.store(h, k[i], v[i], parent=parents[i])

        # tier stores copy host memory (and may cascade to disk): off the
        # event loop past the small-read threshold of the pull path
        if payload <= (256 << 10) and getattr(src, "disk", None) is None:
            store()
        else:
            await asyncio.get_running_loop().run_in_executor(None, store)
        self.checkpoint_pushes += 1
        self.checkpoint_blocks_received += len(hashes)
        if self.kvbm_distributed is not None:
            self.kvbm_distributed.note_checkpoint_received(hashes)
        await self._send_header(writer, {"ok": True, "stored": len(hashes)})

    async def _send_header(self, writer, header: dict):
        body = msgpack_lite.packb(header)
        writer.write(_HDR.pack(_MAGIC, len(body)) + body)
        await writer.drain()

    async def _stream(self, staged: _Staged, writer: asyncio.StreamWriter):
        desc = staged.desc

        # prefetch depth 1: extract chunk i+1 while chunk i drains into the
        # socket (the device gather and host copy overlap the network)
        async def get(off: int):
            n = min(desc.chunk_pages, desc.n_pages - off)
            await staged.wait_pages(off + n)  # no-op unless streamed
            k, v = await staged.extract(off, n, False)
            return off, n, host_bytes(k, desc.dtype), host_bytes(v, desc.dtype)

        # a zero-page transfer sends only the eof header: no empty segment
        # ever reaches the transport
        nxt = asyncio.ensure_future(get(0)) if desc.n_pages else None
        try:
            while nxt is not None:
                off, n, kb, vb = await nxt
                nxt = None
                f = faults.FAULTS
                if f.enabled and await f.on("kv_transfer.chunk") == "sever":
                    raise RuntimeError("injected: kv transfer severed mid-stream")
                if staged.finished:
                    # reaped (deadline hit) and the pages may be reused:
                    # abort so the peer sees a broken transfer
                    raise RuntimeError("transfer reaped mid-stream")
                after = off + n
                if after < desc.n_pages:
                    nxt = asyncio.ensure_future(get(after))
                await self._send_header(
                    writer, {"off": off, "n": n, "k_bytes": len(kb), "v_bytes": len(vb)})
                writer.write(kb)
                writer.write(vb)
                # a peer that stops reading must not pin pages
                await asyncio.wait_for(writer.drain(), self.chunk_timeout)
                self.bytes_served += len(kb) + len(vb)
                staged.deadline = time.monotonic() + self.max_transfer_time
        finally:
            if nxt is not None:
                nxt.cancel()
        await self._send_header(writer, {"eof": True})


class _ConnPool:
    """Keep-alive client connections to peer data planes, per event loop
    (weak-keyed: a connection made under one loop is never handed to
    another). Ranged requests are request-response and the server keeps
    their connections, so a puller reuses them instead of paying a TCP
    connect a request."""

    def __init__(self, per_addr: int = 4):
        import weakref

        self._pools: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
        self.per_addr = per_addr

    def _free_map(self) -> Dict[str, list]:
        loop = asyncio.get_running_loop()
        pools = self._pools.get(loop)
        if pools is None:
            pools = {}
            self._pools[loop] = pools
        return pools

    def evict(self, addr: str):
        """Close every pooled connection to `addr`."""
        for _, writer in self._free_map().pop(addr, []):
            writer.close()

    async def acquire(self, addr: str, connect_timeout: float, fresh: bool = False):
        """Returns (reader, writer, reused). `fresh=True` bypasses (and
        evicts) the pool: the retry after a stale keep-alive."""
        if fresh:
            self.evict(addr)
        else:
            free = self._free_map().get(addr)
            while free:
                reader, writer = free.pop()
                if writer.is_closing():
                    continue
                return reader, writer, True
        host, port = addr.rsplit(":", 1)
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection(host, int(port)), connect_timeout)
        except (OSError, asyncio.TimeoutError) as e:
            raise KvTransferError(f"kv data plane {addr} unreachable: {e}") from e
        _set_nodelay(writer)
        return reader, writer, False

    def release(self, addr: str, reader, writer):
        if writer.is_closing():
            return
        free = self._free_map().setdefault(addr, [])
        if len(free) >= self.per_addr:
            writer.close()
        else:
            free.append((reader, writer))


_CONN_POOL = _ConnPool()


# inject(page_offset, n_pages, k, v) — awaited per chunk as it lands
InjectFn = Callable[[int, int, Any, Any], Awaitable[None]]


async def _read_header(reader: asyncio.StreamReader, timeout: float) -> dict:
    hdr = await asyncio.wait_for(reader.readexactly(_HDR.size), timeout)
    magic, length = _HDR.unpack(hdr)
    if magic != _MAGIC:
        raise RuntimeError(f"bad kv frame magic {magic:#x}")
    if length > 65536:
        raise RuntimeError(f"oversized kv frame header ({length} bytes)")
    return msgpack_lite.unpackb(await asyncio.wait_for(reader.readexactly(length), timeout))


async def pull_kv_range(
    addr: str,
    transfer_id: str,
    off: int,
    n: int,
    page_shape: list,
    dtype: str,
    connect_timeout: float = 10.0,
    chunk_timeout: float = 30.0,
) -> Tuple[Any, Any]:
    """Fetch ONE chunk [off, off+n) of a staged transfer. Returns (k, v)
    shaped [L, n, ...] (CPU tensors off the socket; the extract's own
    tensors in process). The connection is kept for the next request; a
    stale kept connection earns one fresh retry."""
    staged = _LOCAL.get((addr, transfer_id))
    if staged is not None:
        staged.deadline = time.monotonic() + staged.max_transfer_time
        k, v = await staged.extract(off, n, True)
        staged.count_serve(int(k.nbytes + v.nbytes))
        return k, v
    shape = tuple(page_shape)
    max_bytes = int(np.prod(shape)) * wire_itemsize(dtype) * n
    for attempt in (0, 1):
        reader, writer, reused = await _CONN_POOL.acquire(
            addr, connect_timeout, fresh=attempt > 0)
        try:
            body = msgpack_lite.packb({"tid": transfer_id, "off": off, "n": n})
            writer.write(_HDR.pack(_MAGIC_RANGE, len(body)) + body)
            await writer.drain()
            header = await _read_header(reader, chunk_timeout)
            if header.get("error"):
                _CONN_POOL.release(addr, reader, writer)
                raise KvTransferError(f"kv range refused: {header['error']}")
            if header["k_bytes"] > max_bytes or header["v_bytes"] > max_bytes:
                raise RuntimeError("kv range frame larger than requested")
            k_raw = await asyncio.wait_for(reader.readexactly(header["k_bytes"]), chunk_timeout)
            v_raw = await asyncio.wait_for(reader.readexactly(header["v_bytes"]), chunk_timeout)
            _CONN_POOL.release(addr, reader, writer)
            chunk_shape = (shape[0], n, *shape[1:])
            return (tensor_from_bytes(k_raw, dtype, chunk_shape),
                    tensor_from_bytes(v_raw, dtype, chunk_shape))
        except KvTransferError:
            raise
        except (ConnectionError, asyncio.IncompleteReadError, asyncio.TimeoutError) as e:
            writer.close()
            if reused and attempt == 0:
                continue  # stale keep-alive: the server idled it out
            raise KvTransferError(f"kv range pull from {addr} failed: {e}") from e
        except BaseException:
            writer.close()
            raise


async def finish_transfer(addr: str, transfer_id: str, connect_timeout: float = 10.0) -> None:
    """Tell the staging peer a range-pulled transfer is complete so its
    pages release now (the TTL reaper is the backstop)."""
    staged = _LOCAL.get((addr, transfer_id))
    if staged is not None:
        _LOCAL.pop((addr, transfer_id), None)
        staged.finish(True)
        return
    reader, writer, _ = await _CONN_POOL.acquire(addr, connect_timeout, fresh=True)
    try:
        body = msgpack_lite.packb({"tid": transfer_id, "fin": True})
        writer.write(_HDR.pack(_MAGIC_RANGE, len(body)) + body)
        await writer.drain()
        await _read_header(reader, connect_timeout)
    finally:
        writer.close()


async def pull_kv(
    desc: KvTransferDescriptor,
    inject: InjectFn,
    connect_timeout: float = 10.0,
    chunk_timeout: float = 30.0,
) -> None:
    """Decode-side pull: stream chunks from the staging peer and inject each
    while the rest are in flight. Raises on any failure (the caller falls
    back to local prefill). In-process transfers short-circuit through the
    local registry and stay on the device."""
    staged = _LOCAL.get((desc.addr, desc.transfer_id))
    if staged is not None and not staged.started:
        staged.started = True
        staged.deadline = time.monotonic() + staged.max_transfer_time
        try:
            off = 0
            while off < desc.n_pages:
                if staged.finished:
                    raise KvTransferError("transfer reaped mid-pull")
                n = min(desc.chunk_pages, desc.n_pages - off)
                await staged.wait_pages(off + n)  # no-op unless streamed
                k, v = await staged.extract(off, n, True)
                if staged.failed or staged.finished:
                    # the producer aborted while we extracted (its pages may
                    # be recycled): never inject the chunk
                    raise KvTransferError("transfer aborted mid-pull")
                await inject(off, n, k, v)
                staged.count_serve(int(k.nbytes + v.nbytes))
                off += n
                staged.deadline = time.monotonic() + staged.max_transfer_time
            if staged.failed:
                raise KvTransferError("transfer aborted mid-pull")
        except BaseException:
            staged.finish(False)
            raise
        finally:
            _LOCAL.pop((desc.addr, desc.transfer_id), None)
        staged.finish(True)
        return

    if desc.streamed:
        # producer-paced: the gap between chunks is bounded by the
        # producer's liveness budget, not the network's chunk timeout
        chunk_timeout = max(chunk_timeout, 120.0)
    host, port = desc.addr.rsplit(":", 1)
    try:
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(host, int(port)), connect_timeout)
    except (OSError, asyncio.TimeoutError) as e:
        raise KvTransferError(f"kv data plane {desc.addr} unreachable: {e}") from e
    _set_nodelay(writer)
    try:
        tid = desc.transfer_id.encode()
        writer.write(_HDR.pack(_MAGIC, len(tid)) + tid)
        await writer.drain()
        shape = tuple(desc.page_shape)
        # every frame size is checked against what the descriptor implies:
        # a misbehaving peer cannot force a huge allocation
        max_chunk_bytes = int(np.prod(shape)) * wire_itemsize(desc.dtype) * max(desc.chunk_pages, 1)
        while True:
            header = await _read_header(reader, chunk_timeout)
            if header.get("error"):
                raise KvTransferError(f"kv transfer refused: {header['error']}")
            if header.get("eof"):
                return
            off, n = header["off"], header["n"]
            if not (0 <= off and 0 < n <= desc.chunk_pages and off + n <= desc.n_pages):
                raise RuntimeError(f"kv chunk out of range (off={off} n={n})")
            if header["k_bytes"] > max_chunk_bytes or header["v_bytes"] > max_chunk_bytes:
                raise RuntimeError(
                    f"kv frame larger than descriptor allows ({header['k_bytes']})")
            k_raw = await asyncio.wait_for(reader.readexactly(header["k_bytes"]), chunk_timeout)
            v_raw = await asyncio.wait_for(reader.readexactly(header["v_bytes"]), chunk_timeout)
            chunk_shape = (shape[0], n, *shape[1:])
            await inject(off, n, tensor_from_bytes(k_raw, desc.dtype, chunk_shape),
                         tensor_from_bytes(v_raw, desc.dtype, chunk_shape))
    finally:
        writer.close()


async def pull_kvbm_blocks(
    addr: str,
    hashes,
    block_shape: tuple,
    dtype: torch.dtype,
    connect_timeout: float = 10.0,
    chunk_timeout: float = 30.0,
    kv_format: str = "none",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fetch tiered KV blocks by hash from a peer's data plane. Returns
    (k, v) CPU tensors stacked `[n, *block_shape]`. Raises KeyError on a
    block miss or refusal, KvTransferError on a transport failure (both
    fall back to recompute in the onboard path), and KvFormatError when the
    peer's tiers hold another KV page format. Connections come from the
    keep-alive pool; a stale pooled connection earns one fresh retry."""
    name = dtype_name(dtype)
    itemsize = dtype.itemsize
    f = faults.FAULTS
    for attempt in (0, 1):
        reader, writer, reused = await _CONN_POOL.acquire(
            addr, connect_timeout, fresh=attempt > 0)
        try:
            body = msgpack_lite.packb({"blocks": [int(h) for h in hashes],
                                       "fmt": str(kv_format)})
            writer.write(_HDR.pack(_MAGIC_RANGE, len(body)) + body)
            await writer.drain()
            if f.enabled and await f.on("kv_transfer.pull") == "sever":
                # the request is on the wire; the connection drops before
                # the payload lands
                raise KvTransferError("injected: kvbm peer pull severed")
            expect = int(np.prod(block_shape)) * itemsize * len(hashes)
            header = await _read_header(reader, chunk_timeout)
            if header.get("error"):
                # a protocol-level refusal: the connection is still good
                _CONN_POOL.release(addr, reader, writer)
                if header.get("fmt_mismatch"):
                    raise KvFormatError(
                        f"kvbm peer {addr} serves kv_format={header.get('fmt')!r}, "
                        f"we run {kv_format!r}")
                raise KeyError(f"kvbm pull refused: {header['error']}")
            if header["k_bytes"] > expect or header["v_bytes"] > expect:
                raise RuntimeError("kvbm frame larger than expected")
            # k and v are contiguous on the wire: one read, split by offset
            raw = await asyncio.wait_for(
                reader.readexactly(header["k_bytes"] + header["v_bytes"]), chunk_timeout)
            _CONN_POOL.release(addr, reader, writer)
            shape = (len(hashes), *block_shape)
            view = memoryview(raw)
            return (tensor_from_bytes(view[:header["k_bytes"]], name, shape),
                    tensor_from_bytes(view[header["k_bytes"]:], name, shape))
        except (KeyError, KvFormatError):
            raise
        except (ConnectionError, asyncio.IncompleteReadError, TimeoutError,
                asyncio.TimeoutError) as e:
            writer.close()
            if reused and attempt == 0:
                continue  # stale keep-alive: the server idled it out
            raise KvTransferError(f"kvbm peer pull from {addr} failed: {e}") from e
        except BaseException:
            writer.close()
            raise


def _block_bytes(x) -> memoryview:
    """Raw bytes of stacked host blocks: a numpy array or a tensor (a bf16
    tensor as its 16-bit words)."""
    if isinstance(x, np.ndarray):
        return host_bytes(x, "")
    return host_bytes(x, dtype_name(x.dtype))


async def push_checkpoint_blocks(
    addr: str,
    hashes: Sequence[int],
    parents: Sequence[Optional[int]],
    k,
    v,
    kv_format: str = "none",
    connect_timeout: float = 2.0,
    chunk_timeout: float = 30.0,
) -> int:
    """Push session-checkpoint blocks into a peer's host tier. `k`/`v` are
    stacked `[n, *block_shape]` host blocks in this worker's `kv_format`.
    Returns the number of blocks the peer stored. Raises KvFormatError when
    the peer holds another format, KvTransferError on a refusal (with
    `ckpt_ineligible` set for a structural one, `peer_blameless` for an
    oversized batch) or a transport failure. A stale pooled connection earns
    one fresh retry."""
    kb, vb = _block_bytes(k), _block_bytes(v)
    for attempt in (0, 1):
        reader, writer, reused = await _CONN_POOL.acquire(
            addr, connect_timeout, fresh=attempt > 0)
        try:
            body = msgpack_lite.packb({"ckpt": {
                "blocks": [int(h) for h in hashes],
                "parents": [None if p is None else int(p) for p in parents],
                "fmt": str(kv_format),
                "k_bytes": len(kb),
                "v_bytes": len(vb),
            }})
            writer.write(_HDR.pack(_MAGIC_RANGE, len(body)) + body)
            writer.write(kb)
            writer.write(vb)
            await asyncio.wait_for(writer.drain(), chunk_timeout)
            header = await _read_header(reader, chunk_timeout)
            if header.get("error"):
                _CONN_POOL.release(addr, reader, writer)
                if header.get("fmt_mismatch"):
                    raise KvFormatError(
                        f"checkpoint peer {addr} holds kv_format={header.get('fmt')!r}, "
                        f"we push {kv_format!r}")
                err = KvTransferError(f"checkpoint push refused: {header['error']}")
                err.ckpt_ineligible = bool(header.get("ckpt_ineligible"))
                err.peer_blameless = bool(header.get("peer_blameless"))
                raise err
            _CONN_POOL.release(addr, reader, writer)
            return int(header.get("stored") or 0)
        except KvTransferError:
            raise
        except (ConnectionError, asyncio.IncompleteReadError, TimeoutError,
                asyncio.TimeoutError) as e:
            writer.close()
            if reused and attempt == 0:
                continue  # stale keep-alive: one fresh retry
            raise KvTransferError(f"checkpoint push to {addr} failed: {e}") from e
        except BaseException:
            writer.close()
            raise
