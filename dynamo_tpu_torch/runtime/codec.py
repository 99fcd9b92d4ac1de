"""Two-part wire codec for the request/response planes.

Port of `dynamo_tpu/runtime/codec.py`, byte for byte on the wire: every
message is a control header (msgpack map) plus an opaque payload,
length-prefixed so it can be streamed over a raw TCP connection. Headers
and payloads are packed by `msgpack_lite`, the standard-library subset of
msgpack whose bytes equal `msgpack.packb(..., use_bin_type=True)`, so a
reference peer reads them with the real msgpack.

Frame layout (little-endian):
    u32 magic 0xD7A0C0DE | u32 header_len | u32 payload_len | header | payload
"""

from __future__ import annotations

import asyncio
import struct
from array import array
from typing import Any, List, Optional, Tuple

from . import msgpack_lite

MAGIC = 0xD7A0C0DE
_HDR = struct.Struct("<III")
MAX_FRAME = 1 << 30  # 1 GiB sanity bound

# --------------------------------------------------------------------- #
# Wire-frame tag registry
# --------------------------------------------------------------------- #
# The single spelling of every dispatch tag the serving plane's framed
# protocols put on the wire. Producers and consumers import these
# constants. The spellings are the reference's (docs/wire_protocol.md):
# a port worker and a reference frontend share one wire.

# request/response plane, "t" channel (runtime/request_plane.py)
T_REQ = "req"
T_CANCEL = "cancel"
T_PING = "ping"
T_PONG = "pong"
T_DATA = "data"
T_DONE = "done"
T_ERR = "err"
T_LOST = "lost"  # synthesized client-side on connection loss; never sent

# discovery control plane, "op" channel (runtime/discovery.py)
OP_PUT = "put"
OP_CREATE = "create"
OP_GET = "get"
OP_GET_PREFIX = "get_prefix"
OP_DELETE = "delete"
OP_DELETE_PREFIX = "delete_prefix"
OP_LEASE_GRANT = "lease_grant"
OP_LEASE_KEEPALIVE = "lease_keepalive"
OP_LEASE_REVOKE = "lease_revoke"
OP_WATCH = "watch"
OP_UNWATCH = "unwatch"
OP_PUBLISH = "publish"
OP_SUBSCRIBE = "subscribe"
OP_UNSUBSCRIBE = "unsubscribe"
OP_STATUS = "status"

# discovery server->client pushes, "push" channel (runtime/discovery.py)
PUSH_WATCH = "watch"
PUSH_MSG = "msg"

# payload encodings riding T_DATA frames, "enc" channel
# (runtime/request_plane.py).  Absent = msgpack (the default payload
# serializer).  A stream NEGOTIATES binary encodings: the client's T_REQ
# carries `bin: 1` and the server answers pure token-delta batches with
# `enc: "tok"` frames; anything the encoding cannot carry (finish
# reasons, logprobs, text riders) falls back to msgpack per frame.
ENC_TOK = "tok"

# machine-readable error codes riding T_ERR frames, "code" channel
# (runtime/request_plane.py).  The human `error` string is for logs; the
# code is what clients DISPATCH on.
ERR_DRAINING = "draining"
ERR_DEADLINE = "deadline"

FRAME_TAGS = {
    "t": {
        T_REQ: "open a stream: subject + packed request payload",
        T_CANCEL: "cancel a stream (kill=bool: hard vs graceful stop)",
        T_PING: "transport liveness probe",
        T_PONG: "liveness probe reply",
        T_DATA: "one stream item (n=k: payload is k coalesced items)",
        T_DONE: "clean end of stream",
        T_ERR: "terminal stream error (code=draining: retry elsewhere)",
        T_LOST: "local marker: connection died mid-stream (never on wire)",
    },
    "op": {
        OP_PUT: "write a key (optionally lease-attached)",
        OP_CREATE: "atomic create: fails if the key exists",
        OP_GET: "read one key",
        OP_GET_PREFIX: "read all keys under a prefix",
        OP_DELETE: "delete one key",
        OP_DELETE_PREFIX: "delete all keys under a prefix",
        OP_LEASE_GRANT: "grant a TTL lease",
        OP_LEASE_KEEPALIVE: "refresh a lease's deadline",
        OP_LEASE_REVOKE: "revoke a lease (deletes attached keys)",
        OP_WATCH: "start a prefix watch (reply carries snapshot)",
        OP_UNWATCH: "end a prefix watch",
        OP_PUBLISH: "fan a payload out to topic subscribers",
        OP_SUBSCRIBE: "subscribe to a topic",
        OP_UNSUBSCRIBE: "end a topic subscription",
        OP_STATUS: "server status snapshot",
    },
    "push": {
        PUSH_WATCH: "server-pushed watch event (type=put|delete)",
        PUSH_MSG: "server-pushed topic message",
    },
    "enc": {
        ENC_TOK: "T_DATA payload is packed u32 token deltas (zero-copy "
                 "token path), not msgpack; absent enc = msgpack",
    },
}

#: wire error codes on T_ERR frames (the "code" channel)
ERR_CODES = {
    ERR_DRAINING: "worker draining: clients treat as StreamLost and retry "
                  "another instance",
    ERR_DEADLINE: "end-to-end deadline passed worker-side: clients raise "
                  "DeadlineExceeded so migration stops retrying",
}


def encode_frame(control: dict, payload: bytes = b"") -> bytes:
    header = msgpack_lite.packb(control)
    return _HDR.pack(MAGIC, len(header), len(payload)) + header + payload


def decode_frame(buf: bytes) -> Tuple[dict, bytes]:
    magic, hlen, plen = _HDR.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic:#x}")
    off = _HDR.size
    header = msgpack_lite.unpackb(buf[off : off + hlen])
    payload = bytes(buf[off + hlen : off + hlen + plen])
    return header, payload


async def read_frame(reader: asyncio.StreamReader) -> Optional[Tuple[dict, bytes]]:
    """Read one frame; returns None on clean EOF at a frame boundary."""
    try:
        head = await reader.readexactly(_HDR.size)
    except (asyncio.IncompleteReadError, ConnectionResetError):
        return None
    magic, hlen, plen = _HDR.unpack(head)
    if magic != MAGIC:
        raise ValueError(f"bad frame magic {magic:#x}")
    if hlen + plen > MAX_FRAME:
        raise ValueError(f"frame too large: {hlen + plen}")
    body = await reader.readexactly(hlen + plen)
    header = msgpack_lite.unpackb(body[:hlen])
    return header, body[hlen:]


async def write_frame(
    writer: asyncio.StreamWriter, control: dict, payload: bytes = b""
):
    # corked write: hand the transport the segments in one call instead of
    # concatenating header+payload into a fresh buffer — on the token hot
    # path the payload is the large part and must not be copied. An empty
    # payload is left out: CPython 3.12's selector transport keeps an empty
    # segment queued behind a partial send forever (`_adjust_leftover_buffer`
    # stops at 0 bytes), and its writer callback then spins at 100 % CPU.
    header = msgpack_lite.packb(control)
    head = _HDR.pack(MAGIC, len(header), len(payload))
    writer.writelines((head, header, payload) if payload else (head, header))
    await writer.drain()


def pack(obj: Any) -> bytes:
    """Payload serializer used across the request plane."""
    return msgpack_lite.packb(obj)


def unpack(data: bytes) -> Any:
    return msgpack_lite.unpackb(data)


# --------------------------------------------------------------------- #
# ENC_TOK binary token-delta payload (zero-copy token path)
# --------------------------------------------------------------------- #
# Steady-state decode traffic is a stream of pure token deltas — either
# bare `{"token_ids": [...]}` dicts or the engines' Annotated wrapper
# `{"data": {"token_ids": [...]}}`; encoding each as a msgpack map (and
# re-materializing k dicts per frame on the frontend) is pure per-token
# overhead. ENC_TOK packs a whole coalesced batch of one shape as flat
# little-endian u32s:
#
#     u32 n_items | u32 flags | u32 len[n_items] | u32 ids[sum(len)]
#
# `flags` bit 0 records the wrapper (0 = bare, 1 = Annotated-wrapped) so
# decode reproduces the msgpack path's dicts SHAPE-identically; all other
# bits are reserved — a future variant sets one, and decoders reject what
# they don't speak instead of misreading. Item boundaries are preserved.

_TOK_HDR = struct.Struct("<II")
_TOK_FLAG_WRAPPED = 1  # items were {"data": {"token_ids": [...]}}
# array typecode with a 4-byte item (platform-dependent: "I" on every
# supported platform, "L" kept as a guard for exotic ABIs)
_U32 = "I" if array("I").itemsize == 4 else "L"
assert array(_U32).itemsize == 4, "no 4-byte unsigned array typecode"
_BIG_ENDIAN = struct.pack("=I", 1) != struct.pack("<I", 1)


def token_delta_kind(item: Any) -> int:
    """0 = not a pure token delta (must ride msgpack); 1 = bare
    `{"token_ids": [...]}`; 2 = Annotated-wrapped
    `{"data": {"token_ids": [...]}}` (what the engines emit). Anything
    else — finish reasons, text riders, logprobs, annotation events —
    forces the frame back to msgpack. Shape-only (hot path): id VALUES
    are validated by the array pack itself, which raises on anything
    outside u32 and falls back to msgpack (try_pack_token_run)."""
    if type(item) is not dict or len(item) != 1:
        return 0
    ids = item.get("token_ids")
    if ids is not None:
        return 1 if type(ids) is list and ids else 0
    d = item.get("data")
    if type(d) is dict and len(d) == 1:
        ids = d.get("token_ids")
        if type(ids) is list and ids:
            return 2
    return 0


def pack_token_items(items: List[dict], wrapped: bool = False) -> bytes:
    """Encode pure token-delta items of ONE shape (`wrapped` selects the
    Annotated wrapper); the caller guarantees a uniform
    `token_delta_kind` for every item. Raises TypeError/OverflowError on
    ids outside u32 — callers fall back to msgpack."""
    if wrapped:
        items = [it["data"] for it in items]
    lens = array(_U32, [len(it["token_ids"]) for it in items])
    ids = array(_U32)
    for it in items:
        ids.extend(it["token_ids"])
    if _BIG_ENDIAN:  # wire order is little-endian
        lens.byteswap()
        ids.byteswap()
    flags = _TOK_FLAG_WRAPPED if wrapped else 0
    return _TOK_HDR.pack(len(items), flags) + lens.tobytes() + ids.tobytes()


def try_pack_token_run(items: List[Any]) -> Optional[Tuple[bytes, int]]:
    """Pack the LEADING run of pure same-shape token deltas as an ENC_TOK
    payload. Returns (payload, run_length), or None when items[0] is not
    a clean token delta (the whole batch then rides msgpack)."""
    kind = token_delta_kind(items[0])
    if not kind:
        return None
    pos = 1
    while pos < len(items) and token_delta_kind(items[pos]) == kind:
        pos += 1
    try:
        return pack_token_items(items[:pos], wrapped=kind == 2), pos
    except (TypeError, OverflowError):
        # exotic ids (negative, > u32, non-int): msgpack carries anything
        return None


def unpack_token_items(payload: bytes, merge: bool = False) -> List[dict]:
    """Decode an ENC_TOK payload back into item dicts, in order.

    merge=False reproduces the msgpack path's items shape- and
    boundary-identically. merge=True returns ONE item carrying the whole
    frame's ids — the request-plane client uses this: item boundaries
    inside a frame of pure token deltas carry no information (the
    frontend's merge_token_deltas concatenates every same-tick delta
    anyway), and one dict per frame instead of k is most of the decode
    saving. Token counts, order, and the wrapper shape are preserved."""
    n_items, flags = _TOK_HDR.unpack_from(payload, 0)
    if flags & ~_TOK_FLAG_WRAPPED:
        raise ValueError(f"unknown ENC_TOK flags {flags:#x}")
    wrapped = bool(flags & _TOK_FLAG_WRAPPED)
    off = _TOK_HDR.size
    lens = array(_U32)
    lens.frombytes(payload[off : off + 4 * n_items])
    off += 4 * n_items
    ids = array(_U32)
    ids.frombytes(payload[off:])
    if _BIG_ENDIAN:
        lens.byteswap()
        ids.byteswap()
    total = sum(lens)
    if total != len(ids):
        raise ValueError(
            f"ENC_TOK payload inconsistent: lens sum {total} != {len(ids)} ids"
        )
    if merge:
        d: dict = {"token_ids": ids.tolist()}
        return [{"data": d} if wrapped else d]
    out: List[dict] = []
    pos = 0
    tolist = ids.tolist()
    for n in lens:
        d = {"token_ids": tolist[pos : pos + n]}
        out.append({"data": d} if wrapped else d)
        pos += n
    return out
