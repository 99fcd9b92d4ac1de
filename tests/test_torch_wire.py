"""The port's wire bytes against the reference's.

A reference frontend decodes a port worker's frames with the real msgpack
(and the reverse), so `msgpack_lite` must produce the bytes
`msgpack.packb(obj, use_bin_type=True)` produces — not only a value that
decodes the same — and read what msgpack writes. Checked over generated
value trees, every integer and length boundary, and every control header
the reference's request plane and discovery actually send.
"""

import asyncio

import msgpack
import pytest
from hypothesis import given, settings, strategies as st

from dynamo_tpu.runtime import codec as ref_codec
from dynamo_tpu_torch.runtime import codec, msgpack_lite

INT_BOUNDS = [
    0, 1, 31, 32, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32,
    2**63 - 1, 2**63, 2**64 - 1,
    -1, -31, -32, -33, -127, -128, -129, -32767, -32768, -32769,
    -2**31 + 1, -2**31, -2**31 - 1, -2**63 + 1, -2**63,
]
LEN_BOUNDS = [0, 1, 15, 16, 31, 32, 255, 256, 65535, 65536]


def ref_packb(obj):
    return msgpack.packb(obj, use_bin_type=True)


def same(obj):
    got = msgpack_lite.packb(obj)
    want = ref_packb(obj)
    assert got == want, (repr(obj)[:80], got[:24], want[:24])
    assert msgpack_lite.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("n", INT_BOUNDS)
def test_int_boundaries(n):
    same(n)
    same([n, -n if -n >= -2**63 else 0])


@pytest.mark.parametrize("n", LEN_BOUNDS)
def test_length_boundaries(n):
    same("x" * n)
    same("é" * (n // 2))  # utf-8 bytes, not characters, set the header
    same(b"\x01" * n)
    same(bytearray(b"\x02" * n))
    same(memoryview(b"\x03" * n))
    same(list(range(n)))
    same(tuple([None] * n))
    same({f"k{i}": i for i in range(n)})


@pytest.mark.parametrize("obj", [
    None, True, False, 0.0, -0.0, 1.5, 1e300, -2.5e-310, float("inf"), float("-inf"),
    [True, 1, 1.0], {"a": {"b": [{"c": None}]}}, {b"raw": 1},
])
def test_scalars_and_nesting(obj):
    same(obj)


values = st.recursive(
    st.none() | st.booleans() | st.integers(-2**63, 2**64 - 1)
    | st.floats(allow_nan=False) | st.text(max_size=70) | st.binary(max_size=300),
    lambda inner: st.lists(inner, max_size=20)
    | st.tuples(inner, inner)
    | st.dictionaries(st.text(max_size=40), inner, max_size=20),
    max_leaves=60,
)


@settings(max_examples=300, deadline=None)
@given(values)
def test_generated_trees_pack_byte_equal(obj):
    same(obj)


@pytest.mark.parametrize("bad,exc", [
    (2**64, OverflowError), (-2**63 - 1, OverflowError), (object(), TypeError),
    ({1: {2.0j}}, TypeError),
])
def test_pack_errors_match_msgpack(bad, exc):
    with pytest.raises(exc):
        ref_packb(bad)
    with pytest.raises(exc):
        msgpack_lite.packb(bad)


@pytest.mark.parametrize("data", [
    ref_packb(msgpack.ExtType(1, b"x")),  # ext types are not spoken
    b"\x92\x01",  # truncated
    b"\x01\x02",  # trailing bytes
    ref_packb({1: 2}),  # non-str map key (strict_map_key)
    b"\xc1",  # the never-used tag
])
def test_unpack_errors_raise_value_error(data):
    with pytest.raises(ValueError):
        msgpack_lite.unpackb(data)


def test_float32_decodes():
    assert msgpack_lite.unpackb(msgpack.packb(1.5, use_single_float=True)) == 1.5


def capture_reference_frames():
    """Every (control, payload) the reference's request plane and discovery
    write in one exchange: discovery ops and pushes, streams with and without
    the binary token path, coalesced frames, cancel, ping/pong, errors."""
    from dynamo_tpu.runtime import (
        Context, DiscoveryServer, DistributedRuntime, RuntimeConfig, StreamLost,
    )

    frames = []
    real = ref_codec.write_frame

    async def recording(writer, control, payload=b""):
        # the reference's bytes in one write: its corked three-segment
        # write leaves an empty payload segment queued on CPython 3.12,
        # and the connection then never closes (see single_write_frames
        # in test_torch_runtime.py)
        frames.append((dict(control), bytes(payload)))
        writer.write(ref_codec.encode_frame(control, payload))
        await writer.drain()

    async def handler(request, context):
        n = request.get("n", 3)
        for i in range(n):
            yield {"data": {"token_ids": [i, i + 1]}}
            yield {"token_ids": [100 + i]}
            if context.is_stopped():
                break
            await asyncio.sleep(0)
        if request.get("fail"):
            raise RuntimeError("boom")
        yield {"data": {"token_ids": [], "finish_reason": "length"}, "usage": {"x": 1.5}}

    async def exchange():
        server = DiscoveryServer(port=0)
        _, port = await server.start()
        cfg = RuntimeConfig.from_settings()
        cfg.discovery_endpoint = f"tcp://127.0.0.1:{port}"
        worker = await DistributedRuntime.create(cfg)
        await worker.namespace("ns").component("c").endpoint("gen").serve_endpoint(handler)
        fe = await DistributedRuntime.create(cfg)
        client = await fe.namespace("ns").component("c").endpoint("gen").client()
        await client.wait_for_instances(10)
        for binary in (True, False):
            fe.client.binary_tokens = binary
            async for _ in await client.generate({"n": 4}):
                pass
        ctx = Context()
        async for _ in await client.generate({"n": 50}, ctx):
            ctx.stop_generating()
        with pytest.raises(Exception):
            async for _ in await client.generate({"fail": True}):
                pass
        inst = client.instances[worker.instance_id]
        await fe.client.ping(inst.address)
        d = fe.discovery
        watch = await d.watch_prefix("k/")
        sub = await d.subscribe("topic")
        await d.put("k/a", b"v", fe.primary_lease)
        assert await d.create("k/b", b"w") and not await d.create("k/b", b"w")
        await d.get("k/a")
        await d.get("missing")
        await d.get_prefix("k/")
        await d.publish("topic", b"\x00payload")
        await sub.get(5)
        await d.delete("k/a")
        await d.delete_prefix("k/")
        await d.status()
        lease = await d.grant_lease(ttl=5.0, keepalive=False)
        await d._call({"op": "lease_keepalive", "lease_id": lease.lease_id})
        await lease.revoke()
        await watch.cancel()
        await sub.cancel()
        await client.close()
        await worker.close()  # graceful: draining put, lease revoke
        await fe.close()
        await server.stop()

    ref_codec.write_frame = recording
    try:
        asyncio.run(asyncio.wait_for(exchange(), 60))
    finally:
        ref_codec.write_frame = real
    return frames


@pytest.fixture(scope="module")
def reference_frames():
    frames = capture_reference_frames()
    tags = {c.get("t") or c.get("op") or c.get("push") for c, _ in frames}
    # the exchange reached every kind of frame it is meant to
    for t in ("req", "data", "done", "err", "cancel", "ping", "pong", "put", "create",
              "get", "get_prefix", "delete", "delete_prefix", "lease_grant",
              "lease_keepalive", "lease_revoke", "watch", "unwatch", "publish",
              "subscribe", "unsubscribe", "status", "msg"):
        assert t in tags, t
    assert any(c.get("enc") == "tok" for c, _ in frames)
    assert any(c.get("n") and "enc" not in c for c, _ in frames)
    return frames


def test_every_reference_control_header_encodes_byte_equal(reference_frames):
    for control, payload in reference_frames:
        want = ref_codec.encode_frame(control, payload)
        assert codec.encode_frame(control, payload) == want, control
        assert codec.decode_frame(want) == (control, payload)
        if payload and control.get("enc") is None and control.get("op") not in (
                "put", "create", "publish") and not control.get("push") \
                and "found" not in control:
            # msgpack payloads (stream items, snapshots) pack byte-equal too
            obj = msgpack.unpackb(payload, raw=False)
            assert codec.pack(obj) == payload, control
            assert codec.unpack(payload) == obj


def test_token_items_pack_byte_equal():
    for wrapped in (False, True):
        items = [{"token_ids": [1, 2, 3]}, {"token_ids": [2**32 - 1]}, {"token_ids": [0] * 70}]
        if wrapped:
            items = [{"data": it} for it in items]
        assert codec.pack_token_items(items, wrapped) == ref_codec.pack_token_items(items, wrapped)
        payload = ref_codec.pack_token_items(items, wrapped)
        for merge in (False, True):
            assert codec.unpack_token_items(payload, merge) == \
                ref_codec.unpack_token_items(payload, merge)
        assert codec.try_pack_token_run(items + [{"x": 1}]) == \
            ref_codec.try_pack_token_run(items + [{"x": 1}])


def test_codec_constants_match_reference():
    assert codec.FRAME_TAGS == ref_codec.FRAME_TAGS
    assert codec.ERR_CODES == ref_codec.ERR_CODES
    assert codec.MAGIC == ref_codec.MAGIC and codec.MAX_FRAME == ref_codec.MAX_FRAME
