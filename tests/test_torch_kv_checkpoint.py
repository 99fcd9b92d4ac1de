"""The port's session checkpointer against the JAX package's, on the CPU.

* The checkpointer's discipline, case for case as the reference's own unit
  tests hold it (`tests/test_migration_durable.py`): DYN_KV_CHECKPOINT
  parsing, the ring-successor peer, the sync answer re-tagging replicas, a
  bounded stage that refuses the newest block and poisons its descendants,
  poison that expires and is repaired by a re-offer, durable ineligibility,
  batches capped by bytes, a read-time hole's descendants not pushed, a
  block over the payload cap shed without dialing, a structural refusal
  routed to ineligibility (and a blameless one to nothing), the tier-less
  data plane's typed refusals, and promotion batches not staged.
* Checkpoint pushes across packages, both ways, bf16 pages and packed int8
  rows: a JAX push into a port data plane and a port push into a JAX one;
  the pushed bytes land in the receiver's host tier unchanged, the blocks
  are tagged and announced as `checkpoint`, and both pushers put the same
  bytes on the wire. A `kv_format` mismatch is refused typed, and the
  checkpointer makes such a peer ineligible.
"""

import asyncio
import signal
import struct
import time

import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.kvbm import KvbmDistributed as RefDistributed
from dynamo_tpu.kvbm.manager import KvBlockManager as RefManager
from dynamo_tpu.kvbm.manager import KvbmConfig as RefConfig
from dynamo_tpu.llm import kv_transfer as jkt
from dynamo_tpu.runtime import codec as ref_codec
from dynamo_tpu_torch.kvbm import KvbmDistributed
from dynamo_tpu_torch.kvbm.checkpoint import KvCheckpointer, checkpoint_queue_blocks
from dynamo_tpu_torch.kvbm.manager import KvBlockManager, KvbmConfig, KvbmConnector
from dynamo_tpu_torch.llm import kv_transfer as tkt
from dynamo_tpu_torch.runtime import codec

from .test_torch_kvbm_fabric import _FakeEngine, _to_port

LIMIT = 30
HDR = struct.Struct("<II")
MAGIC = 0xD7A04B1D
BLOCK = (2, 8, 2, 16)  # layers, page, KV heads, head dim
FORMATS = {
    # name: (kv_format, block shape, reference numpy dtype, port torch dtype)
    "bfloat16": ("none", BLOCK, ml_dtypes.bfloat16, torch.bfloat16),
    "int8_rows": ("int8", (2, 600), np.uint8, torch.uint8),
}


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {2 * LIMIT} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(2 * LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


def _raw(x) -> bytes:
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


class _NoDrt:
    discovery = None


def _bare(instance_id, addrs=None):
    """A mesh member with no discovery: enough for peer selection."""
    conn = KvbmConnector(_FakeEngine(), KvBlockManager(KvbmConfig(host_blocks=2),
                                                       (1, 2, 2, 2), torch.float32))
    d = KvbmDistributed(_NoDrt(), conn, None, "ns", "comp", instance_id)
    d._addrs = dict(addrs or {1: "a1", 2: "a2", 3: "a3"})
    return d


class _StubDist:
    """The checkpointer's view of the mesh: one peer, recorded verdicts."""

    _loop = None

    def __init__(self, manager):
        self.manager = manager
        self.ineligible, self.quarantined = [], []

    def checkpoint_peer(self):
        return 7, "addr7"

    def note_checkpoint_ineligible(self, inst):
        self.ineligible.append(inst)

    def note_peer_failure(self, inst):
        self.quarantined.append(inst)


class _StubManager:
    kv_format = "none"

    def __init__(self, block_nbytes=64, missing=()):
        self.block_nbytes = block_nbytes
        self.missing = set(missing)

    def read_blocks(self, hashes):
        present = [h for h in hashes if h not in self.missing]
        k = torch.zeros((len(present), 2))
        return present, k, k


# ---------------------------------------------------------------------- #
# the checkpointer's discipline (the reference's unit cases)
# ---------------------------------------------------------------------- #


def test_checkpoint_env_parsing():
    for raw, want in (("off", 0), ("", 0), ("0", 0), ("128", 128), ("garbage", 0)):
        assert checkpoint_queue_blocks(raw) == want, raw


def test_checkpoint_peer_ring_spreads_replication():
    assert _bare(1).checkpoint_peer() == (2, "a2")
    assert _bare(2).checkpoint_peer() == (3, "a3")
    assert _bare(3).checkpoint_peer() == (1, "a1")  # wraps
    d = _bare(1)
    d.note_peer_failure(2)
    assert d.checkpoint_peer() == (3, "a3")  # quarantine skips to the next
    assert _bare(5, {5: "a5"}).checkpoint_peer() is None  # alone: no peer


def test_sync_answer_retags_checkpoint_replicas():
    d = _bare(1)
    d.manager.all_hashes = lambda: [10, 11, 12]
    d._tag_checkpoint(11)
    sent = []
    d.announce = lambda op, hashes: sent.append((op, list(hashes)))
    d._answer_sync()
    assert ("sync", [10, 11, 12]) in sent and ("checkpoint", [11]) in sent


def test_checkpoint_stage_bounded_drops_newest_keeps_prefix():
    async def main():
        ck = KvCheckpointer(_StubDist(None), max_blocks=4)
        ck._stage([1, 2, 3], [None, 1, 2])
        assert [h for h, _ in ck._queue] == [1, 2, 3]
        ck._stage([4, 5, 6], [3, 4, 5])
        assert [h for h, _ in ck._queue] == [1, 2, 3, 4]
        assert ck.blocks_staged == 4 and ck.blocks_dropped == 2
        ck._queue.clear()
        ck._stage([7], [6])  # behind the 5-6 hole: refused
        assert not ck._queue and ck.blocks_dropped == 3
        ck._stage([100], [None])  # an unrelated chain stages
        assert [h for h, _ in ck._queue] == [100]

    run(main())


def test_checkpoint_poison_expires_and_reoffer_repairs():
    async def main():
        ck = KvCheckpointer(_StubDist(None), max_blocks=4)
        ck._refused_ttl_s = 0.05
        ck._poison([1])
        ck._stage([2], [1])
        assert not ck._queue and ck.blocks_dropped == 1
        time.sleep(0.06)
        ck._stage([3], [1])  # expired: the chain replicates again
        assert [h for h, _ in ck._queue] == [3]
        ck._poison([7])
        ck._stage([7], [None])  # a re-offered block repairs its own hole
        assert [h for h, _ in ck._queue] == [3, 7] and not ck._poisoned(7)

    run(main())


def test_checkpoint_peer_ineligible_is_durable():
    d = _bare(1)
    assert d.checkpoint_peer() == (2, "a2")
    d.note_checkpoint_ineligible(2)
    assert not d._dead and d.checkpoint_peer() == (3, "a3")
    assert d.stats()["kvbm_ckpt_ineligible_peers"] == 1
    d._owners = {99: {2}}
    assert d.remote_owner(99) == (2, "a2")  # its pull role stays
    d._on_addr("v1/kv_data_plane/2", None)  # lease expiry clears it
    d._addrs[2] = "a2"
    assert 2 not in d._ckpt_ineligible and d.checkpoint_peer() == (2, "a2")


def test_checkpoint_push_batch_bounded_by_bytes(monkeypatch):
    pushed = []

    async def fake_push(addr, hashes, parents, k, v, **kw):
        pushed.append(list(hashes))
        return len(hashes)

    monkeypatch.setattr(tkt, "push_checkpoint_blocks", fake_push)

    async def main():
        # exactly 3 blocks fit under half the cap
        mgr = _StubManager(block_nbytes=(tkt.CHECKPOINT_MAX_PAYLOAD // 2) // 3)
        ck = KvCheckpointer(_StubDist(mgr), 64)
        ck._stage(list(range(1, 11)), [None] + list(range(1, 10)))
        await ck._run_once()
        assert pushed == [[1, 2, 3]]
        assert [h for h, _ in ck._queue] == list(range(4, 11))

    run(main())


def test_checkpoint_hole_descendants_not_pushed(monkeypatch):
    pushed = []

    async def fake_push(addr, hashes, parents, k, v, **kw):
        pushed.append((list(hashes), len(k)))
        return len(hashes)

    monkeypatch.setattr(tkt, "push_checkpoint_blocks", fake_push)

    async def main():
        ck = KvCheckpointer(_StubDist(_StubManager(missing={2})), 64)
        ck._stage([1, 2, 3], [None, 1, 2])
        await ck._run_once()
        assert pushed == [([1], 1)]
        assert ck.blocks_dropped == 2 and ck._poisoned(2) and ck._poisoned(3)

    run(main())


def test_checkpoint_block_over_payload_cap_sheds_without_dialing():
    class _NoDial(_StubDist):
        def checkpoint_peer(self):
            raise AssertionError("must not dial any peer")

    async def main():
        ck = KvCheckpointer(_NoDial(_StubManager(tkt.CHECKPOINT_MAX_PAYLOAD + 1)), 64)
        ck._stage([1, 2, 3], [None, 1, 2])
        await ck._run_once()
        assert not ck._queue and ck.blocks_dropped == 3 and ck.push_failures == 0

    run(main())


@pytest.mark.parametrize("refusal", ["ckpt_ineligible", "fmt_mismatch", "peer_blameless",
                                     "transport"])
def test_checkpoint_refusals_route_by_cause(monkeypatch, refusal):
    """A structural refusal (no tier there, another format) excludes the
    peer durably; our own oversized batch penalizes it in no role; a
    transport failure quarantines it for a while."""
    async def fake_push(addr, hashes, parents, k, v, **kw):
        if refusal == "fmt_mismatch":
            raise tkt.KvFormatError("checkpoint peer holds kv_format='int8'")
        err = tkt.KvTransferError(f"checkpoint push failed: {refusal}")
        if refusal != "transport":
            setattr(err, refusal, True)
        raise err

    monkeypatch.setattr(tkt, "push_checkpoint_blocks", fake_push)

    async def main():
        dist = _StubDist(_StubManager())
        ck = KvCheckpointer(dist, 64)
        ck._stage([1], [None])
        await ck._run_once()
        return dist, ck

    dist, ck = run(main())
    assert ck.push_failures == 1 and ck.blocks_dropped == 1 and ck._poisoned(1)
    assert dist.ineligible == ([7] if refusal in ("ckpt_ineligible", "fmt_mismatch") else [])
    assert dist.quarantined == ([7] if refusal == "transport" else [])
    assert ck.format_refusals == (refusal == "fmt_mismatch")


def test_run_loop_survives_a_failed_iteration(monkeypatch):
    calls = []

    async def flaky(self):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("boom")
        self.close()

    monkeypatch.setattr(KvCheckpointer, "_run_once", flaky)
    monkeypatch.setattr(asyncio, "sleep", _no_sleep(asyncio.sleep))
    run(KvCheckpointer(_StubDist(None), 4).run())
    assert len(calls) == 2


def _no_sleep(real):
    async def sleep(delay, *a):
        await real(0)
    return sleep


def test_no_tier_checkpoint_refusal_carries_ineligible_flag(monkeypatch):
    """A tier-less data plane refuses a push typed and structural; an
    oversized-but-sane payload is drained and answered on the kept
    connection (blameless); a block-geometry mismatch is structural; the
    connection stays framed through every refusal."""
    async def main():
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await plane.start()
        try:
            k = torch.zeros((1, 2, 4, 1, 4))  # 128 B a side
            with pytest.raises(tkt.KvTransferError) as ei:
                await tkt.push_checkpoint_blocks(plane.addr, [1], [None], k, k)
            assert ei.value.ckpt_ineligible is True
            stored = []

            class _Src:
                kv_format = "none"
                dtype = torch.float32
                block_shape = (2, 4, 1, 4)
                disk = None

                def store(self, h, kk, vv, parent=None):
                    stored.append(h)

            plane.kvbm_source = _Src()
            monkeypatch.setattr(tkt, "CHECKPOINT_MAX_PAYLOAD", 200)  # 256 > cap
            with pytest.raises(tkt.KvTransferError, match="too large") as eo:
                await tkt.push_checkpoint_blocks(plane.addr, [2], [None], k, k)
            monkeypatch.undo()
            assert eo.value.peer_blameless is True and eo.value.ckpt_ineligible is False
            bad = torch.zeros((1, 2, 4, 1, 8))
            with pytest.raises(tkt.KvTransferError, match="size mismatch") as es:
                await tkt.push_checkpoint_blocks(plane.addr, [2], [None], bad, bad)
            assert es.value.ckpt_ineligible is True and stored == []
            assert await tkt.push_checkpoint_blocks(plane.addr, [3], [None], k, k) == 1
            assert stored == [3] and plane.checkpoint_pushes == 1
        finally:
            tkt._CONN_POOL.evict(plane.addr)
            await plane.close()

    run(main())


def test_promotion_batches_not_checkpoint_staged():
    mgr = KvBlockManager(KvbmConfig(host_blocks=16), (2, 4, 2, 4), torch.float32)
    conn = KvbmConnector(_FakeEngine(), mgr)
    staged = []

    class _Ck:
        def stage_threadsafe(self, hashes, parents):
            staged.append(list(hashes))

    class _Dist:
        checkpointer = _Ck()

        def announce_threadsafe(self, *a, **k):
            pass

    conn.distributed = _Dist()
    try:
        blk = torch.zeros((1, 2, 4, 2, 4))
        conn.stage_promotion([0xAA], [None], blk, blk)  # a peer-pulled block
        conn.offload_commit([0xBB], [1], parent=None)  # this worker's own commit
        conn.flush_step().result(10)
        assert conn.drain(10)
        assert mgr.has(0xAA) and mgr.has(0xBB)
        assert staged == [[0xBB]]
    finally:
        conn.shutdown()


# ---------------------------------------------------------------------- #
# pushes across packages
# ---------------------------------------------------------------------- #


def _blocks(fmt, n):
    kv_format, shape, np_dtype, _ = FORMATS[fmt]
    rng = np.random.default_rng(4)
    if np_dtype == np.uint8:
        return [rng.integers(0, 256, size=(n, *shape), dtype=np.uint8) for _ in "kv"]
    return [rng.standard_normal((n, *shape)).astype(np.float32).astype(np_dtype)
            for _ in "kv"]


class _Publishes:
    """A discovery stand-in that records the mesh's announcements."""

    def __init__(self, unpack):
        self.unpack = unpack
        self.sent = []

    async def publish(self, topic, payload):
        self.sent.append((topic, self.unpack(payload)))


async def _until(pred):
    for _ in range(500):
        if pred():
            return
        await asyncio.sleep(0.01)
    raise AssertionError("condition never held")


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_checkpoint_pushes_interoperate_byte_equal(fmt, direction):
    kv_format, shape, np_dtype, t_dtype = FORMATS[fmt]
    k, v = _blocks(fmt, 3)
    hashes, parents = [41, 42, 43], [None, 41, 42]

    async def main():
        if direction == "jax_to_port":
            plane = tkt.KvDataPlaneServer(host="127.0.0.1")
            mgr = KvBlockManager(KvbmConfig(host_blocks=8), shape, t_dtype, kv_format=kv_format)
            conn = KvbmConnector(_FakeEngine(), mgr)
            disc = _Publishes(codec.unpack)
            dist = KvbmDistributed(type("D", (), {"discovery": disc})(), conn, plane,
                                   "ns", "kvbm", 5)
            push, pool = jkt.push_checkpoint_blocks, jkt._CONN_POOL
            args = (k, v)
        else:
            plane = jkt.KvDataPlaneServer(host="127.0.0.1")
            mgr = RefManager(RefConfig(host_blocks=8), shape, np_dtype, kv_format=kv_format)
            conn = type("C", (), {"manager": mgr})()
            disc = _Publishes(ref_codec.unpack)
            dist = RefDistributed(type("D", (), {"discovery": disc})(), conn, plane,
                                  "ns", "kvbm", 5)
            push, pool = tkt.push_checkpoint_blocks, tkt._CONN_POOL
            args = (_to_port(k, t_dtype), _to_port(v, t_dtype))
        await plane.start()
        try:
            n = await push(plane.addr, hashes, parents, *args, kv_format=kv_format)
            assert n == 3 and plane.checkpoint_pushes == 1
            assert plane.checkpoint_blocks_received == 3
            present, rk, rv = mgr.read_blocks(hashes)
            assert present == hashes
            assert _raw(rk) == _raw(k) and _raw(rv) == _raw(v)
            assert dist.any_checkpoint([42]) and not dist.any_checkpoint([99])
            await _until(lambda: disc.sent)
            topic, msg = disc.sent[0]
            assert topic == "kvbm_blocks/ns/kvbm"
            assert msg == {"worker": 5, "op": "checkpoint", "hashes": hashes}
            # another format: typed, before a byte is stored
            other = "int4" if kv_format != "int4" else "none"
            err = tkt.KvFormatError if direction == "port_to_jax" else jkt.KvFormatError
            with pytest.raises(err):
                await push(plane.addr, [44], [43], *(a[:1] for a in args), kv_format=other)
            assert not mgr.has(44)
        finally:
            pool.evict(plane.addr)
            await plane.close()
            if direction == "jax_to_port":
                conn.shutdown()

    run(main())


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_push_frames_byte_equal(fmt):
    """Both pushers put the same bytes on the wire for the same blocks."""
    kv_format, _, _, t_dtype = FORMATS[fmt]
    k, v = _blocks(fmt, 2)
    seen = []

    async def main():
        async def handle(reader, writer):
            head = await reader.readexactly(HDR.size)
            _, length = HDR.unpack(head)
            body = await reader.readexactly(length)
            meta = msgpack.unpackb(body, raw=False)["ckpt"]
            payload = await reader.readexactly(meta["k_bytes"] + meta["v_bytes"])
            seen.append(head + body + payload)
            reply = msgpack.packb({"ok": True, "stored": 2}, use_bin_type=True)
            writer.write(HDR.pack(MAGIC, len(reply)) + reply)
            await writer.drain()
            writer.close()

        server = await asyncio.start_server(handle, "127.0.0.1", 0)
        addr = "127.0.0.1:%d" % server.sockets[0].getsockname()[1]
        try:
            assert await jkt.push_checkpoint_blocks(addr, [1, 2], [None, 1], k, v,
                                                    kv_format=kv_format) == 2
            jkt._CONN_POOL.evict(addr)
            assert await tkt.push_checkpoint_blocks(
                addr, [1, 2], [None, 1], _to_port(k, t_dtype), _to_port(v, t_dtype),
                kv_format=kv_format) == 2
            tkt._CONN_POOL.evict(addr)
        finally:
            server.close()
            await server.wait_closed()

    run(main())
    assert len(seen) == 2 and seen[0] == seen[1]


def test_format_mismatch_makes_the_peer_ineligible():
    """The checkpointer against a real data plane of another format: the
    push is refused typed (KvFormatError), counted, and the peer leaves the
    checkpoint ring for good."""
    async def main():
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        plane.kvbm_source = KvBlockManager(KvbmConfig(host_blocks=4), (2, 600), torch.uint8,
                                           kv_format="int8")
        await plane.start()
        mgr = KvBlockManager(KvbmConfig(host_blocks=4), (2, 600), torch.uint8,
                             kv_format="int4")
        mgr.store(9, torch.zeros((2, 600), dtype=torch.uint8),
                  torch.zeros((2, 600), dtype=torch.uint8))
        conn = KvbmConnector(_FakeEngine(), mgr)
        dist = KvbmDistributed(_NoDrt(), conn, None, "ns", "kvbm", 1)
        dist._addrs = {2: plane.addr}
        ck = KvCheckpointer(dist, 8)
        try:
            ck._stage([9], [None])
            await ck._run_once()
            assert ck.format_refusals == 1 and ck.push_failures == 1
            assert dist._ckpt_ineligible == {2} and dist.checkpoint_peer() is None
            assert not plane.kvbm_source.has(9)
        finally:
            tkt._CONN_POOL.evict(plane.addr)
            await plane.close()
            conn.shutdown()

    run(main())
