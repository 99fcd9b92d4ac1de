"""The port's KVBM peer fabric against the JAX package's, on the CPU.

* KVBM block pulls over the data plane, both directions over TCP: the
  port's server answers the reference's `pull_kvbm_blocks` and the port's
  `pull_kvbm_blocks` reads the reference's server, in f32, bf16 and packed
  int8 rows; the request and the response frames are byte-equal to the
  reference's; a block miss and a `kv_format` mismatch are refused typed.
* Engines across packages: a port engine onboards a prompt from a JAX
  worker's host tier (found through the reference's announcement mesh on a
  shared discovery service) and a JAX engine from a port worker's, each
  token-identical to the local prefill of the owner.
* The mesh: an owner whose tier drops a block retracts it from its peers'
  mirrors; a peer whose pull failed is quarantined; a DYN_KV_CHECKPOINT
  typo is refused at start, a block count replicates committed blocks into
  the peer's tier.
"""

import asyncio
import signal
import struct

import jax
import jax.numpy as jnp
import ml_dtypes
import msgpack
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.kvbm import KvbmDistributed as RefDistributed
from dynamo_tpu.kvbm.manager import KvBlockManager as RefManager
from dynamo_tpu.kvbm.manager import KvbmConfig as RefConfig
from dynamo_tpu.llm import kv_transfer as jkt
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime import DistributedRuntime as RefRuntime
from dynamo_tpu.runtime import RuntimeConfig as RefRuntimeConfig
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.kvbm import KvbmDistributed
from dynamo_tpu_torch.kvbm.manager import KvBlockManager, KvbmConfig, KvbmConnector
from dynamo_tpu_torch.llm import kv_transfer as tkt
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.discovery import DiscoveryServer
from dynamo_tpu_torch.runtime.engine import Context

from .test_torch_engine import numpy_params
from .test_torch_runtime import single_write_frames  # noqa: F401 — an autouse fixture

LIMIT = 60
HDR = struct.Struct("<II")
MAGIC, MAGIC_RANGE = 0xD7A04B1D, 0xD7A04B1E
BLOCK = (2, 8, 2, 16)  # layers, page, KV heads, head dim
FORMATS = {
    # name: (kv_format, block shape, reference numpy dtype, port torch dtype)
    "float32": ("none", BLOCK, np.float32, torch.float32),
    "bfloat16": ("none", BLOCK, ml_dtypes.bfloat16, torch.bfloat16),
    "int8_rows": ("int8", (2, 600), np.uint8, torch.uint8),
}
KW = dict(model="tiny", max_num_seqs=4, page_size=8, num_pages=24, max_model_len=160,
          prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4,
          kvbm_host_blocks=16)
PROMPT = [int(t) for t in np.random.RandomState(8).randint(3, 500, size=44)]


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


def _to_port(x, t_dtype):
    """A numpy block as the port's tensor of the same bits."""
    if t_dtype == torch.bfloat16:
        return torch.from_numpy(np.ascontiguousarray(x).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(x))


def _managers(fmt: str, hashes):
    """(reference manager, port manager) holding the same blocks."""
    kv_format, shape, np_dtype, t_dtype = FORMATS[fmt]
    rng = np.random.default_rng(2)
    ref = RefManager(RefConfig(host_blocks=8), shape, np_dtype, kv_format=kv_format)
    port = KvBlockManager(KvbmConfig(host_blocks=8), shape, t_dtype, kv_format=kv_format)
    for h in hashes:
        if np_dtype == np.uint8:
            k = rng.integers(0, 256, size=shape, dtype=np.uint8)
            v = rng.integers(0, 256, size=shape, dtype=np.uint8)
        else:
            k = rng.standard_normal(shape).astype(np.float32).astype(np_dtype)
            v = rng.standard_normal(shape).astype(np.float32).astype(np_dtype)
        ref.store(h, k, v)
        port.store(h, _to_port(k, t_dtype), _to_port(v, t_dtype))
    return ref, port


async def _raw_exchange(addr: str, body: bytes) -> bytes:
    """Send one ranged handshake, return every byte of the answer."""
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        writer.write(HDR.pack(MAGIC_RANGE, len(body)) + body)
        await writer.drain()
        head = await reader.readexactly(HDR.size)
        _, length = HDR.unpack(head)
        hbody = await reader.readexactly(length)
        header = msgpack.unpackb(hbody, raw=False)
        payload = b""
        if not header.get("error"):
            payload = await reader.readexactly(header["k_bytes"] + header["v_bytes"])
        return head + hbody + payload
    finally:
        writer.close()


@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_block_pulls_interoperate_byte_equal(fmt):
    kv_format, shape, np_dtype, t_dtype = FORMATS[fmt]
    hashes = [31, 32, 33]
    ref_mgr, port_mgr = _managers(fmt, hashes)

    async def main():
        ref_srv = jkt.KvDataPlaneServer(host="127.0.0.1")
        port_srv = tkt.KvDataPlaneServer(host="127.0.0.1")
        await ref_srv.start()
        await port_srv.start()
        ref_srv.kvbm_source, port_srv.kvbm_source = ref_mgr, port_mgr
        try:
            want = [32, 31]
            # the reference's client reads the port's server, and the reverse
            rk, rv = await jkt.pull_kvbm_blocks(port_srv.addr, want, shape, np_dtype,
                                                kv_format=kv_format)
            pk, pv = await tkt.pull_kvbm_blocks(ref_srv.addr, want, shape, t_dtype,
                                                kv_format=kv_format)
            ek, ev = ref_mgr.load_blocks(want)
            assert _raw(rk) == _raw(ek) == _raw(pk) and _raw(rv) == _raw(ev) == _raw(pv)
            assert tuple(pk.shape) == (2, *shape) and pk.dtype == t_dtype
            # the answers, byte for byte, to the same request
            body = msgpack.packb({"blocks": want, "fmt": kv_format}, use_bin_type=True)
            assert await _raw_exchange(port_srv.addr, body) == \
                await _raw_exchange(ref_srv.addr, body)
            # refusals: a miss, another format — typed on both clients
            with pytest.raises(KeyError, match="block miss"):
                await tkt.pull_kvbm_blocks(ref_srv.addr, [99], shape, t_dtype,
                                           kv_format=kv_format)
            with pytest.raises(KeyError, match="block miss"):
                await jkt.pull_kvbm_blocks(port_srv.addr, [99], shape, np_dtype,
                                           kv_format=kv_format)
            other = "int4" if kv_format != "int4" else "none"
            with pytest.raises(tkt.KvFormatError):
                await tkt.pull_kvbm_blocks(ref_srv.addr, want, shape, t_dtype, kv_format=other)
            with pytest.raises(jkt.KvFormatError):
                await jkt.pull_kvbm_blocks(port_srv.addr, want, shape, np_dtype,
                                           kv_format=other)
            body = msgpack.packb({"blocks": want, "fmt": other}, use_bin_type=True)
            assert await _raw_exchange(port_srv.addr, body) == \
                await _raw_exchange(ref_srv.addr, body)
        finally:
            # the clients' kept connections would hold a server's close open
            tkt._CONN_POOL.evict(ref_srv.addr)
            jkt._CONN_POOL.evict(port_srv.addr)
            await ref_srv.close()
            await port_srv.close()
        assert port_srv.transfers_served == ref_srv.transfers_served == 2

    run(main())


def test_pull_request_frames_byte_equal():
    """Both clients put the same bytes on the wire."""
    seen = []

    async def main():
        async def handle(reader, writer):
            head = await reader.readexactly(HDR.size)
            _, length = HDR.unpack(head)
            seen.append(head + await reader.readexactly(length))
            body = msgpack.packb({"error": "no kvbm tier here"}, use_bin_type=True)
            writer.write(HDR.pack(MAGIC, len(body)) + body)
            await writer.drain()
            writer.close()

        srv = await asyncio.start_server(handle, "127.0.0.1", 0)
        addr = f"127.0.0.1:{srv.sockets[0].getsockname()[1]}"
        try:
            with pytest.raises(KeyError):
                await tkt.pull_kvbm_blocks(addr, [5, 2**63 + 7], BLOCK, torch.bfloat16,
                                           kv_format="none")
            with pytest.raises(KeyError):
                await jkt.pull_kvbm_blocks(addr, [5, 2**63 + 7], BLOCK, ml_dtypes.bfloat16,
                                           kv_format="none")
        finally:
            srv.close()
            await srv.wait_closed()

    run(main())
    assert len(seen) == 2 and seen[0] == seen[1]


# ---------------------------------------------------------------------- #
# engines across packages, through the announcement mesh
# ---------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


def _jax_engine(weights):
    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)
    return JaxEngine(JaxEngineConfig(**KW), model_config=jllama.LlamaConfig.tiny(
        dtype=jnp.float32), params=params)


def _torch_engine(weights):
    return TorchEngine(EngineConfig(**KW), model_config=tllama.LlamaConfig.tiny(
        dtype=torch.float32), params=params_from_jax(weights, device="cpu"), device="cpu")


async def _serve(engine, req_cls, ctx_cls, ids):
    req = req_cls(token_ids=list(ids), stop_conditions={"max_tokens": 6, "ignore_eos": True})
    toks = []
    async for item in engine.generate(req.to_dict(), ctx_cls()):
        assert item.get("event") != "error", item
        toks.extend((item.get("data") or {}).get("token_ids", []))
    return toks


async def _drained(engine):
    engine.kvbm.flush_step()
    for _ in range(500):
        if engine.kvbm.pending_offloads() == 0:
            return
        await asyncio.sleep(0.01)
    raise AssertionError("offloads never drained")


async def _member(pkg, weights, disc_addr):
    """(runtime, engine, data plane, mesh) of one worker of package `pkg`."""
    if pkg == "jax":
        cfg = RefRuntimeConfig()
        cfg.discovery_endpoint = disc_addr
        drt = await RefRuntime.create(cfg)
        engine, dp = _jax_engine(weights), jkt.KvDataPlaneServer(host="127.0.0.1")
        dist_cls = RefDistributed
    else:
        cfg = RuntimeConfig()
        cfg.discovery_endpoint = disc_addr
        drt = await DistributedRuntime.create(cfg)
        engine, dp = _torch_engine(weights), tkt.KvDataPlaneServer(host="127.0.0.1")
        dist_cls = KvbmDistributed
    await dp.start()
    await dp.register(drt)
    engine.data_plane = dp
    dist = dist_cls(drt, engine.kvbm, dp, "dynamo", "kvbm", drt.instance_id)
    await dist.start()
    return drt, engine, dp, dist


@pytest.mark.parametrize("owner,puller", [("jax", "torch"), ("torch", "jax")])
def test_engine_onboards_from_a_peer_of_the_other_package(weights, owner, puller):
    async def main():
        disc = DiscoveryServer(port=0)
        host, port = await disc.start()
        addr = f"tcp://{host}:{port}"
        members = []
        try:
            o = await _member(owner, weights, addr)
            members.append(o)
            p = await _member(puller, weights, addr)
            members.append(p)
            o_cls = (JaxRequest, JaxContext) if owner == "jax" else (PreprocessedRequest, Context)
            p_cls = (JaxRequest, JaxContext) if puller == "jax" else (PreprocessedRequest, Context)
            want = await _serve(o[1], *o_cls, PROMPT)
            await _drained(o[1])
            # the puller's mirror learns the owner's blocks from the mesh
            n_blocks = len(PROMPT) // KW["page_size"]
            for _ in range(400):
                if len(p[3]._owners) >= n_blocks and o[1] and p[3]._addrs:
                    break
                await asyncio.sleep(0.02)
            assert len(p[3]._owners) >= n_blocks
            got = await _serve(p[1], *p_cls, PROMPT)
            stats = p[1].stats()
            assert got == want
            assert stats["kvbm_remote_blocks_pulled"] == n_blocks
            assert stats["kvbm_onboard_src_peer_blocks"] == n_blocks
            assert o[2].transfers_served == 1
        finally:
            for _, _, dp, _ in members:
                tkt._CONN_POOL.evict(dp.addr)
                jkt._CONN_POOL.evict(dp.addr)
            for drt, engine, dp, dist in reversed(members):
                await dist.close()
                await engine.close()
                await dp.close()
                await drt.close()
            await disc.stop()

    run(main())


# ---------------------------------------------------------------------- #
# the mesh: retraction, quarantine, checkpointing
# ---------------------------------------------------------------------- #


class _FakeEngine:
    def __init__(self):
        import concurrent.futures

        gen = torch.Generator().manual_seed(1)
        self.kv_k = torch.randn(2, 16, 4, 2, 4, generator=gen)
        self.kv_v = torch.randn(2, 16, 4, 2, 4, generator=gen)
        self._device_exec = concurrent.futures.ThreadPoolExecutor(max_workers=1)

    def _dev_offload_gather(self, pages):
        ids = torch.from_numpy(np.asarray(pages, np.int64))
        return self.kv_k[:, ids], self.kv_v[:, ids], None

    def _timed(self, fn, tag, shape=None):
        return fn


async def _fake_member(disc_addr, host_blocks):
    cfg = RuntimeConfig()
    cfg.discovery_endpoint = disc_addr
    drt = await DistributedRuntime.create(cfg)
    conn = KvbmConnector(_FakeEngine(), KvBlockManager(KvbmConfig(host_blocks=host_blocks),
                                                       (2, 4, 2, 4), torch.float32))
    dp = tkt.KvDataPlaneServer(host="127.0.0.1")
    await dp.start()
    await dp.register(drt)
    dist = KvbmDistributed(drt, conn, dp, "dynamo", "kvbm", drt.instance_id)
    await dist.start()
    return drt, conn, dp, dist


async def _until(pred, what):
    for _ in range(400):
        if pred():
            return
        await asyncio.sleep(0.02)
    raise AssertionError(f"never: {what}")


def test_owner_eviction_retracts_the_block_from_peers():
    async def main():
        disc = DiscoveryServer(port=0)
        host, port = await disc.start()
        addr = f"tcp://{host}:{port}"
        a = await _fake_member(addr, host_blocks=2)
        b = await _fake_member(addr, host_blocks=2)
        try:
            a_id = a[0].instance_id
            a[1].offload_commit([11, 12], [1, 2])
            a[1].flush_step()
            await _until(lambda: {11, 12} <= set(b[3]._owners), "b mirrors 11, 12")
            assert b[3].remote_owner(11)[0] == a_id
            # two more blocks push 11 and 12 out of a's only tier
            a[1].offload_commit([13, 14], [3, 4], parent=12)
            a[1].flush_step()
            await _until(lambda: 11 not in b[3]._owners and 12 not in b[3]._owners
                         and {13, 14} <= set(b[3]._owners), "b retracts 11, 12")
            assert b[3].extend_prefix([13, 14, 11]) == [13, 14]
            assert b[3].stats()["kvbm_known_remote_blocks"] == 2
        finally:
            for drt, conn, dp, dist in (b, a):
                await dist.close()
                conn.shutdown()
                await dp.close()
                await drt.close()
            await disc.stop()

    run(main())


def test_failed_pull_quarantines_the_peer():
    async def main():
        conn = KvbmConnector(_FakeEngine(), KvBlockManager(KvbmConfig(host_blocks=2),
                                                           (2, 4, 2, 4), torch.float32))
        drt = type("Drt", (), {"discovery": None})()
        dist = KvbmDistributed(drt, conn, None, "dynamo", "kvbm", 1)
        await dist.start()
        # a peer that announced block 5 and whose data plane is gone
        with __import__("socket").socket() as s:
            s.bind(("127.0.0.1", 0))
            dead = f"127.0.0.1:{s.getsockname()[1]}"
        dist._addrs[7] = dead
        dist._owners[5] = {7}
        assert conn.probe([5]) == [5]
        with pytest.raises(tkt.KvTransferError):
            await dist.pull_blocks([5])
        assert dist._quarantined(7) and dist.remote_owner(5) is None
        assert conn.probe([5]) == []
        stats = dist.stats()
        assert stats["kvbm_quarantined_peers"] == 1 and stats["kvbm_peer_pull_failures"] == 1
        # the onboard path sees the failure as a miss (recompute)
        dist._dead.clear()

        async def run_sync(fn, *a):
            return fn(*a)

        with pytest.raises(KeyError, match="remote pull failed"):
            await conn.load_async([5], run_sync)
        await dist.close()
        conn.shutdown()

    run(main())


def test_session_checkpointing_is_refused_at_start(monkeypatch):
    """A DYN_KV_CHECKPOINT typo is refused at start (checkpointing stays off,
    the worker runs); a block count starts the checkpointer, whose pushes
    land in the peer's tier tagged `checkpoint` on both sides."""
    async def main():
        disc = DiscoveryServer(port=0)
        host, port = await disc.start()
        addr = f"tcp://{host}:{port}"
        monkeypatch.setenv("DYN_KV_CHECKPOINT", "sixty-four")
        b = await _fake_member(addr, host_blocks=4)
        monkeypatch.setenv("DYN_KV_CHECKPOINT", "64")
        a = await _fake_member(addr, host_blocks=4)
        try:
            assert b[3].checkpointer is None and a[3].checkpointer is not None
            await _until(lambda: b[0].instance_id in a[3]._addrs, "a sees b's data plane")
            a[1].offload_commit([21, 22], [1, 2])
            a[1].flush_step()
            await _until(lambda: b[2].checkpoint_blocks_received == 2, "b holds 21, 22")
            assert b[1].manager.has(21) and b[1].any_checkpoint([22])
            await _until(lambda: a[3].any_checkpoint([21]), "a hears the checkpoint tag")
            stats = a[3].stats()
            assert stats["kvbm_ckpt_blocks_pushed"] == 2
            assert stats["kvbm_ckpt_last_peer"] == f"{b[0].instance_id:x}"
            k, v = b[1].manager.read_blocks([21, 22])[1:]
            assert torch.equal(k, a[1].manager.read_blocks([21, 22])[1])
        finally:
            for drt, conn, dp, dist in (a, b):
                tkt._CONN_POOL.evict(dp.addr)
                await dist.close()
                conn.shutdown()
                await dp.close()
                await drt.close()
            await disc.stop()

    run(main())
