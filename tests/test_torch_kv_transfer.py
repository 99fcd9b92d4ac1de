"""The port's KV handoff wire against the JAX package's, on the CPU.

* Page packing: `dynamo_tpu_torch.ops.kv_quant.host_pack_pages` of pages
  gathered from a pool must be BYTE-EQUAL to
  `dynamo_tpu.ops.kv_quant.host_pack_pages` of the same pages of a pool with
  the same contents (f32, bf16, and int8/int4 pools written through each
  package's quantize-on-write from the same numpy values), and unpack +
  inject must restore the pages exactly.
* Data plane, both directions over TCP on localhost: the port's `pull_kv`
  against the reference's `KvDataPlaneServer` and the reference's `pull_kv`
  against the port's server, in f32, bf16 and packed int8 rows, at chunk
  sizes of 1 page, a divisor and a non-divisor of the transfer; the ranged
  pull and its `fin`; an oversized frame and an oversized handshake; an
  unknown transfer; the TTL reaper releasing unpulled pages; a data plane
  without tiers refusing KVBM block pulls and checkpoint pushes typed; a
  zero-page transfer.
* The conditional-disagg router and the inline payload against the
  reference's.

Every test runs under an alarm and every coroutine under
`asyncio.wait_for`; nothing sleeps for a fixed time.
"""

import asyncio
import signal

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.llm import disagg as jdisagg
from dynamo_tpu.llm import kv_transfer as jkt
from dynamo_tpu.ops import kv_quant as jkv
from dynamo_tpu_torch.llm import disagg as tdisagg
from dynamo_tpu_torch.llm import kv_transfer as tkt
from dynamo_tpu_torch.ops import kv_quant as tkv

L, PAGES, PS, KH, D = 2, 8, 8, 2, 16
PAGE_IDS = [5, 1, 6, 2]  # gathered out of order, as a slot's pages are
LIMIT = 30  # seconds a test's coroutine may take


@pytest.fixture(autouse=True)
def time_limit():
    """Every test fails, instead of hanging, past LIMIT seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {LIMIT} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


def _bytes(x) -> bytes:
    """Raw bytes of a numpy array or a CPU tensor (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
    return np.ascontiguousarray(x).tobytes()


# ---------------------------------------------------------------------- #
# page packing
# ---------------------------------------------------------------------- #

_jax_write = jax.jit(jkv.kv_write, static_argnums=1)


def _pools(fmt: str):
    """(reference store, port store) with the same contents. fp pools hold
    the same values cast by each framework (round to nearest even);
    quantized pools are written by each package's quantize-on-write with
    the same tokens, so the int4 nibble layout is each package's own."""
    rng = np.random.RandomState(7)
    if fmt in ("float32", "bfloat16"):
        vals = rng.randn(L, PAGES, PS, KH, D).astype(np.float32)
        jdt = jnp.float32 if fmt == "float32" else jnp.bfloat16
        tdt = torch.float32 if fmt == "float32" else torch.bfloat16
        return jnp.asarray(vals).astype(jdt), torch.from_numpy(vals).to(tdt)
    jstore = jkv.alloc_kv_store(L, PAGES, PS, KH, D, jnp.float32, fmt)
    tstore = tkv.alloc_kv_store(L, PAGES, PS, KH, D, torch.float32, fmt, device="cpu")
    for li in range(L):
        for page in range(PAGES):
            phys = np.full(PS, page, np.int32)
            offs = np.arange(PS, dtype=np.int32)
            vals = (rng.randn(PS, KH, D) * rng.uniform(0.1, 4.0)).astype(np.float32)
            jstore = _jax_write(jstore, li, jnp.asarray(phys), jnp.asarray(offs), jnp.asarray(vals))
            tkv.kv_write(tstore, li, torch.from_numpy(phys), torch.from_numpy(offs),
                         torch.from_numpy(vals))
    np.testing.assert_array_equal(tstore.q.numpy(), np.asarray(jstore.q))
    np.testing.assert_array_equal(tstore.s.numpy(), np.asarray(jstore.s))
    return jstore, tstore


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "int8", "int4"])
def test_host_pack_pages_byte_equal_to_reference(fmt):
    jstore, tstore = _pools(fmt)
    ids = np.array(PAGE_IDS, np.int32)
    # the reference engine's jitted extract_pages: a[:, page_ids] per leaf
    jpages = jax.tree.map(lambda a: a[:, jnp.asarray(ids)], jstore)
    want = jkv.host_pack_pages(jpages)
    got = tkv.host_pack_pages(tkv.extract_pages(tstore, torch.from_numpy(ids)))
    assert tuple(got.shape) == want.shape
    assert _bytes(got) == _bytes(want)
    if fmt in ("int8", "int4"):
        pb = tkv.kv_page_bytes(PS, KH, D, torch.float32, fmt)
        assert tuple(got.shape) == (L, len(PAGE_IDS), pb) and got.dtype == torch.uint8
        # the reference unpacks the port's rows into its own q / s
        q, s = jkv.host_unpack_pages(got.numpy(), fmt, PS, KH, D)
        np.testing.assert_array_equal(q, np.asarray(jpages.q))
        np.testing.assert_array_equal(s, np.asarray(jpages.s))
    # round trip: unpack + inject at other pages of a fresh pool, gather again
    dest = (tkv.alloc_kv_store(L, PAGES, PS, KH, D, torch.float32, fmt, device="cpu")
            if fmt in ("int8", "int4") else torch.zeros_like(tstore))
    mode = fmt if fmt in ("int8", "int4") else "none"
    other = torch.tensor([0, 3, 4, 7])
    tkv.inject_pages(dest, other, tkv.device_pages(got, mode, PS, KH, D))
    again = tkv.host_pack_pages(tkv.extract_pages(dest, other))
    assert _bytes(again) == _bytes(got)


def test_host_unpack_pages_rejects_a_wrong_row_length():
    with pytest.raises(ValueError, match="expects"):
        tkv.host_unpack_pages(torch.zeros(L, 2, 17, dtype=torch.uint8), "int8", PS, KH, D)


# ---------------------------------------------------------------------- #
# data plane
# ---------------------------------------------------------------------- #

N_PAGES = 6
WIRE = {  # name -> (page shape, numpy dtype on the reference side)
    "float32": ([L, PS, KH, D], np.float32),
    "bfloat16": ([L, PS, KH, D], ml_dtypes.bfloat16),
    "int8": ([L, tkv.kv_page_bytes(PS, KH, D, torch.float32, "int8")], np.uint8),
}


def _pages(fmt: str):
    """K and V of N_PAGES pages, [L, n, ...], as numpy (reference side)."""
    shape, np_dtype = WIRE[fmt]
    rng = np.random.RandomState(3)
    full = (L, N_PAGES, *shape[1:])
    if np_dtype == np.uint8:
        return [rng.randint(0, 256, size=full).astype(np.uint8) for _ in range(2)]
    return [rng.randn(*full).astype(np.float32).astype(np_dtype) for _ in range(2)]


def _stage_args(fmt: str, chunk: int):
    shape, _ = WIRE[fmt]
    dtype = "uint8" if fmt == "int8" else fmt
    return dict(n_pages=N_PAGES, n_tokens=N_PAGES * PS - 3, page_size=PS,
                page_shape=shape, dtype=dtype, chunk_pages=chunk,
                kv_format="int8" if fmt == "int8" else "none")


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _expected_chunks(chunk: int):
    return [(o, min(chunk, N_PAGES - o)) for o in range(0, N_PAGES, chunk)]


CASES = [(fmt, chunk) for fmt in WIRE for chunk in (1, 3, 4)]  # 3 divides 6, 4 does not


@pytest.mark.parametrize("fmt,chunk", CASES, ids=[f"{f}-chunk{c}" for f, c in CASES])
def test_port_pull_from_reference_server(fmt, chunk):
    k_all, v_all = _pages(fmt)

    async def main():
        server = jkt.KvDataPlaneServer(host="127.0.0.1")
        await server.start()
        released = []

        async def extract(off, n, device):
            return k_all[:, off:off + n], v_all[:, off:off + n]

        desc = server.stage(extract=extract, on_done=released.append, **_stage_args(fmt, chunk))
        got_k, got_v, order = {}, {}, []

        async def inject(off, n, k, v):
            assert isinstance(k, torch.Tensor) and k.shape[1] == n
            order.append((off, n))
            got_k[off], got_v[off] = _bytes(k), _bytes(v)

        try:
            await tkt.pull_kv(tkt.KvTransferDescriptor.from_dict(desc.to_dict()), inject)
        finally:
            await server.close()
        assert order == _expected_chunks(chunk)
        assert b"".join(got_k[o] for o, _ in order) == b"".join(
            _bytes(k_all[:, o:o + n]) for o, n in order)
        assert b"".join(got_v[o] for o, _ in order) == b"".join(
            _bytes(v_all[:, o:o + n]) for o, n in order)
        assert released == [True] and server.transfers_served == 1
        assert server.bytes_served == k_all.nbytes + v_all.nbytes

    run(main())


@pytest.mark.parametrize("fmt,chunk", CASES, ids=[f"{f}-chunk{c}" for f, c in CASES])
def test_reference_pull_from_port_server(fmt, chunk):
    k_all, v_all = _pages(fmt)
    tk, tv = _as_torch(k_all), _as_torch(v_all)

    async def main():
        server = tkt.KvDataPlaneServer(host="127.0.0.1")
        await server.start()
        released = []

        async def extract(off, n, device):
            return tk[:, off:off + n], tv[:, off:off + n]

        desc = server.stage(extract=extract, on_done=released.append, **_stage_args(fmt, chunk))
        assert desc.chunk_pages == chunk
        got_k = np.zeros_like(k_all)
        got_v = np.zeros_like(v_all)
        order = []

        async def inject(off, n, k, v):
            order.append((off, n))
            got_k[:, off:off + n] = k
            got_v[:, off:off + n] = v

        try:
            await jkt.pull_kv(jkt.KvTransferDescriptor.from_dict(desc.to_dict()), inject)
        finally:
            await server.close()
        assert order == _expected_chunks(chunk)
        assert _bytes(got_k) == _bytes(k_all) and _bytes(got_v) == _bytes(v_all)
        assert released == [True] and server.transfers_served == 1
        assert server.bytes_served == k_all.nbytes + v_all.nbytes

    run(main())


def test_default_chunking_matches_the_reference():
    """Unset chunk_pages: ~4 MiB of K a chunk, from the dtype's itemsize."""
    async def main():
        for shape, dtype in (([28, 64, 8, 128], "bfloat16"), ([4, 64, 2, 16], "float32"),
                             ([28, 32800], "uint8")):
            servers = [jkt.KvDataPlaneServer(host="127.0.0.1"),
                       tkt.KvDataPlaneServer(host="127.0.0.1")]
            chunks = []
            for server in servers:
                async def extract(off, n, device):
                    raise AssertionError("never pulled")

                desc = server.stage(n_pages=4, n_tokens=200, page_size=64, page_shape=shape,
                                    dtype=dtype, extract=extract, on_done=lambda ok: None)
                chunks.append(desc.chunk_pages)
                server.unstage_by_id(desc.transfer_id, ok=False)
            assert chunks[0] == chunks[1], (shape, dtype, chunks)

    run(main())


@pytest.mark.parametrize("direction", ["port_pulls_reference", "reference_pulls_port"])
def test_ranged_pull_and_fin(direction):
    """Ranged pulls serve any chunk to many requests; `fin` releases."""
    k_all, v_all = _pages("bfloat16")
    port_serves = direction == "reference_pulls_port"
    server_mod, client_mod = (tkt, jkt) if port_serves else (jkt, tkt)
    src_k, src_v = (_as_torch(k_all), _as_torch(v_all)) if port_serves else (k_all, v_all)

    async def main():
        server = server_mod.KvDataPlaneServer(host="127.0.0.1")
        await server.start()
        released = []

        async def extract(off, n, device):
            return src_k[:, off:off + n], src_v[:, off:off + n]

        desc = server.stage(extract=extract, on_done=released.append,
                            **_stage_args("bfloat16", 2))
        client_mod._LOCAL.pop((server.addr, desc.transfer_id), None)
        server_mod._LOCAL.pop((server.addr, desc.transfer_id), None)
        try:
            for off, n in ((4, 2), (0, 3), (1, 1)):
                k, v = await client_mod.pull_kv_range(
                    server.addr, desc.transfer_id, off, n, desc.page_shape, desc.dtype)
                assert tuple(k.shape) == (L, n, PS, KH, D)
                assert _bytes(k) == _bytes(k_all[:, off:off + n])
                assert _bytes(v) == _bytes(v_all[:, off:off + n])
            assert released == []
            await client_mod.finish_transfer(server.addr, desc.transfer_id)
            assert released == [True]
            with pytest.raises((RuntimeError, tkt.KvTransferError), match="unknown transfer"):
                await client_mod.pull_kv_range(
                    server.addr, desc.transfer_id, 0, 1, desc.page_shape, desc.dtype)
        finally:
            # the port's client keeps ranged connections; the reference's
            # server would wait for them to idle out before closing
            tkt._CONN_POOL.evict(server.addr)
            await server.close()

    run(main())


def test_unknown_transfer_is_refused_both_ways():
    async def main():
        servers = [jkt.KvDataPlaneServer(host="127.0.0.1"), tkt.KvDataPlaneServer(host="127.0.0.1")]
        for s in servers:
            await s.start()
        try:
            for server, client in ((servers[0], tkt), (servers[1], jkt)):
                desc = client.KvTransferDescriptor(
                    transfer_id="0123456789abcdef", addr=server.addr, n_pages=2, n_tokens=9,
                    page_size=PS, page_shape=[L, PS, KH, D], dtype="float32", chunk_pages=1)

                async def inject(*_):
                    raise AssertionError("nothing may be injected")

                with pytest.raises(RuntimeError, match="unknown transfer"):
                    await client.pull_kv(desc, inject)
        finally:
            for s in servers:
                await s.close()

    run(main())


def test_oversized_frame_is_refused():
    """A peer announcing more bytes than the descriptor allows is cut off
    before anything is read; an oversized handshake to the port's server
    drops that connection and the server keeps serving."""
    async def main():
        async def rogue(reader, writer):
            await reader.readexactly(tkt._HDR.size + 16)
            body = tkt.msgpack_lite.packb({"off": 0, "n": 1, "k_bytes": 1 << 30, "v_bytes": 8})
            writer.write(tkt._HDR.pack(tkt._MAGIC, len(body)) + body)
            await writer.drain()
            writer.close()

        srv = await asyncio.start_server(rogue, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        desc = tkt.KvTransferDescriptor(
            transfer_id="0123456789abcdef", addr=f"127.0.0.1:{port}", n_pages=2, n_tokens=9,
            page_size=PS, page_shape=[L, PS, KH, D], dtype="float32", chunk_pages=1)

        async def inject(*_):
            raise AssertionError("nothing may be injected")

        try:
            with pytest.raises(RuntimeError, match="larger than descriptor allows"):
                await tkt.pull_kv(desc, inject)
        finally:
            srv.close()
            await srv.wait_closed()

        server = tkt.KvDataPlaneServer(host="127.0.0.1")
        await server.start()
        try:
            host, p = server.addr.rsplit(":", 1)
            reader, writer = await asyncio.open_connection(host, int(p))
            writer.write(tkt._HDR.pack(tkt._MAGIC, 5000) + b"x" * 5000)
            await writer.drain()
            assert await reader.read() == b""  # closed without an answer
            writer.close()
            k_all, v_all = _pages("float32")

            async def extract(off, n, device):
                return k_all[:, off:off + n], v_all[:, off:off + n]

            desc = server.stage(extract=extract, on_done=lambda ok: None,
                                **_stage_args("float32", 3))
            got = []

            async def keep(off, n, k, v):
                got.append(n)

            await jkt.pull_kv(jkt.KvTransferDescriptor.from_dict(desc.to_dict()), keep)
            assert got == [3, 3]
        finally:
            await server.close()

    run(main())


def test_ttl_reaper_releases_unpulled_pages():
    async def main():
        server = tkt.KvDataPlaneServer(host="127.0.0.1", ttl=0.05)
        await server.start()
        done = asyncio.Event()
        outcome = []

        def on_done(ok):
            outcome.append(ok)
            done.set()

        async def extract(off, n, device):
            raise AssertionError("never pulled")

        desc = server.stage(extract=extract, on_done=on_done, **_stage_args("float32", 2))
        assert (server.addr, desc.transfer_id) in tkt._LOCAL
        try:
            await asyncio.wait_for(done.wait(), 5)
        finally:
            await server.close()
        assert outcome == [False]
        assert (server.addr, desc.transfer_id) not in tkt._LOCAL

    run(main())


def test_zero_page_transfer_sends_only_eof():
    async def main():
        server = tkt.KvDataPlaneServer(host="127.0.0.1")
        await server.start()
        released = []

        async def extract(off, n, device):
            raise AssertionError("no page to extract")

        desc = server.stage(extract=extract, on_done=released.append,
                            **dict(_stage_args("float32", 2), n_pages=0))

        async def inject(*_):
            raise AssertionError("no page to inject")

        try:
            await jkt.pull_kv(jkt.KvTransferDescriptor.from_dict(desc.to_dict()), inject)
        finally:
            await server.close()
        assert released == [True] and server.bytes_served == 0

    run(main())


def test_kvbm_blocks_and_checkpoint_pushes_are_refused_typed():
    async def main():
        server = tkt.KvDataPlaneServer(host="127.0.0.1")
        await server.start()
        try:
            # a data plane without tiers refuses block pulls typed
            with pytest.raises(KeyError, match="no kvbm tier"):
                await jkt.pull_kvbm_blocks(server.addr, [1, 2], (L, PS, KH, D), np.float32)
            k = np.zeros((1, L, PS, KH, D), np.float32)
            with pytest.raises(jkt.KvTransferError, match="no kvbm tier") as e:
                await jkt.push_checkpoint_blocks(server.addr, [7], [None], k, k)
            assert e.value.ckpt_ineligible
        finally:
            await server.close()

    run(main())


# ---------------------------------------------------------------------- #
# router + inline payload
# ---------------------------------------------------------------------- #


def test_disagg_router_decides_as_the_reference():
    cases = [
        dict(prompt_len=100, prefix_hit_tokens=0, have_prefill_workers=True),
        dict(prompt_len=100, prefix_hit_tokens=40, have_prefill_workers=True),
        dict(prompt_len=64, prefix_hit_tokens=0, have_prefill_workers=True),
        dict(prompt_len=500, prefix_hit_tokens=0, have_prefill_workers=False),
    ]
    for depth, age in ((None, None), (10, 0.0), (100, 0.0), (100, 10.0)):
        routers = [jdisagg.DisaggregatedRouter(), tdisagg.DisaggregatedRouter()]
        for r in routers:
            if depth is not None:
                r.update_queue_depth(depth, now=1000.0)
        for case in cases:
            now = None if age is None else 1000.0 + age
            got = [r.prefill_remote(**case, now=now) for r in routers]
            assert got[0] == got[1], (depth, age, case)
        for r in routers:
            r.invalidate("test")
            assert not r.queue_depth_known()


@pytest.mark.parametrize("fmt", ["float32", "bfloat16", "int8"])
def test_inline_payload_interoperates(fmt):
    k_all, v_all = _pages(fmt)
    kv_format = "int8" if fmt == "int8" else "none"
    # port packs -> reference unpacks
    payload = tdisagg.pack_kv_payload(_as_torch(k_all), _as_torch(v_all), 45, PS, kv_format)
    want = jdisagg.pack_kv_payload(k_all, v_all, 45, PS, kv_format)
    assert payload == want
    jk, jv, n = jdisagg.unpack_kv_payload(payload)
    assert n == 45 and _bytes(jk) == _bytes(k_all) and _bytes(jv) == _bytes(v_all)
    # reference packs -> port unpacks
    tk, tv, n = tdisagg.unpack_kv_payload(want)
    assert n == 45 and _bytes(tk) == _bytes(k_all) and _bytes(tv) == _bytes(v_all)
