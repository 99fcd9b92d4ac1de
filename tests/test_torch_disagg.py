"""Disaggregated prefill/decode on the port, against the JAX package, on the CPU.

The reference's engine-level cases (`tests/test_kv_transfer.py`) on the
port, then across frameworks, then end to end:

* a port prefill engine stages on the port's data plane and a port decode
  engine pulls — through the in-process registry and over TCP — and the
  stream must EQUAL the JAX engine's aggregated stream; a dead descriptor
  must fall back to a local prefill with the same stream and every page
  released; an unpulled stage must release the prefill engine's pages;
* a `JaxEngine` prefills and a `TorchEngine` decodes, and the reverse, each
  over its own package's data plane (TCP: the two registries are
  separate), in scatter and local pool modes, serially and through each
  package's disagg handler with the streamed (early-staged) handoff:
  token-identical to the JAX aggregated stream, with the pulled pages
  committed to the decoding engine's prefix cache under the same block
  hashes as the reference;
* the port's handler in each branch: streamed, serial, inline, and the
  local fallbacks when the prefill pool is empty or its stream dies;
* a kv_format mismatch (fp prefill, int8 decode) fails typed before a byte
  moves and resumes with the stream the reference's engine gives;
* the unmodified reference frontend + a port prefill worker + a port decode
  worker (`--device cpu`, `--disagg-threshold 16`): the `remote_prefill`
  annotation is true and the text equals a local prefill's; a killed
  prefill worker falls back to local prefill.

Weights are drawn at std 0.15, as in `test_torch_engine.py`, so an f32
rounding difference between the frameworks cannot flip an argmax.
"""

import asyncio
import signal
import json
import logging
import time
import types

import httpx
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.jax_worker.disagg_handler import maybe_remote_prefill as jax_handler
from dynamo_tpu.llm import kv_transfer as jkt
from dynamo_tpu.llm.disagg import DisaggConfig as JaxDisaggConfig
from dynamo_tpu.llm.disagg import DisaggregatedRouter as JaxDisaggRouter
from dynamo_tpu.llm.tokens import compute_seq_hashes
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm import kv_transfer as tkt
from dynamo_tpu_torch.llm.disagg import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.request_plane import StreamLost
from dynamo_tpu_torch.worker.disagg_handler import maybe_remote_prefill

from .test_torch_engine import numpy_params
from .utils import ManagedProcess, free_port, scrape_worker_stats

KW = dict(model="tiny", max_num_seqs=4, page_size=8, num_pages=64, max_model_len=128,
          prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4)
PROMPT = [int(t) for t in np.random.RandomState(3).randint(3, 500, size=37)]  # 4 pages + 5
MAX_TOKENS = 10
LIMIT = 60  # seconds a test's coroutine may take
TEST_LIMIT = 120  # seconds any test may take (the end-to-end one starts processes)


@pytest.fixture(autouse=True)
def time_limit():
    """Every test fails, instead of hanging, past TEST_LIMIT seconds."""
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {TEST_LIMIT} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


def make_req(**kw) -> dict:
    return {"token_ids": list(PROMPT), "request_id": "r1",
            "stop_conditions": {"max_tokens": MAX_TOKENS}, **kw}


def prefill_request() -> dict:
    return make_req(stop_conditions={"max_tokens": 1},
                   disagg_params={"return_kv": True, "kv_pull": True})


async def collect(agen):
    """(token ids, kv_transfer_params of the last item that had them)."""
    ids, kvp = [], None
    async for item in agen:
        assert item.get("event") != "error", item
        data = item.get("data")
        if data:
            ids += data.get("token_ids") or []
            if data.get("kv_transfer_params") is not None:
                kvp = data["kv_transfer_params"]
    return ids, kvp


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


def jax_engine(weights, **kw) -> JaxEngine:
    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)
    return JaxEngine(JaxEngineConfig(**KW, decode_block_unroll=1, **kw),
                     model_config=jllama.LlamaConfig.tiny(dtype=jnp.float32), params=params)


def torch_engine(weights, **kw) -> TorchEngine:
    return TorchEngine(EngineConfig(**KW, **kw),
                       model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                       params=params_from_jax(weights, device="cpu"), device="cpu")


class EngineClient:
    """A prefill pool of one in-process engine, as a handler's PushRouter
    sees an endpoint client. `dead=True`: the instance is listed but its
    stream is lost; `instances=[]`: an empty pool."""

    def __init__(self, engine, ctx_cls, instances=(1,), dead=False):
        self.engine, self.ctx_cls, self.dead = engine, ctx_cls, dead
        self.instances = list(instances)
        self.endpoint = types.SimpleNamespace(subject="dynamo/prefill/generate")

    def instance_ids(self):
        return list(self.instances)

    ready_instance_ids = instance_ids

    async def direct(self, request, instance_id, context=None):
        if self.dead:
            raise StreamLost("prefill instance gone")
        return self.engine.generate(request, self.ctx_cls())


def handler_request() -> dict:
    return make_req(annotations=["remote_prefill"])


async def collect_handled(agen):
    """(token ids, the remote_prefill annotation) of a handler's stream."""
    ids, remote = [], None
    async for item in agen:
        if item.get("event") == "remote_prefill":
            remote = item["comment"] == ["true"]
            continue
        assert item.get("event") != "error", item
        ids += (item.get("data") or {}).get("token_ids") or []
    return ids, remote


def port_router():
    return DisaggregatedRouter(DisaggConfig(remote_prefill_threshold_tokens=16))


def stored_hashes(events) -> list:
    return [h for ev in events if ev.event_type == "stored" for h in ev.block_hashes]


@pytest.fixture(scope="module", params=["scatter", "local"])
def cross(request, weights):
    """One pool mode: the JAX aggregated stream, a JAX prefill handed to a
    port decode engine, and a port prefill handed to a JAX decode engine,
    each over its prefill side's data plane."""
    mode = request.param

    async def main():
        out = {"mode": mode}
        jeng = jax_engine(weights, decode_pool_mode=mode)
        jplane = jkt.KvDataPlaneServer(host="127.0.0.1")
        await jplane.start()
        jeng.data_plane = jplane
        teng = torch_engine(weights, decode_pool_mode=mode)
        tpre = torch_engine(weights, role="prefill")
        tplane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await tplane.start()
        tpre.data_plane = tplane
        try:
            out["aggregated"], _ = await collect(jeng.generate(make_req(), JaxContext()))
            jeng.clear_kv_blocks()
            # JAX prefills, the port decodes (port pull_kv <- reference server)
            first, kvp = await collect(jeng.generate(prefill_request(), JaxContext()))
            events = []
            teng.allocator.event_sink = events.append
            rest, _ = await collect(teng.generate_decode_from_pull(
                make_req(), Context(), first[0], kvp["pull"]))
            out["jax_to_port"] = first + rest
            out["port_stored"] = stored_hashes(events)
            out["port_stats"] = teng.stats()
            out["jax_served"] = (jplane.transfers_served, jplane.bytes_served)
            jeng.clear_kv_blocks()
            # the port prefills, JAX decodes (reference pull_kv <- port server)
            first, kvp = await collect(tpre.generate(prefill_request(), Context()))
            events = []
            jeng.allocator.event_sink = events.append
            rest, _ = await collect(jeng.generate_decode_from_pull(
                make_req(), JaxContext(), first[0], kvp["pull"]))
            out["port_to_jax"] = first + rest
            out["jax_stored"] = stored_hashes(events)
            out["jax_stats"] = jeng.stats()
            out["port_served"] = (tplane.transfers_served, tplane.bytes_served)
            out["prefill_active_pages"] = tpre.allocator.active_pages
            # the same two handoffs through each decode side's handler,
            # streamed: the pull starts off the early descriptor
            jeng.clear_kv_blocks()
            teng.clear_kv_blocks()
            out["jax_to_port_streamed"] = await collect_handled(maybe_remote_prefill(
                teng, EngineClient(jeng, JaxContext), port_router(), handler_request(),
                Context()))
            out["port_streamed_stats"] = teng.stats()
            jeng.clear_kv_blocks()
            out["port_to_jax_streamed"] = await collect_handled(jax_handler(
                jeng, EngineClient(tpre, Context),
                JaxDisaggRouter(JaxDisaggConfig(remote_prefill_threshold_tokens=16)),
                handler_request(), JaxContext()))
            out["jax_streamed_stats"] = jeng.stats()
            out["port_prefill_stats"] = tpre.stats()
        finally:
            for eng in (jeng, teng, tpre):
                await eng.close()
            await jplane.close()
            await tplane.close()
        return out

    return run(main())


def test_jax_prefill_port_decode_is_token_identical(cross):
    assert len(cross["aggregated"]) == MAX_TOKENS
    assert cross["jax_to_port"] == cross["aggregated"]
    stats = cross["port_stats"]
    assert stats["kv_pulls_completed"] == 1 and stats["kv_pages_pulled"] == 5
    assert stats["kv_pull_fallbacks"] == 0
    assert cross["jax_served"][0] == 1 and cross["jax_served"][1] > 0  # over TCP


def test_port_prefill_jax_decode_is_token_identical(cross):
    assert cross["port_to_jax"] == cross["aggregated"]
    assert cross["jax_stats"]["kv_pulls_completed"] == 1
    assert cross["port_served"][0] == 1 and cross["port_served"][1] > 0
    assert cross["prefill_active_pages"] == 0  # the pull released the stage


def test_streamed_handoff_across_frameworks_is_token_identical(cross):
    """Each package's handler, streamed: JAX prefill -> port decode and
    port prefill -> JAX decode."""
    assert cross["jax_to_port_streamed"] == (cross["aggregated"], True)
    assert cross["port_to_jax_streamed"] == (cross["aggregated"], True)
    assert cross["port_streamed_stats"]["disagg_streamed_handoffs"] == 1
    assert cross["jax_streamed_stats"]["disagg_streamed_handoffs"] == 1
    assert cross["port_prefill_stats"]["kv_streamed_stages"] == 1
    for key in ("port_streamed_stats", "jax_streamed_stats"):
        assert cross[key]["kv_pulls_completed"] == 2, key


def test_pulled_pages_are_committed_like_the_reference(cross):
    """The decode side publishes the pulled prompt's full pages to its
    prefix cache: the router sees the same stored block hashes whichever
    framework decodes."""
    want = compute_seq_hashes(PROMPT, KW["page_size"])[: len(PROMPT) // KW["page_size"]]
    assert cross["port_stored"][: len(want)] == want
    assert cross["port_stored"] == cross["jax_stored"]


@pytest.mark.parametrize("path", ["local_registry", "tcp"])
def test_port_pair_is_token_identical(weights, cross, path):
    """Port prefill -> port decode: in process the chunks hand over as
    tensors through the registry; over TCP as bytes."""
    async def main():
        pre = torch_engine(weights, role="prefill")
        dec = torch_engine(weights, decode_pool_mode=cross["mode"])
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await plane.start()
        pre.data_plane = plane
        try:
            first, kvp = await collect(pre.generate(prefill_request(), Context()))
            assert kvp["pull"]["kv_format"] == "none" and kvp["pull"]["n_pages"] == 5
            if path == "tcp":
                tkt._LOCAL.pop((plane.addr, kvp["pull"]["transfer_id"]))
            rest, _ = await collect(dec.generate_decode_from_pull(
                make_req(), Context(), first[0], kvp["pull"]))
            return (first + rest, dec.stats(), pre.allocator.active_pages,
                    plane.transfers_served, dec.allocator.active_pages)
        finally:
            for x in (pre, dec, plane):
                await x.close()

    got, stats, pre_active, served, dec_active = run(main())
    assert got == cross["aggregated"]
    assert stats["kv_pulls_completed"] == 1 and stats["kv_pages_injected"] == 5
    assert pre_active == 0 and dec_active == 0 and served == 1


def test_inline_payload_without_a_data_plane(weights, cross):
    """A prefill engine without a data plane answers with the pages inline."""
    async def main():
        pre = torch_engine(weights, role="prefill")
        dec = torch_engine(weights, decode_pool_mode=cross["mode"])
        try:
            first, kvp = await collect(pre.generate(prefill_request(), Context()))
            assert "pull" not in kvp and kvp["fmt"] == "none" and kvp["dtype"] == "float32"
            from dynamo_tpu_torch.llm.disagg import unpack_kv_payload

            k, v, n = unpack_kv_payload(kvp)
            rest, _ = await collect(dec.generate_decode_from_kv(
                make_req(), Context(), first[0], k, v, n))
            return first + rest, pre.allocator.active_pages
        finally:
            await pre.close()
            await dec.close()

    got, pre_active = run(main())
    assert got == cross["aggregated"] and pre_active == 0


def test_dead_descriptor_falls_back_to_local_prefill(weights, cross, caplog):
    dead = tkt.KvTransferDescriptor(
        transfer_id="gone", addr=f"127.0.0.1:{free_port()}", n_pages=5, n_tokens=len(PROMPT),
        page_size=8, page_shape=[2, 8, 2, 8], dtype="float32", chunk_pages=2)

    async def main():
        dec = torch_engine(weights, decode_pool_mode=cross["mode"])
        free_before = dec.allocator.free_pages
        try:
            rest, _ = await collect(dec.generate_decode_from_pull(
                make_req(), Context(), cross["aggregated"][0], dead.to_dict()))
            return rest, dec.stats(), free_before, dec.allocator
        finally:
            await dec.close()

    with caplog.at_level(logging.WARNING, logger="dynamo_tpu_torch.engine.engine"):
        rest, stats, free_before, alloc = run(main())
    assert [cross["aggregated"][0]] + rest == cross["aggregated"]
    assert stats["kv_pull_fallbacks"] == 1 and stats["kv_pulls_completed"] == 0
    assert "KvTransferError" in caplog.text
    # every page is back (free, or evictable in the prefix cache it fed)
    assert alloc.active_pages == 0
    assert alloc.free_pages == free_before


def test_morph_and_the_sharded_handoff_are_refused_typed(weights, cross, caplog):
    """A morph to a role the engine has not got is refused typed; a
    multi-host descriptor (`shards`) is refused typed and the request
    prefills locally with the same stream."""
    sharded = tkt.KvTransferDescriptor(
        transfer_id="0123456789abcdef", addr=f"127.0.0.1:{free_port()}", n_pages=5,
        n_tokens=len(PROMPT), page_size=8, page_shape=[2, 8, 1, 8], dtype="float32",
        chunk_pages=2, shards=[{"host_id": 0, "addr": "127.0.0.1:1"},
                               {"host_id": 1, "addr": "127.0.0.1:2"}])

    async def main():
        dec = torch_engine(weights, decode_pool_mode=cross["mode"])
        try:
            with pytest.raises(ValueError, match="unknown role"):
                await dec.morph("router")
            rest, _ = await collect(dec.generate_decode_from_pull(
                make_req(), Context(), cross["aggregated"][0], sharded.to_dict()))
            return rest, dec.stats()
        finally:
            await dec.close()

    with caplog.at_level(logging.WARNING, logger="dynamo_tpu_torch.engine.engine"):
        rest, stats = run(main())
    assert "UnsupportedConfigError: multi-host shard" in caplog.text
    assert [cross["aggregated"][0]] + rest == cross["aggregated"]
    assert stats["kv_pull_fallbacks"] == 1


def test_unpulled_stage_releases_the_prefill_pages(weights):
    async def main():
        pre = torch_engine(weights, role="prefill")
        plane = tkt.KvDataPlaneServer(host="127.0.0.1", ttl=0.5)
        await plane.start()
        pre.data_plane = plane
        try:
            _, kvp = await collect(pre.generate(prefill_request(), Context()))
            assert pre.allocator.active_pages == 5  # pinned for the pull
            while pre.allocator.active_pages:  # bounded by run()'s limit
                await asyncio.sleep(0.01)
            assert (plane.addr, kvp["pull"]["transfer_id"]) not in tkt._LOCAL
        finally:
            await pre.close()
            await plane.close()

    run(main())


def test_kv_format_mismatch_fails_typed_and_resumes(weights, caplog):
    """fp pages staged, an int8 decode engine pulls: KvFormatError before a
    byte moves, then a local prefill from the prefill worker's first token —
    the same stream the reference's engine gives in the same situation."""
    async def main():
        pre = torch_engine(weights, role="prefill")
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await plane.start()
        pre.data_plane = plane
        tdec = torch_engine(weights, kv_quant="int8")
        jdec = jax_engine(weights, kv_quant="int8")
        try:
            out = []
            for dec, ctx in ((tdec, Context), (jdec, JaxContext)):
                first, kvp = await collect(pre.generate(prefill_request(), Context()))
                rest, _ = await collect(dec.generate_decode_from_pull(
                    make_req(), ctx(), first[0], kvp["pull"]))
                out.append(first + rest)
                plane.unstage_by_id(kvp["pull"]["transfer_id"], ok=False)
            return out, tdec.stats(), jdec.stats(), plane.bytes_served, pre.allocator.active_pages
        finally:
            for x in (pre, tdec, jdec, plane):
                await x.close()

    with caplog.at_level(logging.WARNING, logger="dynamo_tpu_torch.engine.engine"):
        (port, ref), tstats, jstats, served, pre_active = run(main())
    assert "KvFormatError" in caplog.text
    assert len(port) == MAX_TOKENS and port == ref
    assert tstats["kv_format_mismatches"] == 1 == jstats["kv_format_mismatches"]
    assert tstats["kv_pulls_completed"] == 0 and tstats["kv_pull_fallbacks"] == 1
    assert served == 0 and pre_active == 0


# ---------------------------------------------------------------------- #
# end to end: the reference frontend + a port prefill and a port decode worker
# ---------------------------------------------------------------------- #

MODEL = "tiny-disagg"


def _generate(base, prompt, max_tokens=8):
    """(text, the remote_prefill annotation)."""
    remote, text = None, ""
    with httpx.Client(timeout=60) as client:
        with client.stream("POST", f"{base}/v1/completions", json={
            "model": MODEL, "prompt": prompt, "max_tokens": max_tokens,
            "temperature": 0.0, "stream": True,
            "nvext": {"annotations": ["remote_prefill"]},
        }) as r:
            assert r.status_code == 200, r.read()
            for line in r.iter_lines():
                if line.startswith(": remote_prefill"):
                    remote = json.loads(line.split(" ", 2)[2])[0] == "true"
                elif line.startswith("data: "):
                    if line[6:] == "[DONE]":
                        break
                    for ch in json.loads(line[6:]).get("choices", []):
                        text += ch.get("text") or ""
    return text, remote


def _local_text(prompt: str, max_tokens: int = 8) -> str:
    """The workers' model (random weights from seed 0) run aggregated in
    process: what a local prefill on the decode worker produces."""
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
    from dynamo_tpu_torch.llm.tokenizers import ByteTokenizer

    tok = ByteTokenizer()

    async def main():
        eng = TorchEngine(EngineConfig(model="tiny", page_size=8, num_pages=128,
                                       max_num_seqs=4, max_model_len=256), device="cpu")
        try:
            req = PreprocessedRequest(token_ids=tok.encode(prompt), request_id="oracle",
                                      stop_conditions={"max_tokens": max_tokens}).to_dict()
            ids, _ = await collect(eng.generate(req, Context()))
        finally:
            await eng.close()
        return tok.decode(ids)

    return run(main())


def test_frontend_serves_through_a_port_prefill_and_decode_pair(tmp_path):
    http_port = free_port()
    disc = f"tcp://127.0.0.1:{free_port()}"
    env = {"DYN_LEASE_TTL_S": "3"}
    common = ["-m", "dynamo_tpu_torch.worker", "--model", "tiny", "--model-name", MODEL,
              "--device", "cpu", "--discovery", disc, "--page-size", "8",
              "--kv-data-plane-host", "127.0.0.1",
              "--num-pages", "128", "--max-num-seqs", "4", "--max-model-len", "256",
              "--context-length", "256"]
    procs = []
    try:
        fe = ManagedProcess(["-m", "dynamo_tpu.frontend", "--http-port", str(http_port),
                             "--embed-discovery", "--discovery", disc],
                            name="tdis_fe", env=env).start(str(tmp_path / "fe.log"))
        procs.append(fe)
        fe.wait_port(http_port)
        decode = ManagedProcess([*common, "--role", "decode", "--disagg-threshold", "16"],
                                name="tdis_decode", env=env).start(str(tmp_path / "decode.log"))
        prefill = ManagedProcess([*common, "--role", "prefill"],
                                 name="tdis_prefill", env=env).start(str(tmp_path / "prefill.log"))
        procs += [decode, prefill]
        prefill.wait_log("torch worker up", timeout=60)
        decode.wait_log("prefill queue watcher active", timeout=60)
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.time() + 30
        with httpx.Client() as client:
            while not client.get(f"{base}/v1/models").json()["data"]:
                assert time.time() < deadline, "the decode worker never registered"
                time.sleep(0.1)

        prompt = "Disaggregation sends long uncached prompts to the prefill pool! " * 2
        text, remote = _generate(base, prompt)
        assert remote is True, (tmp_path / "decode.log").read_text()[-3000:]
        assert text == _local_text(prompt)
        stats = scrape_worker_stats(disc, lambda s: s.get("kv_pulls_completed", 0) > 0)
        assert stats["kv_pages_pulled"] > 0 and stats["kv_pull_fallbacks"] == 0
        # the pull rode the early-staged descriptor (DYN_DISAGG_STREAM is on
        # by default), overlapping the prefill worker's compute
        assert stats["disagg_streamed_handoffs"] > 0
        served = scrape_worker_stats(disc, lambda s: s.get("kv_transfers_served", 0) > 0,
                                     component="prefill")
        assert served["kv_bytes_served"] > 0 and served["engine_role"] == "prefill"
        assert served["kv_streamed_stages"] > 0
        assert "prefilling locally" not in (tmp_path / "decode.log").read_text()
        # short prompts stay local (the threshold)
        assert _generate(base, "hi")[1] is False

        prefill.sigkill()
        prompt = "resilience check " * 10
        text, remote = _generate(base, prompt)
        assert remote is False
        assert text == _local_text(prompt)
    finally:
        for p in reversed(procs):
            p.stop()


@pytest.mark.parametrize("stream", [True, False], ids=["streamed", "serial"])
def test_handler_hands_off_streamed_or_serial(weights, cross, stream, monkeypatch):
    monkeypatch.setenv("DYN_DISAGG_STREAM", "1" if stream else "0")

    async def main():
        pre = torch_engine(weights, role="prefill")
        dec = torch_engine(weights, decode_pool_mode=cross["mode"])
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await plane.start()
        pre.data_plane = plane
        try:
            got = await collect_handled(maybe_remote_prefill(
                dec, EngineClient(pre, Context), port_router(), handler_request(), Context()))
            return got, dec.stats(), pre.stats()
        finally:
            for x in (pre, dec, plane):
                await x.close()

    (ids, remote), dstats, pstats = run(main())
    assert remote is True and ids == cross["aggregated"]
    assert dstats["kv_pulls_completed"] == 1 and dstats["kv_pull_fallbacks"] == 0
    assert dstats["disagg_streamed_handoffs"] == int(stream)
    assert pstats["kv_streamed_stages"] == int(stream)
    assert pstats["kv_pages_extracted"] == 5 and pstats["num_running_reqs"] == 0


@pytest.mark.parametrize("pool", ["empty", "dead", "no_data_plane", "short_prompt"])
def test_handler_fallbacks(weights, cross, pool):
    """An empty pool or a dead prefill stream prefill locally (annotation
    false); a prefill worker without a data plane answers inline; a prompt
    under the threshold stays local."""
    async def main():
        pre = torch_engine(weights, role="prefill")
        dec = torch_engine(weights, decode_pool_mode=cross["mode"])
        client = EngineClient(pre, Context, instances=[] if pool == "empty" else [1],
                              dead=pool == "dead")
        req = handler_request()
        if pool == "short_prompt":
            req["token_ids"] = req["token_ids"][:12]
        try:
            got = await collect_handled(maybe_remote_prefill(
                dec, client, port_router(), req, Context()))
            return got, dec.stats()
        finally:
            await pre.close()
            await dec.close()

    (ids, remote), stats = run(main())
    assert remote is (pool == "no_data_plane")
    if pool != "short_prompt":
        assert ids == cross["aggregated"]
    assert len(ids) == MAX_TOKENS and stats["kv_pulls_completed"] == 0


def test_early_pull_is_abandoned_when_the_prefill_stream_dies(weights, cross, monkeypatch):
    """The prefill stream is lost right after its early (streamed)
    descriptor: the handler abandons the early pull and prefills locally,
    and both sides let go of every page."""
    monkeypatch.setenv("DYN_DISAGG_STREAM", "1")

    class Dying(EngineClient):
        async def direct(self, request, instance_id, context=None):
            inner = self.engine.generate(request, self.ctx_cls())

            async def stream():
                try:
                    async for item in inner:
                        yield item
                        data = item.get("data") or {}
                        if data.get("kv_transfer_params") and not data.get("token_ids"):
                            raise StreamLost("prefill worker lost mid-stream")
                finally:
                    await inner.aclose()

            return stream()

    async def main():
        pre = torch_engine(weights, role="prefill")
        dec = torch_engine(weights, decode_pool_mode=cross["mode"])
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await plane.start()
        pre.data_plane = plane
        try:
            got = await collect_handled(maybe_remote_prefill(
                dec, Dying(pre, Context), port_router(), handler_request(), Context()))
            while pre.allocator.active_pages or dec.allocator.active_pages:
                await asyncio.sleep(0.01)  # bounded by run()'s limit
            return got, dec.stats(), pre.stats()
        finally:
            for x in (pre, dec, plane):
                await x.close()

    (ids, remote), dstats, pstats = run(main())
    assert remote is False and ids == cross["aggregated"]
    assert pstats["kv_streamed_stages"] == 1
    assert dstats["kv_pulls_completed"] == 0 and dstats["disagg_streamed_handoffs"] == 0
