"""The port's request migration against the JAX package's, on the CPU.

* `RetryManager._retry_request` builds the same retry request as the
  reference's on the reference's hygiene cases: the prompt extended by the
  emitted tokens, `max_tokens` and `min_tokens` shrunk by their count, the
  `migration` ordinal, the corpse unioned into `router.exclude_instances`,
  and stale pins, holder hints and transfer descriptors dropped.
* Streams cut after k tokens (StreamLost, the corpse recorded on the
  context) and retried through the port's `Migration` on a port engine equal
  the uninterrupted port stream and `JaxEngine`'s, greedy and seeded; the
  reference frontend's `Migration` over the same port engine gives the same
  stream. The survivor counts each retry as a resumed migration and
  recomputes its tail decode-shaped.
* Durable sessions on an in-process two-engine mesh with DYN_KV_CHECKPOINT:
  engine A's session replicates into B's host tier; A dies; the retry on B
  is classified `checkpoint`, re-prefills under two pages, and its stream
  equals A's uninterrupted one. The corpse is excluded explicitly, as the
  retry does: nothing waits on a lease.
"""

import asyncio
import signal
import time

import jax
import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.llm import migration as ref_migration
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu.runtime.request_plane import StreamLost as RefStreamLost
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.kvbm import KvbmDistributed
from dynamo_tpu_torch.llm import kv_transfer as tkt
from dynamo_tpu_torch.llm.migration import MIGRATION_METRICS, Migration, RetryManager
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.discovery import DiscoveryServer
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.request_plane import StreamLost

from .test_torch_engine import numpy_params

LIMIT = 60
PAGE = 8
KW = dict(model="tiny", max_num_seqs=4, page_size=PAGE, num_pages=64, max_model_len=256,
          prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4)
CORPSE = 0xA


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


# ---------------------------------------------------------------------- #
# retry-request hygiene
# ---------------------------------------------------------------------- #

HYGIENE = {
    "stop_floors_and_ordinal": (dict(token_ids=[1, 2, 3], request_id="r1",
                                     stop_conditions={"max_tokens": 10, "min_tokens": 6}),
                                [7, 8, 9, 10], {0xA}),
    "caller_exclusions_union": (dict(token_ids=[1], stop_conditions={"max_tokens": 8},
                                     router={"exclude_instances": [0xBAD]}), [5], {0xA}),
    "min_floors_at_zero_max_at_one": (dict(token_ids=[1],
                                           stop_conditions={"max_tokens": 3, "min_tokens": 2}),
                                      [5, 6, 7, 8], set()),
    "holder_naming_corpse_dropped": (dict(token_ids=[1],
                                          kv_holder={"instance": 0xDEAD, "blocks": 4}),
                                     [2], {0xDEAD}),
    "live_holder_kept": (dict(token_ids=[1], kv_holder={"instance": 0xB, "blocks": 4}),
                         [2], {0xDEAD}),
    "pin_naming_corpse_dropped": (dict(token_ids=[1], router={"backend_instance_id": 0xDEAD}),
                                  [2], {0xDEAD}),
    "live_pin_kept": (dict(token_ids=[1], router={"backend_instance_id": 0xB}),
                      [2], {0xDEAD}),
    "descriptor_stripped_flags_kept": (dict(token_ids=[1], disagg_params={
        "return_kv": True, "kv_pull": True, "kv_stream": True,
        "pull": {"transfer_id": "t1", "addr": "1.2.3.4:5"}}), [2], {0xA}),
    "descriptor_only_params_dropped": (dict(token_ids=[1], disagg_params={
        "pull": {"transfer_id": "t1", "addr": "x:1"}}), [2], set()),
}


@pytest.mark.parametrize("case", sorted(HYGIENE))
def test_retry_request_equals_the_reference(case):
    spec, emitted, dead = HYGIENE[case]
    out = []
    for manager_cls, request_cls in ((ref_migration.RetryManager, JaxRequest),
                                     (RetryManager, PreprocessedRequest)):
        m = manager_cls(None, request_cls(**spec), 3)
        m.emitted_tokens, m.dead_instances, m.attempts = list(emitted), set(dead), 1
        out.append(m._retry_request().to_dict())
    want, got = out
    assert got == want
    assert got["token_ids"] == spec["token_ids"] + emitted and got["migration"] == 1
    assert got["router"]["exclude_instances"] == sorted(
        set(dead) | set(spec.get("router", {}).get("exclude_instances", [])))


# ---------------------------------------------------------------------- #
# cut streams, retried
# ---------------------------------------------------------------------- #

PROMPT = [(11 + 3 * j) % 250 + 1 for j in range(27)]
STREAMS = {
    "greedy": {},
    "seeded": {"temperature": 0.8, "seed": 7},
}
MAX_TOKENS = 24
CUT = 9


def _request(sampling, rid):
    return dict(token_ids=list(PROMPT), request_id=rid,
                stop_conditions={"max_tokens": MAX_TOKENS, "ignore_eos": True},
                sampling_options=dict(sampling))


def _tokens(items):
    toks = []
    for it in items:
        it = it.to_dict() if hasattr(it, "to_dict") else it
        assert it.get("event") != "error", it
        toks.extend((it.get("data") or {}).get("token_ids") or [])
    return toks


class _Cut:
    """A port engine behind a link that dies after `cut` tokens of the first
    attempt: the stream ends in StreamLost with the corpse recorded on the
    context, as the request plane leaves it."""

    def __init__(self, engine, cut, lost=StreamLost):
        self.engine, self.cut, self.lost = engine, cut, lost
        self.requests = []

    async def generate(self, request, context):
        req = request if isinstance(request, dict) else request.to_dict()
        self.requests.append(req)
        first = len(self.requests) == 1
        if first:
            context.routed_instance = CORPSE
        sent = 0
        stream = self.engine.generate(req, Context())
        try:
            async for item in stream:
                toks = (item.get("data") or {}).get("token_ids") or []
                if first and sent + len(toks) >= self.cut:
                    data = dict(item["data"], token_ids=toks[: self.cut - sent])
                    data.pop("finish_reason", None)
                    yield dict(item, data=data)
                    raise self.lost("injected: worker died mid-stream")
                sent += len(toks)
                yield item
        finally:
            await stream.aclose()


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


@pytest.fixture(scope="module")
def jax_streams(weights):
    params = jax.tree.map(jnp.asarray, weights)
    engine = JaxEngine(JaxEngineConfig(**KW), model_config=jllama.LlamaConfig.tiny(
        dtype=jnp.float32), params=params)

    async def main():
        out = {}
        for name, sampling in STREAMS.items():
            out[name] = _tokens([it async for it in engine.generate(
                JaxRequest(**_request(sampling, name)).to_dict(), JaxContext())])
        await engine.close()
        return out

    return run(main())


def port_engine(weights, **over):
    return TorchEngine(EngineConfig(**{**KW, **over}),
                       model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                       params=params_from_jax(weights, device="cpu"), device="cpu")


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_cut_stream_retried_equals_uninterrupted_and_jax(weights, jax_streams, stream):
    async def main():
        engine = port_engine(weights)
        try:
            whole = _tokens([it async for it in engine.generate(
                _request(STREAMS[stream], stream), Context())])
            engine.allocator.clear_cache()  # the retry must not ride the first run's pages
            before = MIGRATION_METRICS.migrations
            cut = _Cut(engine, CUT)
            port = _tokens([a async for a in Migration(cut, migration_limit=2).generate(
                PreprocessedRequest(**_request(STREAMS[stream], stream)), Context())])
            assert MIGRATION_METRICS.migrations == before + 1
            ref_cut = _Cut(engine, CUT, RefStreamLost)
            ref = _tokens([a async for a in ref_migration.Migration(
                ref_cut, migration_limit=2).generate(
                JaxRequest(**_request(STREAMS[stream], stream)), JaxContext())])
            return whole, port, ref, cut.requests, ref_cut.requests, engine.stats()
        finally:
            await engine.close()

    whole, port, ref, requests, ref_requests, stats = run(main())
    assert whole == jax_streams[stream] and len(whole) == MAX_TOKENS
    assert port == whole and ref == whole
    # the retry: the emitted tokens appended, the corpse excluded, counted
    retry = requests[1]
    assert retry == ref_requests[1]
    assert retry["token_ids"] == PROMPT + whole[:CUT] and retry["migration"] == 1
    assert retry["stop_conditions"]["max_tokens"] == MAX_TOKENS - CUT
    assert retry["router"]["exclude_instances"] == [CORPSE]
    assert stats["migrations_resumed"] == 2
    # each resume recomputed its tail decode-shaped (scatter, unquantized)
    assert stats["dev_time"]["replay"]["count"] == 2
    assert stats["migrations_resumed"] == sum(
        stats[f"resume_source_{s}"] for s in ("checkpoint", "peer", "local", "recompute"))


# ---------------------------------------------------------------------- #
# durable sessions on a two-engine mesh
# ---------------------------------------------------------------------- #


async def _mesh(weights, monkeypatch):
    monkeypatch.setenv("DYN_KV_CHECKPOINT", "256")
    disc = DiscoveryServer(port=0)
    host, port = await disc.start()
    members = []
    for _ in range(2):
        cfg = RuntimeConfig()
        cfg.discovery_endpoint = f"tcp://{host}:{port}"
        drt = await DistributedRuntime.create(cfg)
        engine = port_engine(weights, kvbm_host_blocks=64)
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await plane.start()
        await plane.register(drt)
        engine.data_plane = plane
        dist = KvbmDistributed(drt, engine.kvbm, plane, "dynamo", "kvbm", drt.instance_id)
        await dist.start()
        members.append((drt, engine, plane, dist))
    return disc, members


async def _down(member):
    drt, engine, plane, dist = member
    tkt._CONN_POOL.evict(plane.addr)
    await engine.close()
    await dist.close()
    await plane.close()
    await drt.close()


def test_checkpoint_resume_is_a_tail_not_a_prefill(weights, monkeypatch):
    prompt = [(29 + 5 * j) % 250 + 1 for j in range(32)]
    n_out, cut = 96, 48

    async def main():
        disc, (a, b) = await _mesh(weights, monkeypatch)
        try:
            a_id = a[0].instance_id
            for _ in range(500):  # A has heard B's data plane
                if a[3].checkpoint_peer() is not None:
                    break
                await asyncio.sleep(0.01)
            req = dict(token_ids=prompt, request_id="deep",
                       stop_conditions={"max_tokens": n_out, "ignore_eos": True})
            toks = _tokens([it async for it in a[1].generate(req, Context())])
            want_blocks = (len(prompt) + n_out) // PAGE - 1
            deadline = time.monotonic() + 20
            while b[2].checkpoint_blocks_received < want_blocks:
                assert time.monotonic() < deadline, b[2].checkpoint_blocks_received
                await asyncio.sleep(0.02)
            ckpt = a[3].stats()
            await _down(a)  # A dies: its data plane and mesh go dark
            retry = dict(req, token_ids=prompt + toks[:cut], request_id="deep-retry",
                         migration=1, router={"exclude_instances": [a_id]},
                         stop_conditions={"max_tokens": n_out - cut, "ignore_eos": True})
            cont = _tokens([it async for it in b[1].generate(retry, Context())])
            assert b[3]._quarantined(a_id)  # B's fabric no longer pulls from the corpse
            return toks, cont, b[1].stats(), ckpt
        finally:
            await _down(b)
            await disc.stop()

    toks, cont, stats, ckpt = run(main())
    assert len(toks) == n_out and cont == toks[cut:]
    assert ckpt["kvbm_ckpt_blocks_pushed"] >= (len(prompt) + n_out) // PAGE - 1
    assert stats["migrations_resumed"] == 1 and stats["resume_source_checkpoint"] == 1
    assert stats["migration_replayed_tokens"] < 2 * PAGE
    assert stats["dev_time"]["replay"]["count"] == 1
    assert stats["kvbm_onboard_src_local_blocks"] >= (len(prompt) + cut) // PAGE - 1
