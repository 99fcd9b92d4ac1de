"""The port's KVBM in the engine against the JAX package's, on the CPU.

* `TorchEngine` and `JaxEngine` with the same host and disk tiers serve the
  same trace — wave A, waves B and C that push A out of the device pool,
  then A again, each prompt extended by a new turn — one request at a time
  with the offload pipeline drained in between: the token streams are
  identical, and so are the G1 hits, the blocks offloaded and onboarded and
  the host and disk hits; the `kvbm_*` stats keys are the reference's.
* KVBM on and off give the same tokens; an onboard miss (a block evicted
  between probe and load) and an injected `kvbm.onboard` fault fall back to
  prefill, counted.
* The three-arm onboard budget decides as the reference's on the same
  inputs, recompute included.
* The offload pipeline (a fake engine): stages coalesce into one gather and
  a full queue drops its oldest batch.
* Ordering: a page gathered for offload and rewritten at once still lands
  in the tier with its contents from before the rewrite.
"""

import asyncio
import concurrent.futures
import signal
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.kvbm.manager import KvBlockManager as RefManager
from dynamo_tpu.kvbm.manager import KvbmConfig as RefConfig
from dynamo_tpu.kvbm.manager import KvbmConnector as RefConnector
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.kvbm.manager import KvBlockManager, KvbmConfig, KvbmConnector
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import numpy_params

LIMIT = 120  # seconds a test may take
ENGINE_KW = dict(
    model="tiny", max_num_seqs=4, page_size=8, num_pages=24, max_model_len=160,
    prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4,
    kvbm_host_blocks=30, kvbm_disk_blocks=64,
)
COMPARED = ("kvbm_g1_hit_blocks", "kvbm_onboarded_blocks", "kvbm_offloaded_blocks",
            "kvbm_host_hits", "kvbm_disk_hits", "kvbm_onboard_count",
            "kvbm_onboard_src_local_blocks")


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {LIMIT} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def waves():
    """Waves A, B and C (3 prompts of 5 pages each; the 24-page pool keeps
    about the last four), then B's first prompt and wave A again, each
    extended by a turn of 12 tokens: B0 is still in the 30-block host tier,
    A only on disk."""
    rng = np.random.RandomState(21)
    prompt = lambda n: rng.randint(3, 500, size=n).tolist()  # noqa: E731
    a = [prompt(40) for _ in range(3)]
    b = [prompt(40) for _ in range(3)]
    c = [prompt(40) for _ in range(3)]
    return a + b + c + [p + prompt(12) for p in [b[0]] + a]


async def serve(engine, request_cls, context_cls, prompts, max_tokens=6):
    """Each prompt alone, the offload pipeline drained after each: the
    token streams and the engine's stats."""
    out = []
    for i, ids in enumerate(prompts):
        req = request_cls(token_ids=ids, request_id=f"q{i}",
                          stop_conditions={"max_tokens": max_tokens, "ignore_eos": True})
        toks = []
        async for item in engine.generate(req.to_dict(), context_cls()):
            assert item.get("event") != "error", item
            toks.extend((item.get("data") or {}).get("token_ids", []))
        out.append(toks)
        if engine.kvbm is not None:
            engine.kvbm.flush_step()
            for _ in range(500):
                if engine.kvbm.pending_offloads() == 0:
                    break
                await asyncio.sleep(0.01)
            assert engine.kvbm.pending_offloads() == 0
    stats = engine.stats()
    await engine.close()
    return out, stats


def torch_engine(weights, tmp_path, **kw):
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    return TorchEngine(EngineConfig(**{**ENGINE_KW, "kvbm_disk_path": str(tmp_path / "g3t"),
                                       **kw}),
                       model_config=cfg, params=params_from_jax(weights, device="cpu"),
                       device="cpu")


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


@pytest.fixture(scope="module")
def reference(weights, tmp_path_factory):
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)
    path = str(tmp_path_factory.mktemp("g3j"))
    engine = JaxEngine(JaxEngineConfig(**{**ENGINE_KW, "kvbm_disk_path": path}),
                       model_config=cfg, params=params)
    return asyncio.run(serve(engine, JaxRequest, JaxContext, waves()))


def test_streams_and_tier_counters_equal_jax_engine(weights, reference, tmp_path):
    got, stats = asyncio.run(serve(torch_engine(weights, tmp_path), PreprocessedRequest,
                                   Context, waves()))
    want, ref_stats = reference
    assert got == want
    for key in COMPARED:
        assert stats[key] == ref_stats[key], (key, stats[key], ref_stats[key])
    # the trace exercised what it is meant to: onboards from both tiers
    assert stats["kvbm_host_hits"] > 0 and stats["kvbm_disk_hits"] > 0
    assert stats["kvbm_onboarded_blocks"] >= 20
    assert stats["kv_onboard_fallbacks"] == 0


def test_kvbm_stats_keys_equal_reference(weights, reference, tmp_path):
    _, stats = asyncio.run(serve(torch_engine(weights, tmp_path), PreprocessedRequest,
                                 Context, waves()))
    _, ref_stats = reference
    ours = {k for k in stats if k.startswith("kvbm_")}
    theirs = {k for k in ref_stats if k.startswith("kvbm_")}
    assert ours == theirs, (ours ^ theirs)


def test_kvbm_on_and_off_give_the_same_tokens(weights, reference, tmp_path):
    got, stats = asyncio.run(serve(
        torch_engine(weights, tmp_path, kvbm_host_blocks=0, kvbm_disk_blocks=0),
        PreprocessedRequest, Context, waves()))
    assert got == reference[0]
    assert not any(k.startswith("kvbm_") for k in stats)


@pytest.mark.parametrize("cause", ["evicted", "fault"])
def test_onboard_miss_falls_back_to_prefill(weights, reference, tmp_path, monkeypatch, cause):
    engine = torch_engine(weights, tmp_path)
    if cause == "evicted":
        real = engine.kvbm.manager.load_blocks
        calls = []

        def vanish_once(hashes):
            calls.append(len(hashes))
            if len(calls) == 1:
                raise KeyError("KVBM block vanished between probe and load")
            return real(hashes)

        monkeypatch.setattr(engine.kvbm.manager, "load_blocks", vanish_once)
    else:
        faults.configure("kvbm.onboard:error,times=1")
    try:
        got, stats = asyncio.run(serve(engine, PreprocessedRequest, Context, waves()))
    finally:
        faults.reset()
    assert got == reference[0]
    assert stats["kv_onboard_fallbacks"] == 1
    assert stats["kvbm_onboard_count"] == reference[1]["kvbm_onboard_count"] - 1


# ---------------------------------------------------------------------- #
# the onboard budget, against the reference's on the same inputs
# ---------------------------------------------------------------------- #


class _FakeDist:
    def __init__(self, owned, ms_per_block):
        self.owned, self.ms = set(owned), ms_per_block

    def extend_prefix(self, hashes, hint_instance=None, hint_blocks=0):
        out = []
        for i, h in enumerate(hashes):
            if h not in self.owned and i >= hint_blocks:
                break
            out.append(h)
        return out

    def estimate_pull_ms(self, hashes, hint_instance=None):
        if self.ms is None or not all(h in self.owned for h in hashes):
            return None
        return self.ms * len(hashes)


BUDGET_CASES = {
    # name: (local hashes, local ms/block, peer hashes, peer ms/block,
    #        onboard hashes, headroom ms, recompute ms/block, peer_pull)
    "cold_never_defers": ([1, 2], None, [], None, [1, 2], 10.0, 5.0, True),
    "fifo_counts_sources": ([1, 2], 100.0, [3], 100.0, [1, 2, 3], None, 1.0, True),
    "slow_peer_trims_local": ([1, 2], 1.0, [3, 4], 500.0, [1, 2, 3, 4], 50.0, 10.0, True),
    "fast_peer_keeps_full": ([1, 2], 1.0, [3, 4], 2.0, [1, 2, 3, 4], 50.0, 10.0, True),
    "slow_all_recomputes": ([1, 2], 400.0, [3], 500.0, [1, 2, 3], 50.0, 2.0, True),
    "slow_disk_recomputes": ([1, 2, 3], 40.0, [], None, [1, 2, 3], 30.0, 5.0, True),
    "no_recompute_estimate": ([1, 2], 400.0, [], None, [1, 2], 50.0, None, True),
    "peer_off_is_unknown": ([1], 1.0, [2], 1.0, [1, 2], 50.0, 10.0, False),
}


@pytest.mark.parametrize("case", sorted(BUDGET_CASES))
def test_onboard_budget_decides_as_the_reference(case):
    local, local_ms, peer, peer_ms, hashes, headroom, recompute, peer_pull = BUDGET_CASES[case]
    shape = (2, 8, 2, 4)
    results = []
    for mgr_cls, cfg_cls, conn_cls, zeros in (
            (RefManager, RefConfig, RefConnector, lambda: np.zeros(shape, np.float32)),
            (KvBlockManager, KvbmConfig, KvbmConnector, lambda: torch.zeros(shape))):
        mgr = mgr_cls(cfg_cls(host_blocks=8), shape, np.float32 if mgr_cls is RefManager
                      else torch.float32)
        conn = conn_cls(None, mgr)
        for h in local:
            mgr.store(h, zeros(), zeros())
        mgr._load_ms["host"] = local_ms
        conn.peer_pull = peer_pull
        if peer:
            conn.distributed = _FakeDist(peer, peer_ms)
        kept, decision = conn.budget_onboard(list(hashes), headroom, recompute)
        results.append((kept, decision, conn.onboard_src_local_blocks,
                        conn.onboard_src_peer_blocks, conn.onboard_src_recompute_blocks,
                        conn.onboard_recompute_fallbacks))
    assert results[0] == results[1]
    if case.endswith("recomputes"):
        assert results[1][1] == "recompute" and results[1][0] == []


# ---------------------------------------------------------------------- #
# the offload pipeline (a fake engine)
# ---------------------------------------------------------------------- #


class _FakeEngine:
    """The engine surface KvbmConnector uses: the offload gather, the
    serial device executor and _timed."""

    def __init__(self, n_pages=64):
        gen = torch.Generator().manual_seed(3)
        self.kv_k = torch.randn(2, n_pages, 4, 2, 4, generator=gen)
        self.kv_v = torch.randn(2, n_pages, 4, 2, 4, generator=gen)
        self._device_exec = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self.dev_calls = 0

    def _dev_offload_gather(self, pages):
        self.dev_calls += 1
        ids = torch.from_numpy(np.asarray(pages, np.int64))
        return self.kv_k[:, ids], self.kv_v[:, ids], None

    def _timed(self, fn, tag, shape=None):
        return fn


def _connector(monkeypatch, host_blocks=16, queue=None):
    if queue is not None:
        monkeypatch.setenv("DYN_KVBM_OFFLOAD_QUEUE", str(queue))
    eng = _FakeEngine()
    return eng, KvbmConnector(eng, KvBlockManager(KvbmConfig(host_blocks=host_blocks),
                                                  (2, 4, 2, 4), torch.float32))


def test_pipeline_coalesces_stages_into_one_gather(monkeypatch):
    eng, conn = _connector(monkeypatch)
    conn.offload_commit([101, 102], [3, 4])
    conn.offload_commit([103], [5], parent=102)
    assert eng.dev_calls == 0  # nothing reaches the device before the flush
    conn.flush_step().result(timeout=10)
    assert conn.drain(5.0)
    assert eng.dev_calls == 1 and conn.offload_gathers == 1 and conn.offload_commit_calls == 2
    assert conn.manager.has(101) and conn.manager.has(103)
    k, _ = conn.manager.load_blocks([102])
    assert torch.equal(k[0], eng.kv_k[:, 4])
    assert conn.manager.host._parent.get(102) == 101
    assert conn.manager.host._parent.get(103) == 102
    conn.shutdown()


def test_pipeline_backpressure_drops_oldest(monkeypatch):
    eng, conn = _connector(monkeypatch, queue=1)
    faults.configure("kvbm.offload:delay,times=50")
    try:
        for i in range(5):
            conn.offload_commit([500 + i], [2 + i])
            conn.flush_step()
        assert conn.drain(10.0)
    finally:
        faults.reset()
    stats = conn.stats()
    assert stats["kvbm_offload_batches_dropped"] >= 1
    assert stats["kvbm_offload_blocks_dropped"] >= 1
    assert conn.pending_offloads() == 0
    with conn._offload_cv:
        assert not conn._inflight_hashes
    # dropped + stored partition the five staged blocks
    assert len(conn.manager.host) + stats["kvbm_offload_blocks_dropped"] == 5
    conn.shutdown()


def test_inline_arm_stores_each_commit_on_the_device_executor(monkeypatch):
    """DYN_KVBM_PIPELINE=0 (the reference's inline arm): one gather and a
    synchronous store per commit call, no flush needed."""
    monkeypatch.setenv("DYN_KVBM_PIPELINE", "0")
    eng, conn = _connector(monkeypatch)
    conn.offload_commit([201, 202], [7, 8])
    conn.offload_commit([203], [9], parent=202)
    assert conn.flush_step() is None and conn.drain(5.0)
    assert eng.dev_calls == 2 and conn.offload_gathers == 2
    k, v = conn.manager.load_blocks([201, 203])
    assert torch.equal(k[1], eng.kv_k[:, 9]) and torch.equal(v[0], eng.kv_v[:, 7])
    assert conn.manager.host._parent.get(203) == 202
    conn.shutdown()


def test_offload_gather_is_ordered_before_a_rewrite_of_its_page(weights, tmp_path):
    """A block is offloaded, its page freed and rewritten at once: the
    gather is on the device executor before the rewrite, so the tier holds
    the KV from before the rewrite."""
    engine = torch_engine(weights, tmp_path, kvbm_disk_blocks=0)
    c = engine.model_config
    shape = (c.num_layers, 1, engine.config.page_size, c.num_kv_heads, c.head_dim)
    page = np.array([3], np.int32)
    before = torch.randn(shape)
    engine._dev_inject(page, before, before * 2)
    engine.kvbm.offload_commit([777], [3])
    fut = engine.kvbm.flush_step()
    # the rewrite is queued right behind the gather, as the next dispatch
    # that reuses the page would be
    engine._device_exec.submit(engine._dev_inject, page, torch.zeros(shape), torch.zeros(shape))
    fut.result(timeout=10)
    assert engine.kvbm.drain(5.0)
    k, v = engine.kvbm.manager.load_blocks([777])
    assert torch.equal(k[0], before[:, 0]) and torch.equal(v[0], before[:, 0] * 2)
    assert torch.equal(engine.kv_k[:, 3], torch.zeros(shape)[:, 0])
    asyncio.run(engine.close())


def test_engine_close_drains_and_persists_the_disk_tier(weights, tmp_path):
    engine = torch_engine(weights, tmp_path, kvbm_host_blocks=0)

    async def main():
        req = PreprocessedRequest(token_ids=list(range(3, 43)),
                                  stop_conditions={"max_tokens": 2, "ignore_eos": True})
        async for _ in engine.generate(req.to_dict(), Context()):
            pass
        t0 = time.monotonic()
        await engine.close()
        return time.monotonic() - t0

    assert asyncio.run(main()) < 10
    # a new engine on the same path opens the pool warm
    again = torch_engine(weights, tmp_path, kvbm_host_blocks=0)
    assert len(again.kvbm.manager.disk) == 5
    asyncio.run(again.close())
