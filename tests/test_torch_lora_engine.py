"""The port's multi-LoRA serving against the JAX engine, on the CPU.

One staggered trace of six requests (base lanes, two adapters of ranks 4
and 8, the same prompt under both adapters, a seeded sampled stream, a
chunked prompt) goes through `JaxEngine` and `TorchEngine` on the same
numpy weights (std 0.15, as in test_torch_engine.py) and adapters carried
across with `adapter_from_jax`. The port's streams equal the reference's
token for token on the fused (mixed) path, the split path, a "local" pool,
an int8 pool and a fused speculative engine (whose LoRA verify rows give
the plain streams); the stored block hashes equal the reference's salted
ones. Port-side: base lanes equal a plain engine's, LoRA streams equal
their solo runs also beside a guided lane, every refusal is the
reference's error item (or, on a split-only spec engine, a raise naming
`lora_name`), no path that ends a stream leaks an adapter pin, and the
disagg handler probes the salted chain and hands a LoRA request through a
prefill/decode pair.
"""

import asyncio
import signal
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.jax_worker.disagg_handler import maybe_remote_prefill as jax_handler
from dynamo_tpu.llm.protocols import Annotated as JaxAnnotated
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.llm.tokens import compute_seq_hashes, salt_hash
from dynamo_tpu.models import llama as jllama, lora as jlora, lora_pool as jpool
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, UnsupportedRequestError
from dynamo_tpu_torch.llm import kv_transfer as tkt
from dynamo_tpu_torch.llm.disagg import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import adapter_from_jax, params_from_jax
from dynamo_tpu_torch.runtime import faults
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.worker.disagg_handler import maybe_remote_prefill

from .test_torch_disagg import EngineClient, collect_handled
from .test_torch_engine import numpy_params

ENGINE_KW = dict(
    model="tiny", max_num_seqs=4, page_size=8, num_pages=96, max_model_len=128,
    prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4,
)
SPEC_KW = dict(spec_mode="ngram", spec_rounds=2, spec_draft_len=3, spec_ngram=2,
               spec_hist=64)
MAX_TOKENS = 12
TEST_LIMIT = 240


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {TEST_LIMIT} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(TEST_LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def trace():
    """(prompt, lora_name, sampling) of six requests; r2 and r3 share their
    prompt under two adapters."""
    rng = np.random.RandomState(21)
    prompt = lambda n: rng.randint(3, 500, size=n).tolist()  # noqa: E731
    shared = prompt(16) + prompt(14)
    return [
        (prompt(10), "ad1", {}),
        (prompt(24), None, {}),
        (shared, "ad2", {}),
        (list(shared), "ad1", {}),
        (prompt(7), "ad2", {"temperature": 0.8, "seed": 7}),
        (prompt(40), None, {}),
    ]


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


@pytest.fixture(scope="module")
def adapters():
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    return [
        jlora.init_adapter(cfg, "ad1", jax.random.PRNGKey(101), rank=4, scale=2.0),
        jlora.init_adapter(cfg, "ad2", jax.random.PRNGKey(202), rank=8,
                           targets=("wq", "wv", "wo")),
    ]


def jax_engine(weights, adapters, **kw):
    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)
    events = []
    eng = JaxEngine(JaxEngineConfig(**{**ENGINE_KW, **kw}),
                    model_config=jllama.LlamaConfig.tiny(dtype=jnp.float32), params=params,
                    event_sink=events.append)
    eng.register_adapters(adapters)
    return eng, events


def torch_engine(weights, adapters=None, **kw):
    events = []
    eng = TorchEngine(EngineConfig(**{**ENGINE_KW, **kw}),
                      model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                      params=params_from_jax(weights, device="cpu"), device="cpu",
                      event_sink=events.append)
    if adapters:
        eng.register_adapters([adapter_from_jax(a, device="cpu") for a in adapters])
    return eng, events


async def one(engine, request_cls, context_cls, prompt, lora_name, sampling, rid,
              started=None, n=MAX_TOKENS, **extra):
    """(tokens, error items) of one request."""
    toks, errors = [], []
    req = request_cls(token_ids=list(prompt), request_id=rid, lora_name=lora_name,
                      stop_conditions={"max_tokens": n, "ignore_eos": True},
                      sampling_options=dict(sampling), **extra)
    async for item in engine.generate(req.to_dict(), context_cls()):
        if item.get("event") == "error":
            errors.append(item)
        toks.extend((item.get("data") or {}).get("token_ids") or [])
        if started is not None:
            started.set()
    if started is not None:
        started.set()
    return toks, errors


async def drive(engine, request_cls, context_cls, specs=None, lora=True):
    """The trace staggered by events (request i+1 arrives when request i has
    its first token); returns the streams and the engine's stats."""
    specs = specs or trace()
    tasks = []
    for i, (prompt, name, samp) in enumerate(specs):
        started = asyncio.Event()
        tasks.append(asyncio.create_task(one(engine, request_cls, context_cls, prompt,
                                             name if lora else None, samp, f"r{i}",
                                             started)))
        await started.wait()
    results = await asyncio.gather(*tasks)
    assert not any(err for _, err in results), results
    stats = engine.stats()
    await engine.close()
    return [t for t, _ in results], stats


_JAX_RUNS = {}


def jax_run(weights, adapters, **kw):
    """One reference run per configuration: (streams, stats, stored hashes)."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_RUNS:
        eng, events = jax_engine(weights, adapters, **kw)
        streams, stats = asyncio.run(drive(eng, JaxRequest, JaxContext))
        _JAX_RUNS[key] = streams, stats, stored(events)
    return _JAX_RUNS[key]


def stored(events):
    return {h for ev in events if ev.event_type == "stored" for h in ev.block_hashes}


@pytest.mark.parametrize("kw", [
    dict(), dict(mixed_dispatch=False), dict(decode_pool_mode="local"),
    dict(kv_quant="int8"), SPEC_KW,
], ids=["mixed", "split", "local", "int8", "fused_spec"])
def test_lora_streams_equal_the_jax_engine(weights, adapters, kw):
    # quantized streams depend on the dispatch shapes: the int8 run is held
    # to the reference's int8 run; a greedy spec stream is the plain one
    want, ref_stats, ref_hashes = jax_run(weights, adapters,
                                          **({"kv_quant": "int8"} if "kv_quant" in kw else {}))
    eng, events = torch_engine(weights, adapters, **kw)
    got, stats = asyncio.run(drive(eng, PreprocessedRequest, Context))
    assert got == want
    assert all(len(t) == MAX_TOKENS for t in got)
    assert stats["lora_requests"] == ref_stats["lora_requests"] == 4
    assert stats["lora_pool_hits"] == ref_stats["lora_pool_hits"]
    assert stats["dev_time"]["block_lora"]["count"] > 0
    if kw.get("mixed_dispatch", True):
        assert stats["mixed_rows_lora"] > 0
    else:
        assert stats["mixed_rows_lora"] == 0 and stats["mixed_steps"] == 0
    if kw == SPEC_KW:
        assert stats["mixed_rows_spec"] > 0
    if not kw:
        assert stats["mixed_rows_lora"] == ref_stats["mixed_rows_lora"]
        # the prefix cache, the KV events and the router key on the same
        # adapter-salted chains as the reference's
        assert stored(events) == ref_hashes


def test_adapter_changes_output_and_base_lanes_equal_a_plain_engine(weights, adapters):
    want, _, _ = jax_run(weights, adapters)
    eng, _ = torch_engine(weights)  # no adapters registered
    base, _ = asyncio.run(drive(eng, PreprocessedRequest, Context, lora=False))
    specs = trace()
    for i, (_, name, _) in enumerate(specs):
        if name is None:
            assert want[i] == base[i]  # slot 0 adds an exact zero
        else:
            assert want[i] != base[i]  # the adapter changes the stream
    assert want[2] != want[3]  # one prompt, two adapters


def test_kv_hashes_are_disjoint_across_adapters(weights, adapters):
    _, _, ref_hashes = jax_run(weights, adapters)
    prompt = trace()[2][0]
    chains = {name: set(compute_seq_hashes(prompt, 8, salt_hash(name.encode()) if name else 0))
              for name in ("ad1", "ad2", None)}
    assert chains["ad1"] <= ref_hashes and chains["ad2"] <= ref_hashes
    assert chains["ad1"].isdisjoint(chains["ad2"]) and chains["ad1"].isdisjoint(chains[None])
    assert chains["ad2"].isdisjoint(chains[None])


def test_lora_streams_equal_their_solo_runs_beside_a_guided_lane(weights, adapters):
    want, _, _ = jax_run(weights, adapters)
    specs = trace()

    async def main():
        eng, _ = torch_engine(weights, adapters)
        solo = []
        for i, (prompt, name, samp) in enumerate(specs):
            toks, err = await one(eng, PreprocessedRequest, Context, prompt, name, samp, f"s{i}")
            solo.append(toks)
        prompt, name, samp = specs[0]
        both = await asyncio.gather(
            one(eng, PreprocessedRequest, Context, prompt, name, samp, "m0"),
            one(eng, PreprocessedRequest, Context, [8, 8, 8], None, {"temperature": 1.0,
                "seed": 3}, "mg", n=24, guided={"kind": "choice", "choices": ["yes", "no"]}),
        )
        stats = eng.stats()
        await eng.close()
        return solo, both, stats

    solo, (lora_run, guided_run), stats = asyncio.run(main())
    assert solo == want  # concurrent streams equal their solo runs
    assert lora_run == (want[0], [])
    assert stats["dev_time"]["block_guided"]["count"] > 0
    from dynamo_tpu_torch.llm.tokenizers import ByteTokenizer

    assert ByteTokenizer(512).decode(guided_run[0]) in ("yes", "no")


def test_a_cold_onboard_lands_on_the_device_thread(weights, adapters):
    """A cold adapter's rows are written on the device thread, ahead of its
    stream's first dispatch, and the event loop never waits for them: while
    that thread is held, the loop runs on and the rows wait; released, the
    stream equals the reference's."""
    want, _, _ = jax_run(weights, adapters)
    prompt, name, samp = trace()[2]  # ad2, cold: slot 1 holds ad1

    async def main():
        eng, _ = torch_engine(weights, adapters, lora_pool_slots=1)
        pool = eng._lora_pool
        eng._device_exec.submit(lambda: None).result()  # registration's rows landed
        gate = threading.Event()
        held = eng._device_exec.submit(gate.wait)
        try:
            task = asyncio.create_task(
                one(eng, PreprocessedRequest, Context, prompt, name, samp, "cold"))
            await asyncio.sleep(0.2)  # the loop is free while the thread is held
            waiting = pool.landing(), pool.stack["names"], pool.pinned()
        finally:
            gate.set()
        held.result()
        toks, err = await task
        stats = eng.stats()
        await eng.close()
        return waiting, toks, err, stats, pool

    (waiting, names, pins), toks, err, stats, pool = asyncio.run(main())
    assert (waiting, names, pins) == (True, {"ad2": 1}, 1)
    assert (toks, err) == (want[2], [])
    assert not pool.landing() and pool.pinned() == 0
    assert stats["dev_time"]["lora_onboard"]["count"] == 2  # registration, then ad2
    ad2 = adapter_from_jax(adapters[1], device="cpu")
    assert torch.equal(pool.stack["b"]["wo"][:, 1, :8], ad2.b["wo"])


# ---------------------------------------------------------------------- #
# refusals and pins
# ---------------------------------------------------------------------- #


def _ref_pool_message(adapters, script):
    """The reference pool's refusal after `script` (a list of names to
    acquire, ending with the refused one)."""
    pool = jpool.LoraPool(jllama.LlamaConfig.tiny(dtype=jnp.float32), adapters, slots=1)
    try:
        for name in script:
            pool.acquire(name)
    except jpool.LoraPoolError as e:
        return str(e)
    raise AssertionError("the reference pool did not refuse")


@pytest.mark.parametrize("case", ["unknown", "guided", "split_spec", "pinned_full",
                                  "onboard_fault"])
def test_refusals_are_the_references_and_leak_no_pin(weights, adapters, case):
    kw = dict(lora_pool_slots=1, **(dict(SPEC_KW, mixed_dispatch=False)
                                    if case == "split_spec" else {}))
    ref, _ = jax_engine(weights, adapters, **kw)
    prompt = trace()[0][0]

    async def main():
        eng, _ = torch_engine(weights, adapters, **kw)
        pool = eng._lora_pool
        name, extra, hold = "ad1", {}, None
        if case == "unknown":
            name = "nope"
        elif case == "guided":
            extra = dict(guided={"kind": "regex", "regex": "[ab]*"})
        elif case == "pinned_full":
            # ad1 holds the only slot for the life of a long stream
            started = asyncio.Event()
            hold = asyncio.create_task(one(eng, PreprocessedRequest, Context, prompt, "ad1",
                                           {}, "hold", started, n=60))
            await started.wait()
            name = "ad2"
        elif case == "onboard_fault":
            name = "ad2"  # not resident: slot 1 holds ad1
            faults.configure("lora.onboard:error,times=1")
        try:
            if case == "split_spec":
                with pytest.raises(UnsupportedRequestError, match="lora_name") as e:
                    await one(eng, PreprocessedRequest, Context, prompt, name, {}, "x")
                return str(e.value), pool.pinned(), eng.stats()
            toks, errors = await one(eng, PreprocessedRequest, Context, prompt, name, {}, "x",
                                     **extra)
            assert toks == [] and len(errors) == 1
            pinned = pool.pinned()
            if hold is not None:
                await hold
            return errors[0], pinned, eng.stats()
        finally:
            faults.reset()
            await eng.close()

    item, pinned, stats = asyncio.run(main())
    req = JaxRequest(token_ids=prompt, lora_name="nope" if case == "unknown" else "ad1",
                     **({"guided": {"kind": "regex", "regex": "[ab]*"}} if case == "guided" else {}))
    if case in ("unknown", "guided", "split_spec"):
        want = ref._check_lora(req)
    elif case == "pinned_full":
        want = _ref_pool_message(adapters, ["ad1", "ad2"])
    else:
        want = ("adapter 'ad2' onboard failed (injected); retry or route to a replica "
                "with the adapter resident")
    if case == "split_spec":
        assert want in item  # raised: the reference's text, naming the field
    else:
        assert item == JaxAnnotated.from_error(want).to_dict()
    assert pinned == (1 if case == "pinned_full" else 0)
    assert stats["num_running_reqs"] == 0
    assert stats["lora_pool_refusals"] == int(case in ("pinned_full", "onboard_fault"))


@pytest.mark.parametrize("path", ["finish", "cancel", "preempt", "fail_all", "sever_all",
                                  "abandon_pull"])
def test_every_stream_end_releases_its_pin(weights, adapters, path):
    """Finish, a consumer that leaves, a preemption (the pin survives the
    requeue) then the finish, the step failure's _fail_all, the morph's
    _sever_all and an abandoned disagg pull: the pool holds no pin after."""
    kw = dict(num_pages=12) if path == "preempt" else {}
    prompt = trace()[0][0]

    async def main():
        eng, _ = torch_engine(weights, adapters, **kw)
        pool = eng._lora_pool
        seen = []

        async def stream(rid, name, n=MAX_TOKENS, leave_after=None):
            req = PreprocessedRequest(token_ids=list(prompt), request_id=rid, lora_name=name,
                                      stop_conditions={"max_tokens": n, "ignore_eos": True})
            agen = eng.generate(req.to_dict(), Context())
            got = 0
            try:
                async for item in agen:
                    got += len((item.get("data") or {}).get("token_ids") or [])
                    seen.append(pool.pinned())
                    if leave_after is not None and got >= leave_after:
                        break
            except Exception:  # noqa: BLE001 — the sever's StreamSevered
                pass
            finally:
                await agen.aclose()
            return got

        if path == "finish":
            await asyncio.gather(stream("a", "ad1"), stream("b", "ad2"), stream("c", None))
        elif path == "cancel":
            await stream("a", "ad1", n=60, leave_after=2)
            for _ in range(50):  # the step loop finishes the slot
                await asyncio.sleep(0.01)
                if pool.pinned() == 0:
                    break
        elif path == "preempt":
            # 12 pages of 8 tokens: three 60-token streams cannot all fit
            await asyncio.gather(*[stream(f"p{i}", n, n=60)
                                   for i, n in enumerate(["ad1", "ad2", "ad1"])])
            assert eng.num_preemptions >= 1
        else:
            tasks = [asyncio.create_task(stream(r, "ad1", n=80)) for r in ("a", "b")]
            while pool.pinned() < 2:
                await asyncio.sleep(0.01)
            seen.append(pool.pinned())
            if path == "fail_all":
                eng._fail_all("injected step failure")
            elif path == "sever_all":
                eng._sever_all("morphing")
            else:
                # a decode-role slot waiting on a pull whose consumer left
                slot = eng._entry_slot(PreprocessedRequest(
                    token_ids=list(prompt), lora_name="ad2").to_dict(), Context())
                assert pool.pinned() == 3
                slot.done = True
                eng._abandon_pull(slot)
                eng._fail_all("done")
            await asyncio.gather(*tasks)
        pinned = pool.pinned()
        await eng.close()
        return pinned, seen

    pinned, seen = asyncio.run(main())
    assert pinned == 0
    assert max(seen, default=0) >= 1


# ---------------------------------------------------------------------- #
# disaggregation
# ---------------------------------------------------------------------- #


class _ProbeEngine:
    """Just enough of an engine for a handler's cached-prefix probe: records
    the hashes it was asked about and serves nothing."""

    def __init__(self):
        self.config = types.SimpleNamespace(page_size=8)
        self.kvbm = None
        self.scheduler = types.SimpleNamespace(policy="fifo")
        self.asked = []
        self.allocator = types.SimpleNamespace(
            cached_prefix=lambda hashes: self.asked.append(list(hashes)) or [])

    async def generate(self, request, context):
        return
        yield


@pytest.mark.parametrize("name", ["ad1", None])
def test_disagg_probe_hashes_equal_the_reference_handlers(name):
    prompt = trace()[2][0]
    req = {"token_ids": prompt, "lora_name": name} if name else {"token_ids": prompt}

    async def probe(handler, router_cls, cfg_cls, ctx_cls):
        eng = _ProbeEngine()
        router = router_cls(cfg_cls(remote_prefill_threshold_tokens=16))
        async for _ in handler(eng, None, router, dict(req), ctx_cls()):
            pass
        return eng.asked

    from dynamo_tpu.llm.disagg import DisaggConfig as JaxDisaggConfig
    from dynamo_tpu.llm.disagg import DisaggregatedRouter as JaxDisaggRouter

    ours = asyncio.run(probe(maybe_remote_prefill, DisaggregatedRouter, DisaggConfig, Context))
    theirs = asyncio.run(probe(jax_handler, JaxDisaggRouter, JaxDisaggConfig, JaxContext))
    assert ours == theirs
    assert ours[0] == compute_seq_hashes(prompt, 8, salt_hash(name.encode()) if name else 0)


def test_lora_request_through_a_prefill_decode_pair(weights, adapters):
    """The handler hands a LoRA request to a prefill engine (which has the
    adapter) and decodes the pulled KV: the stream equals the aggregated
    engine's, the pulled pages are committed under the salted chain, and
    neither engine keeps a pin."""
    prompt = trace()[0][0] * 4  # 40 tokens: past the 16-token threshold
    req = {"token_ids": prompt, "request_id": "d1", "lora_name": "ad1",
           "annotations": ["remote_prefill"],
           "stop_conditions": {"max_tokens": MAX_TOKENS, "ignore_eos": True}}

    async def main():
        agg, _ = torch_engine(weights, adapters)
        want, _ = await one(agg, PreprocessedRequest, Context, prompt, "ad1", {}, "agg")
        await agg.close()
        pre, _ = torch_engine(weights, adapters, role="prefill")
        dec, events = torch_engine(weights, adapters)
        plane = tkt.KvDataPlaneServer(host="127.0.0.1")
        await plane.start()
        pre.data_plane = plane
        try:
            got = await collect_handled(maybe_remote_prefill(
                dec, EngineClient(pre, Context),
                DisaggregatedRouter(DisaggConfig(remote_prefill_threshold_tokens=16)),
                dict(req), Context()))
            return want, got, dec.stats(), pre.stats(), stored(events), (
                pre._lora_pool.pinned(), dec._lora_pool.pinned())
        finally:
            for x in (pre, dec, plane):
                await x.close()

    want, (ids, remote), dstats, pstats, hashes, pins = asyncio.run(main())
    assert remote is True and ids == want
    assert dstats["kv_pulls_completed"] == 1 and dstats["lora_requests"] == 1
    assert pstats["lora_requests"] == 1
    salted = compute_seq_hashes(prompt, 8, salt_hash(b"ad1"))
    assert set(salted) <= hashes and not set(compute_seq_hashes(prompt, 8, 0)) & hashes
    assert pins == (0, 0)
