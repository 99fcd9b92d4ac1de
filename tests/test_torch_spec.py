"""The port's speculative decoding against the JAX reference, on the CPU.

Function level, bit for bit: `hist_write`, `ngram_draft` and `verify_accept`
(same threefry key) against `dynamo_tpu.engine.spec`, and `split` /
`uniform` against `jax.random`; `verify_accept`'s emitted tokens follow the
target distribution (chi-square). Model level: `prefill_forward_batched`
with `all_logits=True` against the JAX forward. Engine level (tiny Llama,
f32, weights from a numpy seed): greedy streams of the spec engine, on the
split path (spec blocks) and on the fused path (verify rows on the ragged
kernel), over repetitive and random prompts and 3 concurrent streams, with
an unquantized and an int8 pool, are token-identical to the JAX PLAIN
engine, and the acceptance counters equal the JAX spec engine's on the
same run; with an int4 pool (where the reference's spec streams part from
its plain ones) they equal the JAX spec engine's. Seeded sampled verify
rows on the fused path are the plain seeded draws; sampled split-spec
streams finish with exact counts.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.engine import sampling as jsamp, spec as jspec
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import (
    EngineConfig,
    TorchEngine,
    UnsupportedRequestError,
)
from dynamo_tpu_torch.engine import sampling as tsamp, spec as tspec
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context

from .test_torch_engine import numpy_params

ENGINE_KW = dict(
    model="tiny", max_num_seqs=4, page_size=8, num_pages=96, max_model_len=256,
    prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4,
)
SPEC_KW = dict(spec_mode="ngram", spec_rounds=2, spec_draft_len=3, spec_ngram=2,
               spec_hist=64)


# ---------------------------------------------------------------------- #
# function level
# ---------------------------------------------------------------------- #


def _ring(B, H, seed, vocab=6):
    return np.random.RandomState(seed).randint(0, vocab, size=(B, H)).astype(np.int32)


def test_split_and_uniform_bit_equal_to_jax():
    for key in [(0, 0), (0, 7), (123, 456), (2**32 - 1, 2**31)]:
        jk = jnp.asarray(key, jnp.uint32)
        for n in (2, 3, 5):
            want = [tuple(int(w) for w in r) for r in np.asarray(jax.random.split(jk, n))]
            assert tsamp.split(key, n) == want
        for shape, lo, hi in [((3, 4), 0.0, 1.0), ((2, 5, 64), 1e-20, 1.0), ((7,), 0.25, 0.75)]:
            want = np.asarray(jax.random.uniform(jk, shape, minval=lo, maxval=hi))
            got = tsamp.uniform(key, shape, lo, hi).numpy()
            np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("case", ["wrap", "no_match", "n_gt_history", "mixed"])
def test_hist_write_and_ngram_draft_bit_equal(case):
    B, H = 4, 16
    hist = _ring(B, H, 0)
    if case == "wrap":  # positions past the ring size: slots wrap
        pos, n, d = np.array([17, 40, 31, 100]), 2, 3
    elif case == "no_match":  # all-distinct history: no n-gram repeats
        hist = np.arange(B * H, dtype=np.int32).reshape(B, H) + 100
        pos, n, d = np.array([5, 9, 15, 3]), 2, 4
    elif case == "n_gt_history":  # fewer tokens than the n-gram
        pos, n, d = np.array([0, 1, 2, 1]), 4, 3
    else:
        pos, n, d = np.array([3, 15, 40, 2]), 3, 2
    pos = pos.astype(np.int32)
    toks = np.random.RandomState(1).randint(0, 6, size=B).astype(np.int32)
    want_h = np.asarray(jspec.hist_write(jnp.asarray(hist), jnp.asarray(pos), jnp.asarray(toks)))
    got_h = tspec.hist_write(torch.from_numpy(hist), torch.from_numpy(pos),
                             torch.from_numpy(toks)).numpy()
    np.testing.assert_array_equal(got_h, want_h)
    want = np.asarray(jspec.ngram_draft(jnp.asarray(want_h), jnp.asarray(toks),
                                        jnp.asarray(pos), n, d))
    got = tspec.ngram_draft(torch.from_numpy(got_h), torch.from_numpy(toks),
                            torch.from_numpy(pos), n, d).numpy()
    np.testing.assert_array_equal(got, want)


def _samp_pair(temp, top_k, top_p):
    temp = np.asarray(temp, np.float32)
    top_k = np.asarray(top_k, np.int32)
    top_p = np.asarray(top_p, np.float32)
    j = jsamp.SamplingParams(temperature=jnp.asarray(temp), top_k=jnp.asarray(top_k),
                             top_p=jnp.asarray(top_p))
    t = tsamp.SamplingParams(temperature=torch.from_numpy(temp),
                             top_k=torch.from_numpy(top_k), top_p=torch.from_numpy(top_p))
    return j, t


@pytest.mark.parametrize("lanes", ["greedy", "mixed"])
@pytest.mark.parametrize("V", [600, 5000])
def test_verify_accept_bit_equal(lanes, V):
    """Greedy, temperature, top-k and top-p lanes; several round keys."""
    B, d = 5, 4
    rng = np.random.RandomState(V)
    logits = (rng.randn(B, d + 1, V) * 2).astype(np.float32)
    draft = np.argmax(logits[:, :d], -1).astype(np.int32)  # mostly accepted
    draft[1, 2] = 7
    draft[3, 0] = 1
    if lanes == "greedy":
        j, t = _samp_pair([0] * B, [0] * B, [1] * B)
    else:
        j, t = _samp_pair([0, 0.7, 1.0, 1.3, 0.9], [0, 0, 20, 0, 5], [1, 1, 1, 0.8, 0.9])
    for seed in range(6):
        key = (seed, 1000 + seed)
        o1, n1, k1 = jspec.verify_accept(jnp.asarray(logits), jnp.asarray(draft), j,
                                         jnp.asarray(key, jnp.uint32))
        o2, n2, k2 = tspec.verify_accept(torch.from_numpy(logits), torch.from_numpy(draft), t, key)
        n1, o1 = np.asarray(n1), np.asarray(o1)
        np.testing.assert_array_equal(n2.numpy(), n1)
        for b in range(B):  # the emitted tokens; past n_emit is scratch
            np.testing.assert_array_equal(o2.numpy()[b, : n1[b]], o1[b, : n1[b]])
        assert k2 == tuple(int(w) for w in np.asarray(k1))


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, 0, 1.0), (0.8, 6, 1.0), (1.2, 0, 0.85)])
def test_verify_accept_keeps_the_target_distribution(temp, top_k, top_p):
    """Over 20,000 lanes drafting the same token, the first emitted token
    (the accepted draft or the replacement) is distributed as the plain
    sampler's filtered target (chi-square, 1e-3 significance)."""
    from scipy.stats import chisquare

    N, V = 20000, 12
    row = np.random.RandomState(2).randn(V).astype(np.float32) * 1.5
    logits = torch.from_numpy(np.broadcast_to(row, (N, 2, V)).copy())
    draft = torch.full((N, 1), int(np.argsort(row)[-2]), dtype=torch.int64)  # 2nd best
    samp = tsamp.SamplingParams(
        temperature=torch.full((N,), temp), top_k=torch.full((N,), top_k, dtype=torch.int32),
        top_p=torch.full((N,), top_p))
    out, _, _ = tspec.verify_accept(logits, draft, samp, (0, 99))
    counts = np.bincount(out[:, 0].numpy(), minlength=V)
    # the target: the sampler's own candidate filtering of this row
    _, probs = tspec._candidate_probs(logits[:1, :1], samp._replace(
        temperature=samp.temperature[:1], top_k=samp.top_k[:1], top_p=samp.top_p[:1]))
    cand = tsamp._candidates(logits[0, :1])[1][0].numpy()
    p = np.zeros(V)
    p[cand] = probs[0, 0].double().numpy()
    keep = p > 0
    assert counts[~keep].sum() == 0  # never outside the filtered set
    _, pval = chisquare(counts[keep], p[keep] / p[keep].sum() * N)
    assert pval > 1e-3, (pval, counts, p)


def test_prefill_all_logits_matches_jax_forward():
    c_j = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    c_t = tllama.LlamaConfig.tiny(dtype=torch.float32)
    w = numpy_params()
    jparams = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), w,
                           is_leaf=lambda a: a is None)
    B, T, ps, P = 3, 5, 8, 4
    rng = np.random.RandomState(4)
    toks = rng.randint(3, 500, size=(B, T)).astype(np.int32)
    ctx = np.array([0, 7, 13], np.int32)
    pos = (ctx[:, None] + np.arange(T)[None, :]).astype(np.int32)
    tables = np.array([[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]], np.int32)
    shape = (c_j.num_layers, 16, ps, c_j.num_kv_heads, c_j.head_dim)
    kv0 = (rng.randn(*shape) * 0.5).astype(np.float32)
    want, _, _ = jllama.prefill_forward_batched(
        jparams, c_j, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(kv0),
        jnp.asarray(kv0 * 0.5), jnp.asarray(tables), jnp.asarray(ctx),
        jnp.full((B,), T - 1, jnp.int32), all_logits=True)
    got, _, _ = tllama.prefill_forward_batched(
        params_from_jax(w, device="cpu"), c_t, torch.from_numpy(toks), torch.from_numpy(pos),
        torch.from_numpy(kv0.copy()), torch.from_numpy(kv0 * 0.5), torch.from_numpy(tables),
        torch.from_numpy(ctx), torch.full((B,), T - 1, dtype=torch.int32), all_logits=True)
    assert got.shape == (B, T, c_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=2e-3)


# ---------------------------------------------------------------------- #
# engine level
# ---------------------------------------------------------------------- #


def _prompts():
    """A repetitive prompt, a random one and one with a short period."""
    rng = np.random.RandomState(7)
    base = rng.randint(5, 500, size=8).tolist()
    return [(base * 6)[:44], rng.randint(5, 500, size=30).tolist(),
            (rng.randint(5, 500, size=5).tolist() * 9)[:40]]


async def _drive(engine, request_cls, context_cls, prompts, n=24, sampling=None):
    """The prompts staggered by events (request i+1 arrives once request i
    has its first token, so prefills overlap live decode lanes); returns
    the token stream of each and the engine's stats."""
    results = {}

    async def one(i, prompt, started):
        toks = []
        req = request_cls(token_ids=list(prompt), request_id=f"r{i}",
                          stop_conditions={"max_tokens": n, "ignore_eos": True},
                          sampling_options=dict(sampling or {"temperature": 0.0}))
        async for item in engine.generate(req.to_dict(), context_cls()):
            assert item.get("event") != "error", item
            data = item.get("data") or {}
            toks.extend(data.get("token_ids") or [])
            started.set()
        started.set()
        results[i] = toks

    tasks = []
    for i, p in enumerate(prompts):
        started = asyncio.Event()
        tasks.append(asyncio.create_task(one(i, p, started)))
        await started.wait()
    await asyncio.gather(*tasks)
    stats = engine.stats()
    await engine.close()
    return [results[i] for i in range(len(prompts))], stats


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


def _jax_engine(weights, **kw):
    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)
    return JaxEngine(JaxEngineConfig(**{**ENGINE_KW, **kw}),
                     model_config=jllama.LlamaConfig.tiny(dtype=jnp.float32), params=params)


def _torch_engine(weights, **kw):
    return TorchEngine(EngineConfig(**{**ENGINE_KW, **kw}),
                       model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                       params=params_from_jax(weights, device="cpu"), device="cpu")


_JAX_RUNS = {}


def _jax_run(weights, **kw):
    """One JAX engine run per configuration, shared by the tests."""
    key = tuple(sorted(kw.items()))
    if key not in _JAX_RUNS:
        _JAX_RUNS[key] = asyncio.run(
            _drive(_jax_engine(weights, **kw), JaxRequest, JaxContext, _prompts()))
    return _JAX_RUNS[key]


SPEC_COUNTERS = ("spec_num_drafts", "spec_num_draft_tokens", "spec_num_accepted_tokens")


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mixed", [False, True], ids=["split", "fused"])
def test_greedy_spec_streams_equal_the_jax_plain_engine(weights, kv_quant, mixed):
    want, _ = _jax_run(weights, kv_quant=kv_quant, mixed_dispatch=mixed)
    got, stats = asyncio.run(_drive(
        _torch_engine(weights, kv_quant=kv_quant, mixed_dispatch=mixed, **SPEC_KW),
        PreprocessedRequest, Context, _prompts()))
    assert got == want
    assert all(len(t) == 24 for t in got)
    assert stats["spec_num_drafts"] > 0 and stats["spec_num_accepted_tokens"] > 0
    if mixed:
        assert stats["mixed_rows_spec"] > 0 and stats["mixed_steps"] > 0
    else:
        assert stats["mixed_rows_spec"] == 0 and stats["mixed_steps"] == 0
    # the same run on the reference's spec engine: same acceptance
    _, ref = _jax_run(weights, kv_quant=kv_quant, mixed_dispatch=mixed, **SPEC_KW)
    assert {k: stats[k] for k in SPEC_COUNTERS} == {k: ref[k] for k in SPEC_COUNTERS}
    assert stats["mixed_rows_spec"] == ref["mixed_rows_spec"]


@pytest.mark.parametrize("mixed", [False, True], ids=["split", "fused"])
def test_greedy_int4_spec_streams_equal_the_jax_spec_engine(weights, mixed):
    """In an int4 pool a rejected draft's KV write can raise its page's
    scale and requantize the committed rows, so the reference's own spec
    streams part from its plain ones: the port's equal the reference's spec
    engine token for token, with the same acceptance counters."""
    kw = dict(kv_quant="int4", mixed_dispatch=mixed, **SPEC_KW)
    want, ref = _jax_run(weights, **kw)
    got, stats = asyncio.run(_drive(_torch_engine(weights, **kw), PreprocessedRequest,
                                    Context, _prompts()))
    assert got == want
    assert all(len(t) == 24 for t in got)
    assert stats["spec_num_drafts"] > 0 and stats["spec_num_accepted_tokens"] > 0
    assert {k: stats[k] for k in SPEC_COUNTERS} == {k: ref[k] for k in SPEC_COUNTERS}
    assert stats["mixed_rows_spec"] == ref["mixed_rows_spec"]
    assert (stats["mixed_rows_spec"] > 0) == mixed


def test_seeded_fused_verify_rows_equal_the_plain_seeded_stream(weights):
    """A short seeded sampled stream decodes entirely beside a long
    chunked prefill, so every token it emits comes from fused verify rows:
    each row is the plain seeded draw at its position, so the stream equals
    the JAX plain engine's."""
    rng = np.random.RandomState(9)
    base = rng.randint(5, 500, size=6).tolist()
    prompts = [(base * 4)[:22], rng.randint(5, 500, size=200).tolist()]
    samp = {"temperature": 0.9, "top_k": 40, "seed": 1234}

    async def both(engine, req_cls, ctx_cls):
        async def one(i, p, n):
            toks = []
            req = req_cls(token_ids=p, request_id=f"s{i}",
                          stop_conditions={"max_tokens": n, "ignore_eos": True},
                          sampling_options=samp)
            async for item in engine.generate(req.to_dict(), ctx_cls()):
                toks.extend((item.get("data") or {}).get("token_ids") or [])
            return toks
        # the long prompt's only token is its prefill's first
        out = await asyncio.gather(one(0, prompts[0], 10), one(1, prompts[1], 1))
        stats = engine.stats()
        await engine.close()
        return out, stats

    kw = dict(max_prefill_chunk=16, prefill_buckets=(16,), prefill_batch_tokens=32)
    want, _ = asyncio.run(both(_jax_engine(weights, **kw), JaxRequest, JaxContext))
    got, stats = asyncio.run(both(_torch_engine(weights, mixed_dispatch=True, **kw, **SPEC_KW),
                                  PreprocessedRequest, Context))
    assert got == want
    assert len(got[0]) == 10
    assert stats["mixed_rows_spec"] >= 10  # the short stream's rows were fused
    assert "block" not in stats["dev_time"]  # no split spec block ran


def test_sampled_split_spec_streams_finish_with_exact_counts(weights):
    got, stats = asyncio.run(_drive(
        _torch_engine(weights, mixed_dispatch=False, **SPEC_KW), PreprocessedRequest, Context,
        _prompts(), n=20, sampling={"temperature": 1.0, "top_p": 0.9}))
    assert [len(t) for t in got] == [20, 20, 20]
    assert stats["spec_num_drafts"] > 0


@pytest.mark.parametrize("sampling,match", [
    ({"presence_penalty": 0.5}, "penalties"),
    ({"repetition_penalty": 1.2}, "penalties"),
    ({"logprobs": True}, "logprobs"),
])
def test_penalties_and_logprobs_refused_under_spec(sampling, match):
    engine = _torch_engine(numpy_params(), **SPEC_KW)

    async def run():
        req = PreprocessedRequest(token_ids=[5, 6, 7], sampling_options=sampling).to_dict()
        try:
            with pytest.raises(UnsupportedRequestError, match=match):
                async for _ in engine.generate(req, Context()):
                    pass
        finally:
            await engine.close()

    asyncio.run(run())


def test_block_advance_covers_speculative_writes():
    cfg = EngineConfig(**ENGINE_KW, **SPEC_KW)
    assert cfg.block_advance == 2 * (3 + 1)
    assert EngineConfig(**ENGINE_KW).block_advance == 4
    assert cfg.unsupported_fields() == []
    assert EngineConfig(**ENGINE_KW, spec_mode="eagle").unsupported_fields() == ["spec_mode"]
