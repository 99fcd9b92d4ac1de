"""The PyTorch/CUDA port's engine against the JAX reference engine, on the CPU.

`TorchEngine(device="cpu")` and `JaxEngine` serve the same trace on the
same (converted) weights; every request's token stream and finish reason
must be IDENTICAL — greedy and seeded temperature>0, with the port's mixed
dispatch on and off.

Weight scale: random-init tiny models have near-flat logits, where an f32
summation-order difference between the two frameworks could flip an argmax.
The test weights are drawn with standard deviation 0.15 (the init default
is 0.02), which spreads the logits over several units: a flip would need a
top-2 gap under ~1e-5.
"""

import asyncio

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import (
    EngineConfig,
    TorchEngine,
    UnsupportedConfigError,
    UnsupportedRequestError,
)
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context

WEIGHT_STD = 0.15
ENGINE_KW = dict(
    model="tiny", max_num_seqs=4, page_size=8, num_pages=20, max_model_len=128,
    prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4,
)


def numpy_params(seed=0):
    """The reference's init_params tree with numpy leaves drawn at WEIGHT_STD."""
    c = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    rng = np.random.RandomState(seed)
    q_dim, kv_dim = c.num_heads * c.head_dim, c.num_kv_heads * c.head_dim
    L, Hd, I = c.num_layers, c.hidden_size, c.intermediate_size

    def w(*shape):
        return (rng.randn(*shape) * WEIGHT_STD).astype(np.float32)

    return {
        "embed": w(c.vocab_size, Hd),
        "layers": {
            "attn_norm": np.ones((L, Hd), np.float32),
            "wq": w(L, Hd, q_dim), "wk": w(L, Hd, kv_dim), "wv": w(L, Hd, kv_dim),
            "wo": w(L, q_dim, Hd),
            "mlp_norm": np.ones((L, Hd), np.float32),
            "w_gate": w(L, Hd, I), "w_up": w(L, Hd, I), "w_down": w(L, I, Hd),
        },
        "final_norm": np.ones((Hd,), np.float32),
        "lm_head": w(Hd, c.vocab_size),
    }


def trace():
    """Six requests: two prefill buckets (<=16 and <=32 token chunks), a
    shared 16-token prefix (r1/r2), one prompt long enough to be chunked
    (r3: 70 tokens over 32-token chunks), two seeded sampled streams, and
    more KV than the 20-page pool holds at once (forces a preemption)."""
    rng = np.random.RandomState(11)
    prompt = lambda n: rng.randint(3, 500, size=n).tolist()  # noqa: E731
    shared = prompt(16)
    specs = [
        (prompt(10), 20, {}),
        (shared + prompt(24), 24, {}),
        (shared + prompt(14), 16, {}),
        (prompt(70), 24, {}),
        (prompt(7), 20, {"temperature": 0.8, "seed": 7}),
        (prompt(25), 20, {"temperature": 1.0, "top_k": 20, "top_p": 0.9, "seed": 123456}),
    ]
    return [
        dict(token_ids=ids, request_id=f"r{i}", stop_conditions={"max_tokens": mt},
             sampling_options=samp)
        for i, (ids, mt, samp) in enumerate(specs)
    ]


async def drive(engine, request_cls, context_cls):
    """Submit the trace with event-based staggering (request i+1 arrives
    when request i has produced its first token — no wall-clock races) and
    collect (tokens, finish_reason) per request."""
    results = {}

    async def one(spec, started):
        toks, finish = [], None
        async for item in engine.generate(request_cls(**spec).to_dict(), context_cls()):
            assert item.get("event") != "error", item
            data = item.get("data")
            if data:
                toks.extend(data["token_ids"])
                finish = data.get("finish_reason") or finish
                started.set()
        started.set()
        results[spec["request_id"]] = (toks, finish)

    tasks = []
    for spec in trace():
        started = asyncio.Event()
        tasks.append(asyncio.create_task(one(spec, started)))
        await started.wait()
    await asyncio.gather(*tasks)
    stats = dict(engine.stats(), num_preemptions=engine.num_preemptions)
    await engine.close()
    return results, stats


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


@pytest.fixture(scope="module")
def reference(weights):
    """Streams of the JAX engine (its default configuration of the path)."""
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)
    engine = JaxEngine(JaxEngineConfig(**ENGINE_KW), model_config=cfg, params=params)
    return asyncio.run(drive(engine, JaxRequest, JaxContext))


@pytest.mark.parametrize("mixed", [True, False], ids=["mixed_on", "mixed_off"])
def test_streams_token_identical_to_jax_engine(weights, reference, mixed):
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    engine = TorchEngine(
        EngineConfig(**ENGINE_KW, mixed_dispatch=mixed), model_config=cfg,
        params=params_from_jax(weights, device="cpu"), device="cpu",
    )
    got, stats = asyncio.run(drive(engine, PreprocessedRequest, Context))
    want, ref_stats = reference
    assert set(got) == set(want)
    for rid in sorted(want):
        assert got[rid][0] == want[rid][0], f"{rid}: token streams differ"
        assert got[rid][1] == want[rid][1] == "length", rid
    # the trace really exercised what it is meant to
    assert stats["num_preemptions"] >= 1 and ref_stats["num_preemptions"] >= 1
    assert stats["kv_prefix_hit_blocks_total"] + stats["kv_skip_ahead_blocks"] > 0
    if mixed:
        assert stats["mixed_steps"] >= 1 and ref_stats["mixed_steps"] >= 1
    else:
        assert stats["mixed_steps"] == 0
    assert stats["dev_time"]["block"]["count"] >= 1


def test_stats_keep_reference_key_names(reference):
    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    engine = TorchEngine(EngineConfig(**ENGINE_KW), model_config=cfg, device="cpu")
    ours = engine.stats()
    asyncio.run(engine.close())
    theirs = reference[1]
    shared = [
        "num_waiting_reqs", "num_running_reqs", "gpu_cache_usage_perc",
        "request_total_slots", "kv_quant", "kv_active_blocks", "kv_total_blocks",
        "kv_cached_blocks", "kv_prefix_hit_blocks_total", "kv_skip_ahead_blocks",
        "mixed_steps", "split_steps", "mixed_padding_frac", "split_padding_frac",
        "mixed_rows_plain", "mixed_coverage_frac", "emit_batches", "emit_tokens",
        "sched_policy", "sched_granted_chunks",
    ]
    for key in shared:
        assert key in ours and key in theirs, key
    assert "num_preemptions" in ours and "dev_time" in ours


@pytest.mark.parametrize("field,value", [
    ("spec_mode", "eagle"),  # "ngram" is served; other modes are not ported
    ("tp_size", 2), ("pp_size", 2), ("sp_size", 2), ("dp_size", 2),
    ("role", "aggregated"),
])
def test_unsupported_config_fields_raise(field, value):
    cfg = EngineConfig(**{**ENGINE_KW, field: value})
    with pytest.raises(UnsupportedConfigError, match=field.split("_")[0]):
        TorchEngine(cfg, model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                    device="cpu")


@pytest.mark.parametrize("field,value", [
    ("multimodal", [{"type": "image_url", "url": "x", "position": 0}]),
    ("guided", {"kind": "regex", "regex": "[ab]*"}),
    ("lora_name", "adapter-a"),
    ("disagg_params", {"return_kv": True, "kvbm_push": True}),
    ("embed", True),
])
def test_unsupported_request_fields_raise(field, value):
    # guided and LoRA requests are served, except on a split-only speculative
    # engine; multimodal parts are served once encoded, and a part without
    # encoder embeddings is answered with the reference's error item
    # (tests/test_torch_multimodal.py holds the served path)
    extra = (dict(spec_mode="ngram", mixed_dispatch=False)
             if field in ("guided", "lora_name") else {})
    engine = TorchEngine(EngineConfig(**ENGINE_KW, **extra),
                         model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                         device="cpu")

    async def run():
        req = PreprocessedRequest(token_ids=[5, 6, 7], **{field: value}).to_dict()
        try:
            if field == "multimodal":
                items = [item async for item in engine.generate(req, Context())]
                assert len(items) == 1 and items[0]["event"] == "error"
                assert "needs encoder embeddings" in items[0]["comment"][0]
                return
            with pytest.raises(UnsupportedRequestError, match=field):
                async for _ in engine.generate(req, Context()):
                    pass
        finally:
            await engine.close()

    asyncio.run(run())


def test_cuda_is_the_default_device_and_required():
    """Entry points default to the card and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchEngine(EngineConfig(**ENGINE_KW),
                    model_config=tllama.LlamaConfig.tiny(dtype=torch.float32))


def test_num_pages_zero_takes_the_reference_fixed_pool_on_the_cpu(monkeypatch):
    """num_pages <= 0 auto-sizes; on the CPU with no DYN_HBM_BYTES that is
    the reference's fixed 2048 pages."""
    monkeypatch.delenv("DYN_HBM_BYTES", raising=False)
    engine = TorchEngine(EngineConfig(**{**ENGINE_KW, "num_pages": 0}),
                         model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                         device="cpu")
    assert engine.config.num_pages == 2048 and engine.allocator.num_pages == 2048
    assert engine.kv_k.shape[1] == 2049  # + the scratch page
    asyncio.run(engine.close())


@pytest.mark.parametrize("workers", [1, 2])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_num_pages_auto_sizing_matches_the_reference(weights, monkeypatch, workers, kv_quant):
    """With DYN_HBM_BYTES standing for the device's size, the port sizes the
    pool as the reference's `_auto_num_pages` does for its in-place "local"
    mode; the port's "scatter" writes in place too, so it sizes the same
    (the reference doubles a page there for its pool copy)."""
    from dynamo_tpu.engine.engine import _auto_num_pages as ref_auto

    from dynamo_tpu_torch.engine.engine import _auto_num_pages

    for k, v in {"DYN_HBM_BYTES": str(2**30), "DYN_HBM_UTILIZATION": "0.5",
                 "DYN_HBM_RESERVE_MB": "500", "DYN_WORKERS_PER_DEVICE": str(workers)}.items():
        monkeypatch.setenv(k, v)
    jparams = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                           is_leaf=lambda a: a is None)
    want = ref_auto(jparams, jllama.LlamaConfig.tiny(dtype=jnp.float32),
                    JaxEngineConfig(**{**ENGINE_KW, "num_pages": 0, "kv_quant": kv_quant,
                                       "decode_pool_mode": "local"}))
    tparams = params_from_jax(weights, device="cpu")
    for mode in ("local", "scatter"):
        got = _auto_num_pages(
            tparams, tllama.LlamaConfig.tiny(dtype=torch.float32),
            EngineConfig(**{**ENGINE_KW, "num_pages": 0, "kv_quant": kv_quant,
                            "decode_pool_mode": mode}), torch.device("cpu"))
        assert got == want > 100, (mode, got, want)
    monkeypatch.setenv("DYN_HBM_RESERVE_MB", "512")  # nothing left: refused
    with pytest.raises(RuntimeError, match="auto-sizing"):
        _auto_num_pages(tparams, tllama.LlamaConfig.tiny(dtype=torch.float32),
                        EngineConfig(**{**ENGINE_KW, "num_pages": 0}), torch.device("cpu"))
