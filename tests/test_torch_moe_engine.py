"""The port's MoE serving against the JAX reference engine, on the CPU.

Greedy `TorchEngine` streams are token-identical to `JaxEngine`'s on
`tiny-moe` at capacity factor 8 (nothing drops: pads take expert capacity
and differ between the two packages by design, tests/test_torch_moe.py
says how), on the 6-request trace of tests/test_torch_engine.py, in the
scatter and local pool modes with the mixed dispatch on, and with int8
weights. The engine's streamed int8 random init equals init-then-quantize,
the registry serves the three MoE names, and LoRA on an MoE model is
refused with the reference's message (a request naming an adapter gets the
reference's error item). A worker built from `--model tiny-moe --quantize
int8` streams over the wire what an in-process engine streams, and
`--ep-size` / `--dp-attention` stay refused.

Weights are drawn at standard deviation 0.15, as in
tests/test_torch_engine.py, so an argmax flip would need a top-2 gap under
~1e-5.
"""

import asyncio

import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import moe as jm
from dynamo_tpu.models import quant as jq
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.engine.engine import MODEL_REGISTRY, _resolve_model
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import lora as tlora
from dynamo_tpu_torch.models import moe as tm
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime.engine import Context
from tests.test_torch_engine import ENGINE_KW, drive
from tests.test_torch_moe import JCFG8, TCFG, TCFG8, _jnp_tree, _np_tree, numpy_params

MOE_KW = dict(ENGINE_KW, model="tiny-moe")
ENGINE_CASES = [("scatter", None), ("local", None), ("scatter", "int8")]


@pytest.fixture(scope="module", params=ENGINE_CASES,
                ids=lambda c: f"{c[0]}-{c[1] or 'f32'}")
def engine_case(request):
    """(case, port params, streams and stats of the JAX engine)."""
    mode, quantize = request.param
    tree = numpy_params()
    if quantize:
        tree = _np_tree(jq.quantize_tree(_jnp_tree(tree)))
    engine = JaxEngine(
        JaxEngineConfig(**MOE_KW, decode_pool_mode=mode, quantize=quantize,
                        decode_block_unroll=1),
        model_config=JCFG8, params=_jnp_tree(tree))
    assert engine._model is jm
    return request.param, tree, asyncio.run(drive(engine, JaxRequest, JaxContext))


def test_engine_streams_token_identical_to_jax_engine(engine_case):
    (mode, quantize), tree, (want, ref_stats) = engine_case
    engine = TorchEngine(
        EngineConfig(**MOE_KW, decode_pool_mode=mode, quantize=quantize),
        model_config=TCFG8, params=params_from_jax(tree, device="cpu"), device="cpu")
    assert engine._model is tm
    got, stats = asyncio.run(drive(engine, PreprocessedRequest, Context))
    assert set(got) == set(want)
    for rid in sorted(want):
        assert got[rid][0] == want[rid][0], f"{rid}: token streams differ"
        assert got[rid][1] == want[rid][1] == "length", rid
    assert stats["mixed_steps"] >= 1 and stats["dev_time"]["block"]["count"] >= 1
    assert stats["num_preemptions"] >= 1


def test_streamed_int8_init_equals_init_then_quantize():
    """The engine's random init under quantize="int8" quantizes each
    (layer, expert) matrix as it is drawn: the same draws in the same
    order as init_params followed by quantize_tree(consume=True)."""
    cfg = EngineConfig(**MOE_KW, quantize="int8", seed=3)
    engine = TorchEngine(cfg, model_config=TCFG, device="cpu")
    gen = torch.Generator().manual_seed(3)
    want = tq.quantize_tree(tm.init_params(TCFG, gen, device="cpu"), consume=True)
    got = engine.params
    assert set(got["layers"]) == set(want["layers"])
    for name, w in [("embed", want["embed"]), ("lm_head", want["lm_head"]),
                    *want["layers"].items()]:
        g = got["layers"][name] if name in want["layers"] else got[name]
        assert tq.is_quant(g) == tq.is_quant(w), name
        for a, b in ((g["q"], w["q"]), (g["s"], w["s"])) if tq.is_quant(w) else ((g, w),):
            assert a.dtype == b.dtype and torch.equal(a, b), name
    assert got["layers"]["w_gate"]["s"].shape == (2, 4, 1, TCFG.intermediate_size)
    assert got["layers"]["router"].dtype == torch.float32
    assert engine.stats()["weight_bytes"] == tq.param_bytes(want)
    asyncio.run(engine.close())


def test_registry_and_lora_refusal():
    for name, preset in (("tiny-moe", "tiny_moe"), ("mixtral-8x7b", "mixtral_8x7b"),
                         ("gptoss-120b", "gptoss_120b")):
        assert name in MODEL_REGISTRY
        assert _resolve_model(name) == getattr(tm.MoeConfig, preset)()
    engine = TorchEngine(EngineConfig(**MOE_KW), model_config=TCFG, device="cpu")
    adapter = tlora.init_adapter(TCFG, "a", torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="LoRA serving is not supported on MoE models yet"):
        engine.register_adapters([adapter])
    # a request naming an adapter is answered with the reference's error item
    req = PreprocessedRequest(token_ids=[5, 6, 7], request_id="l",
                              stop_conditions={"max_tokens": 2}, lora_name="a").to_dict()

    async def run():
        items = [item async for item in engine.generate(req, Context())]
        await engine.close()
        return items

    items = asyncio.run(run())
    assert items[-1].get("event") == "error" and "unknown LoRA adapter 'a'" in str(items[-1])


def test_worker_serves_an_moe_model_from_flags():
    """`python -m dynamo_tpu_torch.worker --model tiny-moe --quantize int8`
    (built from its flags, served on the port's discovery and reached
    through a PushRouter) streams what an in-process engine of the same
    seed streams; expert parallelism stays refused."""
    from dynamo_tpu_torch.runtime import (DiscoveryServer, DistributedRuntime, PushRouter,
                                          RuntimeConfig)
    from dynamo_tpu_torch.worker import __main__ as worker_main

    bad = worker_main.unsupported_flags(worker_main.parse_args(
        ["--model", "mixtral-8x7b", "--ep-size", "2", "--dp-attention"]))
    assert bad == ["--ep-size", "--dp-attention"]
    flags = ["--model", "tiny-moe", "--quantize", "int8", "--device", "cpu", "--page-size", "8",
             "--num-pages", "64", "--max-num-seqs", "4", "--max-model-len", "128"]
    req = {"token_ids": list(range(30, 70)), "stop_conditions": {"max_tokens": 6}}

    async def main():
        server = DiscoveryServer(port=0)
        _, port = await server.start()
        disc = f"tcp://127.0.0.1:{port}"
        args = worker_main.parse_args([*flags, "--discovery", disc, "--warmup", "none"])
        started = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(worker_main.serve(args, None, started))
        cfg = RuntimeConfig.from_settings()
        cfg.discovery_endpoint = disc
        drt = await DistributedRuntime.create(cfg)
        try:
            await asyncio.wait({task, started}, timeout=60, return_when=asyncio.FIRST_COMPLETED)
            if task.done():
                task.result()
            worker = started.result()
            client = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
            await client.wait_for_instances(10)
            items = [it async for it in await PushRouter(client).generate(req)]
            await client.close()
            worker.drt.shutdown()
            await asyncio.wait_for(task, 30)
        finally:
            if not task.done():
                task.cancel()
            await drt.close()
            await server.stop()
        return worker.engine, [t for it in items for t in (it.get("data") or {}).get("token_ids", [])]

    engine, got = asyncio.run(main())
    assert engine._model is tm and tq.is_quant(engine.params["layers"]["w_gate"])
    local = worker_main.build_engine(worker_main.parse_args(flags))

    async def alone():
        items = [it async for it in local.generate(dict(req, request_id="x"), Context())]
        await local.close()
        return [t for it in items for t in (it.get("data") or {}).get("token_ids", [])]

    assert len(got) == 6 and got == asyncio.run(alone())
