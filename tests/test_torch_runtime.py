"""The port's runtime and worker against the reference's, on one wire.

A port worker (`dynamo_tpu_torch.worker.serve`) holding a tiny engine on
weights converted from the reference registers on a REFERENCE discovery
service; a REFERENCE client streams from it and every stream must be the
token stream `dynamo_tpu.engine.JaxEngine.generate` gives for the same
request on the same weights. The reverse direction (the port's discovery
server and client against a reference `serve_endpoint`), a worker killed
mid-stream, the KV events the reference indexer scores, the metrics topic,
and the worker's refusals are checked too. Everything runs on the CPU in
one event loop per test, each bounded by `asyncio.wait_for`.

The reference's `codec.write_frame` hands the transport three segments,
the last one the payload, empty for most control frames. CPython 3.12's
selector transport keeps such an empty segment queued after a send
(`_adjust_leftover_buffer` stops at 0 bytes): the connection's writer
callback then spins and the connection never finishes closing, so a
reference server's `stop()` waits forever. The `single_write_frames`
fixture has the reference write the same bytes, `encode_frame(control,
payload)`, in one call; the port's codec leaves the empty segment out.
"""

import asyncio
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.llm.kv_router.indexer import KvIndexer
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime import (
    Context as JaxContext,
    DistributedRuntime as RefRuntime,
    PushRouter as RefPushRouter,
    RuntimeConfig as RefConfig,
    StreamLost as RefStreamLost,
    codec as ref_codec,
)
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine, UnsupportedConfigError
from dynamo_tpu_torch.llm.kv_router.publisher import EVENT_TOPIC_FMT, METRICS_TOPIC_FMT
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import (
    DiscoveryServer,
    DistributedRuntime,
    PushRouter,
    RuntimeConfig,
    StreamLost,
    codec,
)
from dynamo_tpu_torch.runtime.metrics import NUM_RUNNING_REQS, NUM_WAITING_REQS
from dynamo_tpu_torch.worker.__main__ import build_engine, parse_args, serve

from .test_torch_engine import ENGINE_KW, numpy_params
from .utils import free_port

BOUND_S = 120  # wall-clock bound of each test's event loop


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


@pytest.fixture(autouse=True)
def single_write_frames(monkeypatch):
    async def write_frame(writer, control, payload=b""):
        writer.write(ref_codec.encode_frame(control, payload))
        await writer.drain()

    monkeypatch.setattr(ref_codec, "write_frame", write_frame)


def requests():
    """Greedy and seeded requests; prompts of 1-4 pages of 8 tokens."""
    rng = np.random.RandomState(5)
    p = lambda n: rng.randint(3, 500, size=n).tolist()  # noqa: E731
    return [
        dict(token_ids=p(30), stop_conditions={"max_tokens": 12}, sampling_options={}),
        dict(token_ids=p(9), stop_conditions={"max_tokens": 10},
             sampling_options={"temperature": 0.8, "seed": 7}),
        dict(token_ids=p(17), stop_conditions={"max_tokens": 9},
             sampling_options={"temperature": 1.0, "top_k": 20, "top_p": 0.9, "seed": 99}),
    ]


def tokens_of(items):
    toks, finish = [], None
    for it in items:
        assert it.get("event") != "error", it
        data = it.get("data") or {}
        toks.extend(data.get("token_ids") or [])
        finish = data.get("finish_reason") or finish
    return toks, finish


@pytest.fixture(scope="module")
def weights():
    return numpy_params()


@pytest.fixture(scope="module")
def jax_streams(weights):
    """Each request alone on the reference engine."""
    cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
    params = jax.tree.map(lambda a: None if a is None else jnp.asarray(a), weights,
                          is_leaf=lambda a: a is None)

    async def drive():
        engine = JaxEngine(JaxEngineConfig(**ENGINE_KW), model_config=cfg, params=params)
        out = []
        for spec in requests():
            items = [it async for it in engine.generate(JaxRequest(**spec).to_dict(), JaxContext())]
            out.append(tokens_of(items))
        await engine.close()
        return out

    return run(drive())


def port_engine(weights) -> TorchEngine:
    return TorchEngine(
        EngineConfig(**ENGINE_KW), model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
        params=params_from_jax(weights, device="cpu"), device="cpu",
    )


async def start_worker(discovery: str, engine: TorchEngine, *extra: str):
    args = parse_args(["--device", "cpu", "--discovery", discovery, "--page-size", "8",
                       "--model-name", "tiny-llama", "--max-model-len", "128", *extra])
    started = asyncio.get_running_loop().create_future()
    task = asyncio.create_task(serve(args, engine, started))
    await asyncio.wait({task, started}, timeout=30, return_when=asyncio.FIRST_COMPLETED)
    if task.done():
        task.result()  # serve failed: raise its error
    return started.result(), task


async def stop_worker(worker, task):
    worker.drt.shutdown()
    await asyncio.wait_for(task, 30)


async def reference_plane():
    cfg = RefConfig.from_settings()
    cfg.discovery_endpoint = f"tcp://127.0.0.1:{free_port()}"
    drt = await RefRuntime.create(cfg, embed_discovery=True)
    return drt, cfg.discovery_endpoint


@pytest.mark.parametrize("binary", [True, False], ids=["enc_tok", "msgpack"])
def test_port_worker_streams_through_reference_planes(weights, jax_streams, binary):
    async def main():
        ref, disc = await reference_plane()
        engine = port_engine(weights)
        worker, task = await start_worker(disc, engine)
        try:
            ref.client.binary_tokens = binary
            client = await ref.namespace("dynamo").component("backend").endpoint("generate").client()
            assert await client.wait_for_instances(10) == [worker.drt.instance_id]
            router = RefPushRouter(client)
            got = []
            for spec in requests():
                got.append(tokens_of([it async for it in await router.generate(spec)]))
            # the card a reference frontend watches for
            cards = await ref.discovery.get_prefix("v1/mdc/dynamo/backend/generate/tiny-llama/")
            assert len(cards) == 1
            stats = worker.served.stats
            await client.close()
        finally:
            await stop_worker(worker, task)
            await engine.close()
            await ref.close()
        return got, stats

    got, stats = run(main())
    for i, (want, have) in enumerate(zip(jax_streams, got)):
        assert have == want, f"request {i}: the stream differs from JaxEngine.generate"
        assert have[1] == "length" and have[0]
    assert stats.requests_total == 3 and stats.errors_total == 0
    assert (stats.frames_binary > 0) == binary
    assert stats.items_total >= stats.frames_total > 0


def test_kv_events_reach_reference_indexer_and_metrics_topic(weights):
    async def main():
        ref, disc = await reference_plane()
        indexer = KvIndexer(ref, "dynamo", "backend", block_size=8)
        await indexer.start()
        metrics = await ref.discovery.subscribe(
            METRICS_TOPIC_FMT.format(namespace="dynamo", component="backend"))
        engine = port_engine(weights)
        worker, task = await start_worker(disc, engine, "--kv-events")
        wid = worker.drt.instance_id
        try:
            client = await ref.namespace("dynamo").component("backend").endpoint("generate").client()
            await client.wait_for_instances(10)
            spec = requests()[0]
            async for _ in await RefPushRouter(client).generate(spec):
                pass
            score = 0
            for _ in range(200):
                score = indexer.find_matches_for_tokens(spec["token_ids"]).scores.get(wid, 0)
                if score:
                    break
                await asyncio.sleep(0.02)
            msg = codec.unpack(await metrics.get(10))
            while msg["worker_id"] != wid:
                msg = codec.unpack(await metrics.get(10))
            await client.close()
        finally:
            await stop_worker(worker, task)
            await engine.close()
            await indexer.close()
            await ref.close()
        return score, msg

    score, msg = run(main())
    assert score == 3, "the reference indexer scores the port worker's 3 prompt blocks"
    assert NUM_RUNNING_REQS in msg["stats"] and NUM_WAITING_REQS in msg["stats"]
    assert msg["stats"]["kv_total_blocks"] == ENGINE_KW["num_pages"]
    assert EVENT_TOPIC_FMT == "kv_events/{namespace}/{component}"


def test_worker_killed_mid_stream_gives_stream_lost(weights):
    async def main():
        ref, disc = await reference_plane()
        engine = port_engine(weights)
        worker, task = await start_worker(disc, engine)
        got = 0
        try:
            client = await ref.namespace("dynamo").component("backend").endpoint("generate").client()
            await client.wait_for_instances(10)
            spec = dict(token_ids=list(range(5, 15)), stop_conditions={"max_tokens": 110})
            stream = await client.direct(spec, worker.drt.instance_id)
            with pytest.raises(RefStreamLost):
                async for _ in stream:
                    got += 1
                    if got == 2:
                        # the worker's sockets close abruptly, as at SIGKILL
                        await worker.drt.server.stop()
            await client.close()
        finally:
            await stop_worker(worker, task)
            await engine.close()
            await ref.close()
        return got

    assert run(main()) == 2


@pytest.mark.parametrize("binary", [True, False], ids=["enc_tok", "msgpack"])
def test_port_client_and_discovery_against_reference_endpoint(binary):
    async def handler(request, context):
        for i in range(request["n"]):
            yield {"data": {"token_ids": [i, i + 1]}}
            await asyncio.sleep(0)
        yield {"data": {"token_ids": [], "finish_reason": "stop"}, "usage": {"t": 2.5}}

    async def main():
        server = DiscoveryServer(port=0)
        _, port = await server.start()
        ref_cfg = RefConfig.from_settings()
        ref_cfg.discovery_endpoint = f"tcp://127.0.0.1:{port}"
        ref = await RefRuntime.create(ref_cfg)
        served = await ref.namespace("ns").component("c").endpoint("gen").serve_endpoint(handler)
        cfg = RuntimeConfig.from_settings()
        cfg.discovery_endpoint = ref_cfg.discovery_endpoint
        drt = await DistributedRuntime.create(cfg)
        drt.client.binary_tokens = binary
        try:
            client = await drt.namespace("ns").component("c").endpoint("gen").client()
            assert await client.wait_for_instances(10) == [ref.instance_id]
            items = [it async for it in await PushRouter(client).generate({"n": 5})]
            rtt = await drt.client.ping(client.instances[ref.instance_id].address)
            await client.close()
        finally:
            await drt.close()
            await ref.close()
            await server.stop()
        return items, served.stats, rtt

    items, stats, rtt = run(main())
    toks = [t for it in items[:-1] for t in it["data"]["token_ids"]]
    assert toks == [t for i in range(5) for t in (i, i + 1)]
    assert items[-1] == {"data": {"token_ids": [], "finish_reason": "stop"}, "usage": {"t": 2.5}}
    assert (stats.frames_binary > 0) == binary
    assert rtt >= 0


@pytest.mark.parametrize("flags", [
    ["--tp-size", "2"], ["--ep-size", "2"], ["--pp-size", "2"], ["--sp-size", "2"],
    ["--num-hosts", "2"],
    ["--host-id", "1"],
    ["--coordinator", "127.0.0.1:1"], ["--dp-attention"],
], ids=lambda f: "_".join(f).lstrip("-"))
def test_unported_worker_flags_raise(flags):
    args = parse_args(["--device", "cpu", *flags])
    with pytest.raises(UnsupportedConfigError, match=flags[0]):
        run(serve(args))


def test_spec_worker_flags_reach_the_engine():
    """`--spec ngram` is served: the flags become the engine's spec config."""
    engine = build_engine(parse_args([
        "--device", "cpu", "--num-pages", "64", "--max-num-seqs", "4", "--spec", "ngram",
        "--spec-draft-len", "3", "--spec-ngram", "3", "--spec-rounds", "2"]))
    cfg = engine.config
    assert (cfg.spec_mode, cfg.spec_draft_len, cfg.spec_ngram, cfg.spec_rounds) == (
        "ngram", 3, 3, 2)
    assert cfg.block_advance == 8 and engine.hist.shape == (4, cfg.spec_hist)
    run(engine.close())


def test_lora_worker_flags_reach_the_engine_and_the_card(weights, tmp_path):
    """`--lora NAME=random:SEED` and `--lora NAME=DIR` (a PEFT export) reach
    `register_adapters`, and the model card lists both."""
    from dynamo_tpu_torch.models import lora as tlora
    from dynamo_tpu_torch.models.safetensors_io import save_file

    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32)
    rng = np.random.RandomState(4)
    d = tmp_path / "peft"
    d.mkdir()
    save_file({f"base_model.model.model.layers.{li}.self_attn.q_proj.{ab}.weight":
               rng.randn(*shape).astype(np.float32)
               for li in range(cfg.num_layers)
               for ab, shape in (("lora_A", (4, 64)), ("lora_B", (64, 4)))},
              d / "adapter_model.safetensors")
    (d / "adapter_config.json").write_text('{"r": 4, "lora_alpha": 8}')

    async def main():
        ref, disc = await reference_plane()
        engine = port_engine(weights)
        worker, task = await start_worker(disc, engine, "--lora", "ad1=random:3",
                                          "--lora", f"sql={d}")
        try:
            cards = await ref.discovery.get_prefix("v1/mdc/dynamo/backend/generate/tiny-llama/")
        finally:
            await stop_worker(worker, task)
            await engine.close()
            await ref.close()
        return cards, engine

    cards, engine = run(main())
    assert engine.lora_names() == ["ad1", "sql"]
    card = json.loads(cards[0]["value"])
    assert card["lora_adapters"] == ["ad1", "sql"]
    pool = engine._lora_pool
    want = tlora.init_adapter(cfg, "ad1", torch.Generator().manual_seed(3))
    assert torch.equal(pool._host["ad1"].a["wo"], want.a["wo"])
    assert pool._host["sql"].scale == 2.0 and set(pool._host["sql"].a) == {"wq"}


def test_model_path_config_json_sets_the_depth(weights, tmp_path):
    """An HF checkpoint of the model's first layer whose config.json says
    one layer serves at that depth; a width it contradicts is refused."""
    from dynamo_tpu_torch.models.loader import save_llama_as_hf

    cfg = tllama.LlamaConfig.tiny(dtype=torch.float32, num_layers=1)
    params = params_from_jax(weights, device="cpu")
    params["layers"] = {k: v[:1] for k, v in params["layers"].items()}
    save_llama_as_hf(params, cfg, str(tmp_path))
    (tmp_path / "config.json").write_text('{"num_hidden_layers": 1, "hidden_size": 64}')
    engine = build_engine(parse_args(["--device", "cpu", "--num-pages", "16",
                                      "--model-path", str(tmp_path)]))
    assert engine.model_config.num_layers == 1
    assert engine.params["layers"]["wq"].shape[0] == 1
    run(engine.close())
    (tmp_path / "config.json").write_text('{"num_hidden_layers": 1, "hidden_size": 32}')
    with pytest.raises(ValueError, match="hidden_size=32"):
        build_engine(parse_args(["--device", "cpu", "--num-pages", "16",
                                 "--model-path", str(tmp_path)]))


def test_malformed_lora_flag_exits_with_the_references_message():
    with pytest.raises(SystemExit, match="--lora expects NAME=PATH, got 'ad1'"):
        run(serve(parse_args(["--device", "cpu", "--num-pages", "16", "--lora", "ad1"])))


def test_worker_device_cuda_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine(parse_args([]))


