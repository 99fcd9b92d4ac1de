"""A port worker serving a checkpoint, against the JAX reference, on the CPU.

`python -m dynamo_tpu_torch.worker --model-path DIR --quantize int8
--device cpu` (driven through `serve(args)`, so the worker builds its own
engine from the flags) registers on a REFERENCE discovery service, and a
REFERENCE client's streams must equal those of a `JaxEngine` given the
reference's `load_llama_params(DIR, quantize="int8")`, greedy and seeded.
The same for a .gguf file, whose card advertises its embedded vocabulary.
The tiny model is served in f32 on both sides (the registry's `tiny` is
bf16; the test swaps in its f32 form). The reference writes its frames in
one call here, as in tests/test_torch_runtime.py (which says why).
"""

import asyncio
import dataclasses
import json

import jax.numpy as jnp
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jl
from dynamo_tpu.models import loader as jload
from dynamo_tpu.runtime import Context as JaxContext, PushRouter as RefPushRouter
from dynamo_tpu_torch.engine import engine as engine_mod
from dynamo_tpu_torch.llm.tokenizers import ByteTokenizer, GgufTokenizer
from dynamo_tpu_torch.models import llama as tl
from dynamo_tpu_torch.models import quant as tq
from dynamo_tpu_torch.worker import __main__ as worker_main
from tests.test_torch_engine import numpy_params
from tests.test_torch_gguf import write_reference_gguf
from tests.test_torch_runtime import (  # noqa: F401 — an autouse fixture
    reference_plane,
    requests,
    run,
    single_write_frames,
    tokens_of,
)

FLAGS = ["--page-size", "8", "--num-pages", "20", "--max-num-seqs", "4",
         "--max-model-len", "128", "--model-name", "tiny-llama"]
JAX_KW = dict(model="tiny", page_size=8, num_pages=20, max_num_seqs=4, max_model_len=128)


@pytest.fixture()
def f32_tiny(monkeypatch):
    """The registry's tiny model, and configs read from a GGUF, in f32."""
    monkeypatch.setitem(engine_mod.MODEL_REGISTRY, "tiny",
                        lambda: tl.LlamaConfig.tiny(dtype=torch.float32))
    real = worker_main.config_from_gguf
    monkeypatch.setattr(worker_main, "config_from_gguf",
                        lambda path: dataclasses.replace(real(path), dtype=torch.float32))


def jax_streams(params, cfg):
    async def drive():
        engine = JaxEngine(JaxEngineConfig(**JAX_KW, quantize="int8"), model_config=cfg,
                           params=params)
        out = []
        for spec in requests():
            items = [it async for it in engine.generate(JaxRequest(**spec).to_dict(), JaxContext())]
            out.append(tokens_of(items))
        await engine.close()
        return out

    return run(drive())


def serve_and_stream(model_path: str):
    """The worker built from flags behind a reference plane: its streams,
    its card and its engine's weights and tokenizer."""
    async def main():
        ref, disc = await reference_plane()
        args = worker_main.parse_args(["--device", "cpu", "--discovery", disc, "--model", "tiny",
                                       "--model-path", model_path, "--quantize", "int8", *FLAGS])
        started = asyncio.get_running_loop().create_future()
        task = asyncio.create_task(worker_main.serve(args, None, started))
        try:
            await asyncio.wait({task, started}, timeout=60, return_when=asyncio.FIRST_COMPLETED)
            if task.done():
                task.result()
            worker = started.result()
            client = await ref.namespace("dynamo").component("backend").endpoint("generate").client()
            await client.wait_for_instances(10)
            router = RefPushRouter(client)
            got = [tokens_of([it async for it in await router.generate(spec)])
                   for spec in requests()]
            cards = await ref.discovery.get_prefix("v1/mdc/dynamo/backend/generate/tiny-llama/")
            engine = worker.engine
            await client.close()
            worker.drt.shutdown()
            await asyncio.wait_for(task, 30)
        finally:
            if not task.done():
                task.cancel()
            await ref.close()
        return got, cards, engine

    return run(main())


def test_worker_serves_an_int8_safetensors_checkpoint_like_jax(tmp_path, f32_tiny):
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32)
    jload.save_llama_as_hf(numpy_params(), cfg, str(tmp_path))
    want = jax_streams(jload.load_llama_params(str(tmp_path), cfg, quantize="int8"), cfg)
    got, cards, engine = serve_and_stream(str(tmp_path))
    assert got == want and all(f == "length" and t for t, f in got)
    assert tq.is_quant(engine.params["layers"]["w_up"]) and tq.is_quant(engine.params["lm_head"])
    assert engine.stats()["weight_bytes"] == tq.param_bytes(engine.params)
    assert isinstance(engine.tokenizer, ByteTokenizer) and engine.tokenizer.vocab_size == 512
    assert len(cards) == 1 and json.loads(cards[0]["value"])["tokenizer"] == "byte"


def test_worker_serves_an_int8_gguf_with_its_vocabulary(tmp_path, f32_tiny):
    path = str(tmp_path / "tiny.gguf")
    write_reference_gguf(path, "q8_0")
    cfg = dataclasses.replace(jload.config_from_gguf(path), dtype=jnp.float32)
    want = jax_streams(jload.load_llama_params(path, cfg, quantize="int8"), cfg)
    got, cards, engine = serve_and_stream(str(tmp_path))  # a directory holding one .gguf
    assert got == want and all(f == "length" and t for t, f in got)
    assert engine.model_config.vocab_size == 512 and engine.model_config.num_layers == 2
    assert isinstance(engine.tokenizer, GgufTokenizer)
    assert len(cards) == 1 and json.loads(cards[0]["value"])["tokenizer"] == f"gguf:{path}"


def test_model_path_and_quantize_are_ported_flags():
    args = worker_main.parse_args(["--device", "cpu", "--model-path", "/no/such/dir",
                                   "--quantize", "int8"])
    assert worker_main.unsupported_flags(args) == []
    with pytest.raises(FileNotFoundError):
        worker_main.build_engine(args)
