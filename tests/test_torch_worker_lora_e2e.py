"""E2E: the unmodified OpenAI frontend (`python -m dynamo_tpu.frontend`) in
front of a `python -m dynamo_tpu_torch.worker --lora ad1=random:3` process
(tiny model, `--device cpu`): the model is listed and its card names the
adapter; a chat request with `nvext.lora_name` streams the text the same
request gives on an in-process engine with the same adapter; an unknown
adapter comes back as an error response, not a hang; the worker's /metrics
exports `lora_requests` and the pool's counters."""

import asyncio
import json
import time

import httpx
import pytest
import torch

from .utils import ManagedProcess, free_port

MODEL = "tiny-lora"


@pytest.fixture(scope="module")
def lora_cluster(tmp_path_factory):
    logs = tmp_path_factory.mktemp("torch_lora_e2e")
    http_port, sys_port = free_port(), free_port()
    disc = f"tcp://127.0.0.1:{free_port()}"
    fe = ManagedProcess(
        ["-m", "dynamo_tpu.frontend", "--http-port", str(http_port), "--embed-discovery",
         "--discovery", disc, "--router-mode", "kv"],
        name="torch_lora_fe",
    ).start(str(logs / "fe.log"))
    worker = None
    try:
        fe.wait_port(http_port)
        worker = ManagedProcess(
            ["-m", "dynamo_tpu_torch.worker", "--model", "tiny", "--model-name", MODEL,
             "--device", "cpu", "--discovery", disc, "--page-size", "8", "--num-pages", "128",
             "--max-num-seqs", "4", "--max-model-len", "256", "--context-length", "256",
             "--kv-events", "--lora", "ad1=random:3"],
            name="torch_lora_worker",
            env={"DYN_SYSTEM_PORT": str(sys_port), "DYN_SYSTEM_HOST": "127.0.0.1"},
        ).start(str(logs / "worker.log"))
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.time() + 90
        with httpx.Client() as client:
            while not client.get(f"{base}/v1/models").json()["data"]:
                if worker.proc.poll() is not None:
                    raise RuntimeError(f"worker exited: {(logs / 'worker.log').read_text()[-2000:]}")
                if time.time() > deadline:
                    raise TimeoutError("worker never registered")
                time.sleep(0.2)
        yield base, f"http://127.0.0.1:{sys_port}", disc
    finally:
        if worker is not None:
            worker.stop()
        fe.stop()


def _chat(base: str, body: dict):
    """(streamed text, error payload or None) of a streamed chat request."""
    text, error = "", None
    with httpx.Client(timeout=120) as client:
        with client.stream("POST", f"{base}/v1/chat/completions",
                           json={**body, "stream": True}) as r:
            if r.status_code != 200:
                return text, json.loads(r.read())
            for line in r.iter_lines():
                if not line.startswith("data: ") or line[6:] == "[DONE]":
                    continue
                chunk = json.loads(line[6:])
                if "error" in chunk:
                    error = chunk
                for choice in chunk.get("choices", []):
                    text += (choice.get("delta") or {}).get("content") or ""
    return text, error


def _in_process_text(body: dict) -> str:
    """The request through the reference preprocessor (the frontend's
    tokens), then a port engine on the worker's weights (seed 0) and its
    adapter (`random:3`), decoded with the byte tokenizer."""
    from dynamo_tpu.llm.model_card import ModelDeploymentCard
    from dynamo_tpu.llm.preprocessor import OpenAIPreprocessor
    from dynamo_tpu.llm.protocols import ChatCompletionRequest
    from dynamo_tpu.llm.tokenizers import load_tokenizer
    from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
    from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
    from dynamo_tpu_torch.llm.tokenizers import ByteTokenizer
    from dynamo_tpu_torch.models import lora
    from dynamo_tpu_torch.runtime.engine import Context

    tok = load_tokenizer("byte:512")
    card = ModelDeploymentCard(name=MODEL, tokenizer="byte", kv_cache_block_size=8,
                               context_length=256)
    pre = OpenAIPreprocessor(card, tok).preprocess_chat(ChatCompletionRequest.model_validate(body))
    assert pre.lora_name == "ad1"

    async def main():
        eng = TorchEngine(EngineConfig(model="tiny", page_size=8, num_pages=128, max_num_seqs=4,
                                       max_model_len=256), device="cpu")
        eng.register_adapters([lora.init_adapter(eng.model_config, "ad1",
                                                 torch.Generator().manual_seed(3))])
        ids = []
        try:
            req = PreprocessedRequest.from_dict(pre.to_dict())
            async for item in eng.generate(req.to_dict(), Context()):
                assert item.get("event") != "error", item
                ids += (item.get("data") or {}).get("token_ids") or []
        finally:
            await eng.close()
        return ids

    ids = asyncio.run(asyncio.wait_for(main(), 60))
    return ByteTokenizer(512).decode([t for t in ids if t not in (pre.eos_token_ids or [])])


def test_lora_requests_over_the_wire(lora_cluster):
    base, status, disc = lora_cluster
    assert [m["id"] for m in httpx.get(f"{base}/v1/models").json()["data"]] == [MODEL]

    async def cards():
        from dynamo_tpu.runtime import DistributedRuntime, RuntimeConfig

        cfg = RuntimeConfig.from_settings()
        cfg.discovery_endpoint = disc
        drt = await DistributedRuntime.create(cfg)
        try:
            return await drt.discovery.get_prefix(f"v1/mdc/dynamo/backend/generate/{MODEL}/")
        finally:
            await drt.close()

    card = json.loads(asyncio.run(asyncio.wait_for(cards(), 30))[0]["value"])
    assert card["lora_adapters"] == ["ad1"]

    body = {"model": MODEL, "messages": [{"role": "user", "content": "adapter?"}],
            "max_tokens": 12, "temperature": 0.0, "nvext": {"lora_name": "ad1"}}
    text, error = _chat(base, body)
    assert error is None and text
    assert text == _in_process_text(body)
    base_text, _ = _chat(base, {**body, "nvext": {}})
    assert base_text != text  # the adapter changes the stream

    _, error = _chat(base, {**body, "nvext": {"lora_name": "nope"}})
    assert error is not None and "unknown LoRA adapter 'nope'" in json.dumps(error)

    deadline = time.time() + 20
    while True:
        metrics = httpx.get(f"{status}/metrics", timeout=10).text
        if "dynamo_worker_lora_requests" in metrics or time.time() > deadline:
            break
        time.sleep(0.5)
    values = {ln.split("{")[0].split()[0]: float(ln.split()[-1])
              for ln in metrics.splitlines() if ln.startswith("dynamo_worker_lora")}
    assert values.get("dynamo_worker_lora_requests", 0) >= 1, values
    assert values.get("dynamo_worker_lora_pool_hits", 0) >= 1, values
    assert values["dynamo_worker_lora_pool_known"] == 1
