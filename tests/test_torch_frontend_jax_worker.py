"""E2E: the port's frontend (`python -m dynamo_tpu_torch.frontend`, KV
routing, embedded discovery) in front of the reference's JAX worker
(`python -m dynamo_tpu.jax_worker`, tiny model on the CPU): the wire is
shared, so the port's router, preprocessor and detokenizer serve a JAX
engine as they serve the port's."""

import json
import time

import httpx
import pytest

from .utils import ManagedProcess, free_port


@pytest.fixture(scope="module")
def jax_behind_port_frontend(tmp_path_factory):
    logs = tmp_path_factory.mktemp("frontend_jax")
    http_port = free_port()
    disc = f"tcp://127.0.0.1:{free_port()}"
    fe = ManagedProcess(
        ["-m", "dynamo_tpu_torch.frontend", "--http-port", str(http_port), "--embed-discovery",
         "--discovery", disc, "--router-mode", "kv"], name="port_fe",
    ).start(str(logs / "fe.log"))
    worker = None
    try:
        fe.wait_port(http_port)
        worker = ManagedProcess(
            ["-m", "dynamo_tpu.jax_worker", "--model", "tiny", "--model-name", "tiny-llama",
             "--discovery", disc, "--page-size", "8", "--num-pages", "128",
             "--max-num-seqs", "4", "--max-model-len", "256", "--context-length", "256",
             "--kv-events"], name="jax_worker",
        ).start(str(logs / "worker.log"))
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.time() + 90
        with httpx.Client() as client:
            while not client.get(f"{base}/v1/models").json()["data"]:
                if worker.proc.poll() is not None:
                    raise RuntimeError((logs / "worker.log").read_text()[-2000:])
                if time.time() > deadline:
                    raise TimeoutError("JAX worker never registered")
                time.sleep(0.2)
        yield base
    finally:
        if worker is not None:
            worker.stop()
        fe.stop()


def test_port_frontend_streams_from_a_jax_worker(jax_behind_port_frontend):
    base = jax_behind_port_frontend
    with httpx.Client(timeout=120) as client:
        with client.stream("POST", f"{base}/v1/chat/completions", json={
            "model": "tiny-llama", "messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 6, "stream": True, "stream_options": {"include_usage": True},
        }) as r:
            assert r.status_code == 200
            chunks = []
            for line in r.iter_lines():
                if line.startswith("data: "):
                    if line[6:] == "[DONE]":
                        break
                    chunks.append(json.loads(line[6:]))
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert chunks[-1]["usage"]["completion_tokens"] == 6


def test_port_frontend_greedy_completion_from_a_jax_worker(jax_behind_port_frontend):
    base = jax_behind_port_frontend
    body = {"model": "tiny-llama", "prompt": list(range(5, 40)), "max_tokens": 5, "temperature": 0.0}
    with httpx.Client(timeout=120) as client:
        a = client.post(f"{base}/v1/completions", json=body).json()
        b = client.post(f"{base}/v1/completions", json=body).json()
        cleared = client.post(f"{base}/clear-kv-blocks").json()["cleared"]["tiny-llama"]
    assert a["choices"][0]["text"] == b["choices"][0]["text"]
    assert a["usage"] == {"prompt_tokens": 35, "completion_tokens": 5, "total_tokens": 40}
    assert len(cleared) == 1 and all(isinstance(v, int) for v in cleared.values())
