"""E2E: the unmodified OpenAI frontend (`python -m dynamo_tpu.frontend`,
KV routing) + a real `python -m dynamo_tpu_torch.worker` process (tiny
model, `--device cpu`): the shapes of tests/test_jax_worker_e2e.py against
the port's worker."""

import json
import time

import httpx
import pytest

from .utils import ManagedProcess, free_port


@pytest.fixture(scope="module")
def torch_cluster(tmp_path_factory):
    logs = tmp_path_factory.mktemp("torch_e2e")
    http_port = free_port()
    disc = f"tcp://127.0.0.1:{free_port()}"
    fe = ManagedProcess(
        ["-m", "dynamo_tpu.frontend", "--http-port", str(http_port), "--embed-discovery",
         "--discovery", disc, "--router-mode", "kv"],
        name="torch_fe",
    ).start(str(logs / "fe.log"))
    worker = None
    try:
        fe.wait_port(http_port)
        worker = ManagedProcess(
            ["-m", "dynamo_tpu_torch.worker", "--model", "tiny", "--model-name", "tiny-llama",
             "--device", "cpu", "--discovery", disc, "--page-size", "8", "--num-pages", "128",
             "--max-num-seqs", "4", "--max-model-len", "256", "--context-length", "256",
             "--kv-events"],
            name="torch_worker",
        ).start(str(logs / "worker.log"))
        base = f"http://127.0.0.1:{http_port}"
        deadline = time.time() + 90
        with httpx.Client() as client:
            while not client.get(f"{base}/v1/models").json()["data"]:
                if worker.proc.poll() is not None:
                    raise RuntimeError(f"torch worker exited: {(logs / 'worker.log').read_text()[-2000:]}")
                if time.time() > deadline:
                    raise TimeoutError("torch worker never registered")
                time.sleep(0.2)
        yield base
    finally:
        if worker is not None:
            worker.stop()
        fe.stop()


def test_torch_worker_chat_stream(torch_cluster):
    base = torch_cluster
    with httpx.Client(timeout=120) as client:
        with client.stream(
            "POST",
            f"{base}/v1/chat/completions",
            json={
                "model": "tiny-llama",
                "messages": [{"role": "user", "content": "hi"}],
                "max_tokens": 6,
                "stream": True,
                "stream_options": {"include_usage": True},
            },
        ) as r:
            assert r.status_code == 200
            chunks = []
            for line in r.iter_lines():
                if line.startswith("data: "):
                    p = line[6:]
                    if p == "[DONE]":
                        break
                    chunks.append(json.loads(p))
    usage = [c for c in chunks if c.get("usage")]
    assert usage and usage[-1]["usage"]["completion_tokens"] == 6


def test_torch_worker_deterministic_greedy(torch_cluster):
    base = torch_cluster
    body = {
        "model": "tiny-llama",
        "messages": [{"role": "user", "content": "determinism"}],
        "max_tokens": 8,
        "temperature": 0.0,
    }
    with httpx.Client(timeout=120) as client:
        a = client.post(f"{base}/v1/chat/completions", json=body).json()
        b = client.post(f"{base}/v1/chat/completions", json=body).json()
    assert a["choices"][0]["message"]["content"] == b["choices"][0]["message"]["content"]
    assert a["usage"]["completion_tokens"] == 8


def test_torch_worker_clear_kv_blocks_admin_route(torch_cluster):
    """POST /clear-kv-blocks reaches the port worker's `clear_kv_blocks`
    annotation and flushes its reusable prefix-cache pages."""
    base = torch_cluster
    body = {
        "model": "tiny-llama",
        "prompt": list(range(5, 40)),
        "max_tokens": 4,
        "temperature": 0.0,
    }
    with httpx.Client(timeout=120) as client:
        r = client.post(f"{base}/v1/completions", json=body)
        assert r.status_code == 200
        resp = client.post(f"{base}/clear-kv-blocks")
        assert resp.status_code == 200
        cleared = resp.json()["cleared"]["tiny-llama"]
        assert cleared and all(isinstance(v, int) for v in cleared.values()), cleared
        assert sum(cleared.values()) > 0
        resp2 = client.post(f"{base}/clear-kv-blocks")
        assert sum(resp2.json()["cleared"]["tiny-llama"].values()) == 0
        r2 = client.post(f"{base}/v1/completions", json=body)
        assert r2.status_code == 200
        assert r2.json()["choices"][0]["text"] == r.json()["choices"][0]["text"]
