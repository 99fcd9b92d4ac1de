"""E2E: the unmodified OpenAI frontend (`python -m dynamo_tpu.frontend`) in
front of a `python -m dynamo_tpu_torch.worker --spec ngram` process (tiny
model, `--device cpu`): a `response_format: json_schema` request and an
`nvext.guided_choice` request stream outputs that fit their constraint
(guided rows ride the fused mixed path beside the speculative lanes), and
the worker's /metrics exports the speculative and mixed-row counters."""

import json
import time

import httpx
import pytest

from .utils import ManagedProcess, free_port

SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "col": {"enum": ["red", "green"]}}}


@pytest.fixture(scope="module")
def spec_cluster(tmp_path_factory):
    logs = tmp_path_factory.mktemp("torch_spec_e2e")
    http_port, sys_port = free_port(), free_port()
    disc = f"tcp://127.0.0.1:{free_port()}"
    fe = ManagedProcess(
        ["-m", "dynamo_tpu.frontend", "--http-port", str(http_port), "--embed-discovery",
         "--discovery", disc],
        name="torch_spec_fe",
    ).start(str(logs / "fe.log"))
    worker = None
    try:
        fe.wait_port(http_port)
        worker = ManagedProcess(
            ["-m", "dynamo_tpu_torch.worker", "--model", "tiny", "--model-name", "tiny-spec",
             "--device", "cpu", "--discovery", disc, "--page-size", "8", "--num-pages", "128",
             "--max-num-seqs", "4", "--max-model-len", "256", "--context-length", "256",
             "--spec", "ngram", "--spec-draft-len", "3", "--spec-rounds", "2"],
            name="torch_spec_worker",
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
        yield base, f"http://127.0.0.1:{sys_port}"
    finally:
        if worker is not None:
            worker.stop()
        fe.stop()


def _stream_text(base: str, body: dict) -> str:
    with httpx.Client(timeout=120) as client:
        with client.stream("POST", f"{base}/v1/chat/completions",
                           json={**body, "stream": True}) as r:
            assert r.status_code == 200, r.read()
            text = ""
            for line in r.iter_lines():
                if not line.startswith("data: ") or line[6:] == "[DONE]":
                    continue
                for choice in json.loads(line[6:]).get("choices", []):
                    text += (choice.get("delta") or {}).get("content") or ""
    return text


def test_guided_requests_over_the_wire_on_a_spec_worker(spec_cluster):
    base, status = spec_cluster
    msg = [{"role": "user", "content": "colour?"}]
    text = _stream_text(base, {
        "model": "tiny-spec", "messages": msg, "max_tokens": 120, "temperature": 1.0, "seed": 3,
        "response_format": {"type": "json_schema",
                            "json_schema": {"name": "c", "schema": SCHEMA}}})
    obj = json.loads(text)
    assert set(obj) == {"ok", "col"} and isinstance(obj["ok"], bool)
    assert obj["col"] in ("red", "green")
    choice = _stream_text(base, {
        "model": "tiny-spec", "messages": [{"role": "user", "content": "yes or no?"}],
        "max_tokens": 16, "nvext": {"guided_choice": ["yes", "no"]}})
    assert choice in ("yes", "no")
    # an unguided greedy stream: served through the spec blocks
    plain = _stream_text(base, {"model": "tiny-spec", "max_tokens": 24, "temperature": 0.0,
                                "messages": [{"role": "user", "content": "abc abc abc abc"}]})
    assert plain
    deadline = time.time() + 20
    while True:
        metrics = httpx.get(f"{status}/metrics", timeout=10).text
        if "dynamo_worker_spec_num_drafts" in metrics or time.time() > deadline:
            break
        time.sleep(0.5)
    for name in ("spec_num_drafts", "spec_num_draft_tokens", "spec_num_accepted_tokens",
                 "spec_mean_accepted_len", "mixed_rows_spec", "mixed_rows_guided",
                 "guided_requests"):
        assert f"dynamo_worker_{name}" in metrics, name
    drafts = [ln for ln in metrics.splitlines() if ln.startswith("dynamo_worker_spec_num_drafts")]
    assert drafts and float(drafts[0].split()[-1]) > 0, drafts
