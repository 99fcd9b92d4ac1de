"""E2E: the port's frontend (`python -m dynamo_tpu_torch.frontend`, KV
routing) beside the reference's (`python -m dynamo_tpu.frontend`), both in
front of one `python -m dynamo_tpu_torch.worker --model tiny --device cpu`
on one discovery server. The same requests give the same status codes
(200, 400, 404, 405, and 429 with the gate forced to reject), the same
greedy text, the same SSE event sequence (read by http.client and by
httpx) and the same `/metrics` sample names; a client that drops a stream
frees the worker's slot; `/clear-kv-blocks` reports each instance."""

import http.client
import json
import re
import socket
import time

import httpx
import pytest

from .utils import ManagedProcess, free_port

MODEL = "tiny-llama"
# the gate's fault point rejects the first admission of each frontend
FRONTEND_ENV = {"DYN_FAULT_PLAN": "gate.admit:reject,at=1"}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    logs = tmp_path_factory.mktemp("frontend_http")
    disc_port, status_port = free_port(), free_port()
    disc = f"tcp://127.0.0.1:{disc_port}"
    procs = []
    try:
        procs.append(ManagedProcess(
            ["-m", "dynamo_tpu_torch.runtime.discovery", "--host", "127.0.0.1",
             "--port", str(disc_port)], name="disc").start(str(logs / "disc.log")))
        procs[-1].wait_port(disc_port)
        ports = {}
        for name, mod in (("ref", "dynamo_tpu.frontend"), ("port", "dynamo_tpu_torch.frontend")):
            ports[name] = free_port()
            procs.append(ManagedProcess(
                ["-m", mod, "--http-port", str(ports[name]), "--discovery", disc,
                 "--router-mode", "kv"], name=f"fe_{name}", env=FRONTEND_ENV,
            ).start(str(logs / f"fe_{name}.log")))
        worker = ManagedProcess(
            ["-m", "dynamo_tpu_torch.worker", "--model", "tiny", "--model-name", MODEL,
             "--device", "cpu", "--discovery", disc, "--page-size", "8", "--num-pages", "128",
             "--max-num-seqs", "4", "--max-model-len", "256", "--context-length", "256",
             "--kv-events"],
            name="worker", env={"DYN_SYSTEM_ENABLED": "1", "DYN_SYSTEM_PORT": str(status_port)},
        ).start(str(logs / "worker.log"))
        procs.append(worker)
        for p in procs[1:3]:
            p.wait_port(ports["ref"] if p.name == "fe_ref" else ports["port"])
        deadline = time.time() + 90
        with httpx.Client() as client:
            for name in ("ref", "port"):
                while not client.get(f"http://127.0.0.1:{ports[name]}/v1/models").json()["data"]:
                    if worker.proc.poll() is not None:
                        raise RuntimeError((logs / "worker.log").read_text()[-2000:])
                    if time.time() > deadline:
                        raise TimeoutError(f"{name} frontend never saw the worker")
                    time.sleep(0.2)
        yield {"ports": ports, "status_port": status_port, "logs": logs}
    finally:
        for p in reversed(procs):
            p.stop()


def _req(port, method, path, body=None, headers=None, raw_body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    data = raw_body if raw_body is not None else (json.dumps(body) if body is not None else None)
    conn.request(method, path, body=data, headers=headers or {})
    r = conn.getresponse()
    out = (r.status, dict(r.getheaders()), r.read())
    conn.close()
    return out


def _both(cluster, *a, **kw):
    return {name: _req(port, *a, **kw) for name, port in cluster["ports"].items()}


def _chat(content, **kw):
    return {"model": MODEL, "messages": [{"role": "user", "content": content}], **kw}


def test_forced_gate_rejection_is_the_same_429(cluster):
    """First admission of each frontend: the gate's fault point rejects it."""
    out = _both(cluster, "POST", "/v1/chat/completions", _chat("hi", max_tokens=2),
                headers={"x-dynamo-tenant": "acme"})
    for name in ("ref", "port"):
        status, headers, body = out[name]
        assert status == 429, (name, body)
        assert int(headers["Retry-After"]) >= 1
    ref, port = (json.loads(out[n][2]) for n in ("ref", "port"))
    assert port == ref
    assert ref["error"]["reason"] == "fault" and ref["error"]["tenant"] == "acme"


CASES = [
    ("GET", "/v1/models", None), ("GET", "/health", None), ("GET", "/live", None),
    ("HEAD", "/v1/models", None), ("POST", "/v1/models", None), ("GET", "/nope", None),
    ("GET", "/v1/chat/completions", None), ("DELETE", "/metrics", None),
    ("POST", "/v1/chat/completions", "not json"),
    ("POST", "/v1/chat/completions", {"model": MODEL}),
    ("POST", "/v1/chat/completions", _chat("x", max_tokens=2.5)),
    ("POST", "/v1/chat/completions", {**_chat("x"), "model": "nope"}),
    ("POST", "/v1/chat/completions", _chat("x", max_tokens=2, logit_bias={"1": 1})),
    ("POST", "/v1/chat/completions", _chat("x", max_tokens=2, n=9)),
    ("POST", "/v1/chat/completions", _chat("x" * 300, max_tokens=2)),
    ("POST", "/v1/completions", {"model": MODEL, "prompt": "x", "n": 2}),
    ("POST", "/v1/completions", {"model": MODEL, "prompt": [1, "a"]}),
    ("POST", "/v1/embeddings", {"model": MODEL, "input": "x", "dimensions": 4}),
    ("POST", "/v1/embeddings", {"model": MODEL, "input": "x", "encoding_format": "base64"}),
    ("POST", "/v1/embeddings", {"model": "nope", "input": "x"}),
    ("POST", "/v1/responses", {"model": MODEL, "input": 5}),
    ("POST", "/v1/responses", {"input": "x"}),
]


@pytest.mark.parametrize("method,path,body", CASES,
                         ids=[f"{m}-{p}-{i}" for i, (m, p, _b) in enumerate(CASES)])
def test_status_codes_and_error_bodies_equal(cluster, method, path, body):
    raw = body if isinstance(body, str) else None
    out = _both(cluster, method, path, None if raw else body, raw_body=raw)
    assert out["port"][0] == out["ref"][0], (out["ref"], out["port"])
    if out["ref"][0] in (400, 404) and path.startswith("/v1/") and method == "POST":
        ref, port = (json.loads(out[n][2])["error"] for n in ("ref", "port"))
        assert (port["type"], port["code"]) == (ref["type"], ref["code"])
        if "invalid request" not in ref["message"]:  # pydantic's wording aside
            assert port["message"] == ref["message"]
    if out["ref"][0] == 405:
        assert out["port"][1]["Allow"] == out["ref"][1]["Allow"]
    if method == "HEAD":
        assert out["port"][2] == out["ref"][2] == b""


def _strip_ids(obj):
    """Drop what differs by construction: ids and timestamps."""
    if isinstance(obj, dict):
        return {k: _strip_ids(v) for k, v in obj.items()
                if k not in ("id", "created", "created_at", "item_id")}
    if isinstance(obj, list):
        return [_strip_ids(v) for v in obj]
    return obj


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", _chat("determinism", max_tokens=8, temperature=0.0)),
    ("/v1/chat/completions", _chat("two", max_tokens=5, temperature=0.0, n=2)),
    ("/v1/completions", {"model": MODEL, "prompt": "hello there", "max_tokens": 6, "temperature": 0}),
    ("/v1/completions", {"model": MODEL, "prompt": list(range(5, 30)), "max_tokens": 4,
                         "temperature": 0, "stop": ["ŉ"]}),
    ("/v1/responses", {"model": MODEL, "input": "respond", "max_output_tokens": 5, "temperature": 0}),
], ids=["chat", "chat-n2", "completion", "completion-ids-stop", "responses"])
def test_unary_greedy_bodies_equal(cluster, path, body):
    out = _both(cluster, "POST", path, body)
    assert out["ref"][0] == out["port"][0] == 200
    assert out["port"][1]["Content-Type"] == out["ref"][1]["Content-Type"]
    ref, port = (json.loads(out[n][2]) for n in ("ref", "port"))
    assert _strip_ids(port) == _strip_ids(ref)


def _sse_http_client(port, path, body):
    """Raw chunked bytes through http.client: the events and their framing."""
    status, headers, raw = _req(port, "POST", path, body)
    assert status == 200 and headers["Content-Type"] == "text/event-stream"
    return raw.decode().split("\n\n"), headers


def _sse_httpx(port, path, body):
    with httpx.Client(timeout=120) as client:
        with client.stream("POST", f"http://127.0.0.1:{port}{path}", json=body) as r:
            assert r.status_code == 200
            return [line for line in r.iter_lines() if line]


def _events(frames):
    out = []
    for frame in frames:
        if not frame:
            continue
        if frame.startswith("data: ") and frame != "data: [DONE]":
            out.append(("data", _strip_ids(json.loads(frame[6:]))))
        elif frame.startswith("event: "):
            name, data = frame.split("\n", 1)
            out.append((name, _strip_ids(json.loads(data[6:]))))
        else:
            out.append(("raw", frame))
    return out


@pytest.mark.parametrize("path,body", [
    ("/v1/chat/completions", _chat("stream me", max_tokens=6, temperature=0.0, stream=True,
                                   stream_options={"include_usage": True},
                                   nvext={"annotations": ["worker_id"]})),
    ("/v1/chat/completions", _chat("multi", max_tokens=4, temperature=0.0, stream=True, n=2)),
    ("/v1/completions", {"model": MODEL, "prompt": "stream", "max_tokens": 5, "temperature": 0,
                         "stream": True, "stream_options": {"include_usage": True}}),
    ("/v1/responses", {"model": MODEL, "input": "stream", "max_output_tokens": 4,
                       "temperature": 0, "stream": True}),
], ids=["chat", "chat-n2", "completion", "responses"])
def test_sse_event_sequences_equal(cluster, path, body):
    ports = cluster["ports"]
    ref_frames, ref_headers = _sse_http_client(ports["ref"], path, body)
    port_frames, port_headers = _sse_http_client(ports["port"], path, body)
    assert port_headers.get("Transfer-Encoding") == ref_headers.get("Transfer-Encoding") == "chunked"
    ref, port = _events(ref_frames), _events(port_frames)
    key = lambda e: json.dumps(e, sort_keys=True)  # noqa: E731
    if "n" in body:  # two choices interleave as their streams deliver
        assert sorted(port, key=key) == sorted(ref, key=key)
    else:
        assert port == ref
    if path != "/v1/responses":
        assert ref_frames[-2] == port_frames[-2] == "data: [DONE]"
    # httpx reads the port's stream to the same events
    lines = _sse_httpx(ports["port"], path, body)
    if path == "/v1/responses":  # "event: x" / "data: {...}" line pairs
        lines = ["\n".join(lines[i:i + 2]) for i in range(0, len(lines), 2)]
    got = _events(lines)
    if "n" in body:
        assert sorted(got, key=key) == sorted(port, key=key)
    else:
        assert got == port


def test_chunked_request_body_is_read(cluster):
    """A chunked request body is decoded, as aiohttp decodes one."""
    body = json.dumps(_chat("chunked", max_tokens=3, temperature=0.0)).encode()
    statuses = {}
    for name, port in cluster["ports"].items():
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            half = len(body) // 2
            s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\n"
                      b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
                      + b"%x\r\n%s\r\n%x\r\n%s\r\n0\r\n\r\n" % (half, body[:half],
                                                                len(body) - half, body[half:]))
            data = b""
            while chunk := s.recv(65536):
                data += chunk
        statuses[name] = int(data.split(b" ", 2)[1])
    assert statuses["port"] == statuses["ref"] == 200


def test_keep_alive_serves_several_requests_on_one_connection(cluster):
    conn = http.client.HTTPConnection("127.0.0.1", cluster["ports"]["port"], timeout=60)
    for i in range(3):
        conn.request("POST", "/v1/completions", body=json.dumps(
            {"model": MODEL, "prompt": f"k{i}", "max_tokens": 2, "temperature": 0}))
        r = conn.getresponse()
        assert r.status == 200 and json.loads(r.read())["usage"]["completion_tokens"] == 2
        conn.request("GET", "/v1/models")
        assert conn.getresponse().read()
    conn.close()


def _metric(port, name):
    text = _req(port, "GET", "/metrics")[2].decode()
    vals = [float(m.group(1)) for m in re.finditer(rf"^{name}(?:{{[^}}]*}})? (\S+)$", text, re.M)]
    return sum(vals) if vals else None


def _wait(fn, want, timeout=20.0):
    deadline = time.time() + timeout
    while fn() != want:
        assert time.time() < deadline, (fn(), want)
        time.sleep(0.05)


def _drop_stream(cluster, frontend):
    """Open a 200-token stream, read its first event, close the socket;
    return the tokens the worker emitted for it (its gauges are published
    stats, 0.25 s old at most)."""
    port = cluster["ports"][frontend]
    status = cluster["status_port"]
    before = _metric(port, "dynamo_frontend_client_disconnects_total") or 0.0
    tokens_before = _metric(status, "dynamo_worker_emit_tokens")
    body = json.dumps(_chat("drop", max_tokens=200, temperature=0.0, stream=True,
                            nvext={"ignore_eos": True})).encode()
    s = socket.create_connection(("127.0.0.1", port), timeout=60)
    s.sendall(b"POST /v1/chat/completions HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\n"
              b"Content-Length: %d\r\n\r\n%s" % (len(body), body))
    got = b""
    while b"data: " not in got:
        got += s.recv(65536)
    s.close()
    _wait(lambda: _metric(port, "dynamo_frontend_client_disconnects_total"), before + 1)
    time.sleep(2.0)  # long enough for all 200 tokens, and a stats publish after
    _wait(lambda: _metric(status, "dynamo_worker_num_running_reqs"), 0.0)
    return _metric(status, "dynamo_worker_emit_tokens") - tokens_before


def test_dropped_stream_frees_the_worker_slot(cluster):
    """The port's frontend cancels the stream when its client's connection
    ends, and the kill reaches the worker: its slot is free after a few
    tokens of the 200 asked for. Both frontends count the disconnect (the
    reference's kill is torn down with its pipeline before the request
    plane sends it, so its worker decodes on; measured, not held)."""
    port_emitted = _drop_stream(cluster, "port")
    ref_emitted = _drop_stream(cluster, "ref")
    assert port_emitted < 50, (port_emitted, ref_emitted)


def test_clear_kv_blocks_reports_each_instance(cluster):
    out = _both(cluster, "POST", "/clear-kv-blocks")
    assert out["ref"][0] == out["port"][0] == 200
    ref, port = (json.loads(out[n][2])["cleared"] for n in ("ref", "port"))
    assert set(port) == set(ref) == {MODEL}
    assert set(port[MODEL]) == set(ref[MODEL]) and len(ref[MODEL]) == 1
    assert all(isinstance(v, int) for v in port[MODEL].values())


# sums the planner reads that the same requests decide, whatever their timing
TRAFFIC_SUMS = (
    "dynamo_frontend_requests_total", "dynamo_frontend_input_tokens_total",
    "dynamo_frontend_output_tokens_total", "dynamo_frontend_client_disconnects_total",
    "dynamo_frontend_request_duration_seconds_count",
    "dynamo_frontend_time_to_first_token_seconds_count",
    "dynamo_frontend_inter_token_latency_seconds_count",
)


def test_metrics_sample_names_equal(cluster):
    """After the same traffic, the same sample names (prometheus_client's
    `_created` samples aside), and the planner's parser reads the same
    change in each traffic sum from both frontends: a unary and a streamed
    chat, greedy."""
    from dynamo_tpu.planner.metrics_source import parse_prometheus_text

    def sums():
        return {name: parse_prometheus_text(_req(port, "GET", "/metrics")[2].decode())
                for name, port in cluster["ports"].items()}

    before = sums()
    _both(cluster, "POST", "/v1/chat/completions", _chat("m", max_tokens=2, temperature=0.0))
    _both(cluster, "POST", "/v1/chat/completions",
          _chat("n", max_tokens=3, temperature=0.0, stream=True))
    after = sums()
    names = {name: {n for n in s if not n.endswith("_created")} for name, s in after.items()}
    assert names["port"] == names["ref"]
    assert {"dynamo_frontend_requests_total", "dynamo_frontend_time_to_first_token_seconds_bucket",
            "dynamo_frontend_gate_admitted_total", "dynamo_frontend_migrations_total"} <= names["port"]
    delta = {name: {k: after[name].get(k, 0.0) - before[name].get(k, 0.0) for k in TRAFFIC_SUMS}
             for name in after}
    assert delta["port"] == delta["ref"]
    assert delta["port"]["dynamo_frontend_requests_total"] == 2
    assert delta["port"]["dynamo_frontend_output_tokens_total"] == 5


def test_http_metrics_exposition_equal(monkeypatch):
    """One HttpMetrics of each package, fed the same observations on a
    frozen clock, renders the same exposition line for line (`_created`
    samples aside): names, labels, bucket counts, sums and gauges."""
    import types

    from dynamo_tpu.llm.http import metrics as ref_metrics
    from dynamo_tpu.planner.metrics_source import parse_prometheus_text
    from dynamo_tpu_torch.llm.http import metrics as port_metrics

    text = {}
    for name, mod in (("ref", ref_metrics), ("port", port_metrics)):
        monkeypatch.setattr(mod, "time", types.SimpleNamespace(monotonic=lambda: 100.0))
        m = mod.HttpMetrics()
        for endpoint in ("chat_completions", "completions", "completions"):
            m.request_start("a", endpoint)
        m.request_end("a", "chat_completions", 99.7, output_tokens=5, input_tokens=11,
                      first_token_at=99.8, last_token_at=99.9)
        m.request_end("a", "completions", 60.0, error=True, input_tokens=3)
        m.request_end("b", "completions", 99.99, output_tokens=1, input_tokens=2,
                      first_token_at=99.995, last_token_at=99.995)
        for seconds in (0.005, 0.1, 0.3, 20.0):
            m.observe_ttft("a", seconds)
        for n in (1, 3, 200):
            m.observe_tokens_per_frame("a", n)
        m.client_disconnect("b")
        text[name] = m.render().decode()
    lines = {name: [ln for ln in t.splitlines() if "_created" not in ln] for name, t in text.items()}
    assert lines["port"] == lines["ref"]
    assert parse_prometheus_text(text["port"])["dynamo_frontend_inflight_requests"] == 0
    assert parse_prometheus_text(text["port"])["dynamo_frontend_requests_total"] == 3


def test_grpc_port_is_refused():
    """KServe gRPC is not ported: `--grpc-port` other than 0 refuses to
    start, naming it, before anything binds."""
    import subprocess
    import sys

    from .utils import REPO

    res = subprocess.run([sys.executable, "-m", "dynamo_tpu_torch.frontend", "--grpc-port", "9000"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "UnsupportedConfigError" in res.stderr and "KServe gRPC" in res.stderr
