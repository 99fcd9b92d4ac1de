"""The port's system-status server and canary health checks, on the CPU.

* `SystemStatusServer` (standard library) against the reference's aiohttp
  server for the same health states: the same status codes, content types
  and JSON on /health, /live and unknown paths; /metrics renders the port's
  registry.
* The runtime serves it when DYN_SYSTEM_PORT asks: the port is offset by
  DYN_WORKER_INDEX, and a taken port retreats to an ephemeral one.
* A canary against a hanging handler turns /health to 503, and a handler
  that answers again turns it back to 200.
* A port worker with KVBM tiers, DYN_SYSTEM_PORT and DYN_HEALTH_CHECK_ENABLED
  exports the `kvbm_*` stats — and the data plane's, the disagg handoff's,
  the scheduler estimates', migration's, morphing's and the checkpointer's —
  as `dynamo_worker_*` gauges, runs its canary and answers /health and
  /live.
"""

import asyncio
import json
import signal
import socket
import time
import urllib.request

import pytest
import torch

from dynamo_tpu.runtime.metrics import MetricsRegistry as RefRegistry
from dynamo_tpu.runtime.system_status import SystemHealth as RefHealth
from dynamo_tpu.runtime.system_status import SystemStatusServer as RefServer
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig
from dynamo_tpu_torch.runtime.discovery import DiscoveryServer
from dynamo_tpu_torch.runtime.health_check import HealthCheckManager
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.system_status import SystemHealth, SystemStatusServer

from .test_torch_engine import numpy_params
from .test_torch_runtime import start_worker, stop_worker

LIMIT = 60
# the engine stats the port computed before its registry exported them
C2_STATS = ("kv_pulls_completed", "kv_pages_pulled", "kv_transfers_served", "kv_bytes_served",
            "kv_format_mismatches", "kv_streamed_stages", "kv_streamed_fallbacks",
            "disagg_streamed_handoffs", "disagg_chunks_before_first_token",
            "disagg_first_token_before_last_chunk", "disagg_streamed_handoff_ratio")
# the exported rows of the estimates, migration accounting, morphing and
# the session checkpointer
NEW_ROWS = ("sched_est_ttft_ms", "sched_est_req_ms", "sched_est_prefill_tok_s",
            "sched_est_decode_tok_s", "kv_checkpoint_pushes", "kv_checkpoint_blocks_received",
            "migrations_resumed", "migration_replayed_tokens", "resume_source_checkpoint",
            "resume_source_peer", "resume_source_local", "resume_source_recompute",
            "morphs_completed", "morphs_rolled_back", "morph_drained_sessions",
            "morph_last_duration_s", "kvbm_ckpt_blocks_staged", "kvbm_ckpt_blocks_pushed",
            "kvbm_ckpt_bytes_pushed", "kvbm_ckpt_blocks_dropped", "kvbm_ckpt_push_failures",
            "kvbm_ckpt_format_refusals", "kvbm_ckpt_queue_depth", "kvbm_ckpt_ineligible_peers")


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {LIMIT} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


async def get(port: int, path: str, method: str = "GET"):
    """(status, content type, body) of one request, off the event loop."""
    def fetch():
        req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method)
        try:
            with urllib.request.urlopen(req, timeout=10) as r:
                return r.status, r.headers["Content-Type"], r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.headers["Content-Type"], e.read()

    return await asyncio.get_running_loop().run_in_executor(None, fetch)


STATES = {
    "no_endpoints": {},
    "all_healthy": {"ns/c/generate": True, "ns/c/other": True},
    "one_unhealthy": {"ns/c/generate": True, "ns/c/other": False},
}


@pytest.mark.parametrize("state", sorted(STATES))
def test_status_server_answers_as_the_reference(state):
    async def main():
        out = []
        for health_cls, server_cls, registry_cls in ((RefHealth, RefServer, RefRegistry),
                                                     (SystemHealth, SystemStatusServer,
                                                      MetricsRegistry)):
            health = health_cls()
            for path, ok in STATES[state].items():
                health.set_endpoint_health(path, ok)
            srv = server_cls(health, registry_cls(), host="127.0.0.1")
            _, port = await srv.start()
            try:
                out.append([await get(port, p) for p in ("/health", "/live", "/nope")]
                           + [(await get(port, "/metrics"))[:2]])
            finally:
                await srv.stop()
        return out

    ref, port = run(main())
    assert ref == port
    status, ctype, body = port[0]
    assert status == (503 if state == "one_unhealthy" else 200)
    assert ctype == "application/json; charset=utf-8"
    assert json.loads(body)["endpoints"] == STATES[state]


def test_metrics_renders_the_port_registry():
    async def main():
        registry = MetricsRegistry()
        registry.for_namespace("ns").counter("up_total", "ups").inc(3)
        registry.callback_gauge("worker_kvbm_host_hits", "engine stat", lambda: 7.0)
        srv = SystemStatusServer(SystemHealth(), registry, host="127.0.0.1")
        _, port = await srv.start()
        try:
            status, ctype, body = await get(port, "/metrics")
            head = await get(port, "/metrics", method="HEAD")
            post = await get(port, "/metrics", method="POST")
        finally:
            await srv.stop()
        return status, ctype, body, registry.render(), head, post

    status, ctype, body, rendered, head, post = run(main())
    assert status == 200 and ctype == "text/plain; charset=utf-8"
    assert body == rendered
    assert b"dynamo_worker_kvbm_host_hits{" in body and b"} 7.0" in body and b"up_total" in body
    assert head[0] == 200 and head[2] == b""
    assert post[0] == 405


def _taken_port():
    s = socket.socket()
    s.bind(("0.0.0.0", 0))
    s.listen(1)
    return s, s.getsockname()[1]


@pytest.mark.parametrize("index", [None, "2"], ids=["no_index", "worker_index_2"])
def test_runtime_serves_on_the_offset_port_or_retreats_when_taken(monkeypatch, index):
    blocker, taken = _taken_port()
    if index is not None:
        monkeypatch.setenv("DYN_WORKER_INDEX", index)

    async def main():
        cfg = RuntimeConfig()
        cfg.system_enabled = True
        cfg.system_host = "127.0.0.1"
        cfg.system_port = taken - int(index or 0)  # the offset lands on the taken port
        drt = await DistributedRuntime.create(cfg, static_mode=True)
        try:
            port = drt.system_status_server.port
            status = (await get(port, "/live"))[0]
        finally:
            await drt.close()
        # with the blocker gone, the same template gets its own port
        blocker.close()
        drt2 = await DistributedRuntime.create(cfg, static_mode=True)
        try:
            port2 = drt2.system_status_server.port
        finally:
            await drt2.close()
        return port, status, port2

    try:
        port, status, port2 = run(main())
    finally:
        blocker.close()
    assert port not in (0, taken) and status == 200
    assert port2 == taken


def test_env_enables_the_status_server_and_canaries(monkeypatch):
    monkeypatch.setenv("DYN_SYSTEM_PORT", "0")
    monkeypatch.setenv("DYN_SYSTEM_ENABLED", "1")
    monkeypatch.setenv("DYN_HEALTH_CHECK_ENABLED", "1")
    drt = DistributedRuntime()
    assert drt.config.system_enabled and drt.health_check_manager is not None


def test_hanging_handler_turns_health_to_503_through_the_canary():
    async def main():
        cfg = RuntimeConfig()
        cfg.system_enabled = True
        cfg.system_host = "127.0.0.1"
        drt = await DistributedRuntime.create(cfg, static_mode=True)
        hang = asyncio.Event()
        hang.set()

        async def handler(request, context):
            if hang.is_set():
                await asyncio.sleep(30)
            yield {"ok": True}

        served = await drt.namespace("h").component("c").endpoint("e").serve_endpoint(handler)
        hcm = HealthCheckManager(drt, drt.system_health, idle_timeout=0.05,
                                 request_timeout=0.3, check_interval=0.05)
        drt.health_check_manager = hcm
        hcm.register(served, {"canary": True})
        hcm.start()
        port = drt.system_status_server.port

        async def wait_status(want):
            deadline = time.monotonic() + 10
            while time.monotonic() < deadline:
                status, _, body = await get(port, "/health")
                if status == want:
                    return json.loads(body)
                await asyncio.sleep(0.05)
            raise AssertionError(f"/health never answered {want}")

        try:
            down = await wait_status(503)
            hang.clear()
            up = await wait_status(200)
        finally:
            await drt.close(graceful=False)
        return down, up, hcm

    down, up, hcm = run(main())
    assert down == {"status": "unhealthy", "endpoints": {"h/c/e": False}}
    assert up == {"status": "healthy", "endpoints": {"h/c/e": True}}
    assert hcm.probe_failures >= 1 and hcm.probes > hcm.probe_failures


def test_worker_exports_kvbm_gauges_and_runs_its_canary(monkeypatch, tmp_path):
    monkeypatch.setenv("DYN_SYSTEM_ENABLED", "1")
    monkeypatch.setenv("DYN_SYSTEM_HOST", "127.0.0.1")
    monkeypatch.setenv("DYN_HEALTH_CHECK_ENABLED", "1")
    monkeypatch.setenv("DYN_HEALTH_CHECK_IDLE_TIMEOUT", "0.2")
    engine = TorchEngine(
        EngineConfig(model="tiny", max_num_seqs=4, page_size=8, num_pages=20, max_model_len=128,
                     kvbm_host_blocks=8, kvbm_disk_blocks=8,
                     kvbm_disk_path=str(tmp_path / "g3")),
        model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
        params=params_from_jax(numpy_params(), device="cpu"), device="cpu")

    async def main():
        disc = DiscoveryServer(port=0)
        host, dport = await disc.start()
        worker, task = await start_worker(f"tcp://{host}:{dport}", engine,
                                          "--kv-data-plane-host", "127.0.0.1")
        try:
            port = worker.drt.system_status_server.port
            hcm = worker.drt.health_check_manager
            deadline = time.monotonic() + 20
            while hcm.probes == 0 and time.monotonic() < deadline:
                await asyncio.sleep(0.05)
            health = await get(port, "/health")
            live = await get(port, "/live")
            metrics = (await get(port, "/metrics"))[2].decode()
        finally:
            await stop_worker(worker, task)
            await engine.close()
            await disc.stop()
        return hcm, health, live, metrics, engine.data_plane

    hcm, health, live, metrics, dp = run(main())
    assert hcm.probes >= 1 and hcm.probe_failures == 0
    assert health[0] == 200 and json.loads(health[2])["status"] == "healthy"
    assert live[0] == 200
    for name in ("kvbm_offloaded_blocks", "kvbm_onboarded_blocks", "kvbm_host_hits",
                 "kvbm_disk_hits", "kvbm_offload_gathers", "health_canaries"):
        assert f"dynamo_worker_{name}" in metrics, name
    # the data plane's and the disagg handoff's counters, the migration,
    # morph, checkpoint and estimate rows: each a `dynamo_worker_*` gauge
    for name in C2_STATS + NEW_ROWS:
        assert f"dynamo_worker_{name} " in metrics or f"dynamo_worker_{name}{{" in metrics, name
