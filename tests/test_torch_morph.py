"""Live role morphing on the port, on the CPU (the reference's
`tests/test_morph.py` engine cases, on `TorchEngine`).

* The state machine: a morph drains a live stream (StreamSevered reaches the
  consumer, no item is left in its queue) and flips the role; a same-role
  morph is a no-op; an injected `worker.morph:error` rolls the role back and
  the engine serves again; an injected MorphCrash propagates with no
  rollback; a second morph while one runs and an unknown role are refused;
  new streams are refused with StreamSevered while the morph drains or
  flips.
* The worker's `morph` endpoint over the port's request plane moves the
  `generate` and `morph` lanes and the model card between the prefill and
  decode components and back; an aggregated worker answers with a typed
  error.
* The reference `PushRouter` sends no new stream to a port worker whose
  lanes are `morphing`.
"""

import asyncio
import json
import signal

import pytest
import torch

from dynamo_tpu.runtime.push_router import PushRouter as RefPushRouter
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.models.convert import params_from_jax
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig, faults
from dynamo_tpu_torch.runtime.discovery import DiscoveryServer
from dynamo_tpu_torch.runtime.engine import Context
from dynamo_tpu_torch.runtime.push_router import PushRouter
from dynamo_tpu_torch.runtime.request_plane import StreamSevered

from .test_torch_engine import numpy_params
from .test_torch_runtime import reference_plane, single_write_frames  # noqa: F401
from .test_torch_runtime import start_worker, stop_worker

LIMIT = 60
KW = dict(model="tiny", max_num_seqs=4, page_size=8, num_pages=64, max_model_len=128,
          prefill_buckets=(16, 32), max_prefill_chunk=32, decode_block_steps=4)


@pytest.fixture(autouse=True)
def time_limit():
    def expire(signum, frame):
        raise TimeoutError(f"test ran past {LIMIT} s")

    previous = signal.signal(signal.SIGALRM, expire)
    signal.alarm(LIMIT)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, previous)
    faults.reset()


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, LIMIT))


@pytest.fixture(scope="module")
def params():
    return numpy_params()


def engine_of(params, **over):
    return TorchEngine(EngineConfig(**{**KW, **over}),
                       model_config=tllama.LlamaConfig.tiny(dtype=torch.float32),
                       params=params_from_jax(params, device="cpu"), device="cpu")


def _req(n_prompt, max_tokens, rid):
    return PreprocessedRequest(token_ids=list(range(3, 3 + n_prompt)),
                               stop_conditions={"max_tokens": max_tokens, "ignore_eos": True},
                               request_id=rid).to_dict()


async def _consume(engine, req, got):
    try:
        async for _ in engine.generate(req, Context()):
            got["items"] += 1
    except StreamSevered:
        got["severed"] = True


async def _until(pred):
    for _ in range(1000):
        if pred():
            return
        await asyncio.sleep(0.01)
    raise AssertionError("condition never held")


# ---------------------------------------------------------------------- #
# the engine's state machine
# ---------------------------------------------------------------------- #


def test_morph_drains_live_streams_and_flips(params):
    async def main():
        eng = engine_of(params)
        try:
            got = [{"severed": False, "items": 0} for _ in range(2)]
            tasks = [asyncio.create_task(_consume(eng, _req(20, 100, f"m{i}"), g))
                     for i, g in enumerate(got)]
            await _until(lambda: all(g["items"] > 0 for g in got))
            queues = [s.queue for s in eng.slots if s is not None]
            summary = await eng.morph("prefill")
            await asyncio.wait_for(asyncio.gather(*tasks), 10)
            assert all(g["severed"] for g in got)
            assert all(q.empty() for q in queues) and not eng._severed_queues
            assert summary["from"] == "decode" and summary["to"] == "prefill"
            assert summary["drained"] == 2
            st = eng.stats()
            assert st["engine_role"] == "prefill" and st["morph_state"] == "serving"
            assert st["morphs_completed"] == 1 and st["morph_drained_sessions"] == 2
            assert st["morph_last_duration_s"] > 0
            assert st["sched_est_prefill_tok_s"] > 0 and st["sched_est_decode_tok_s"] > 0
            assert eng.allocator.active_pages == 0  # the severed slots released
            again = await eng.morph("prefill")  # same role: a no-op
            assert again["drained"] == 0 and eng.stats()["morphs_completed"] == 1
            # the flipped engine serves: growing into "both" drains nothing
            items = [i async for i in eng.generate(_req(9, 5, "after"), Context())]
            assert items and (await eng.morph("both"))["drained"] == 0
        finally:
            await eng.close()

    run(main())


def test_morph_rolls_back_on_injected_error(params):
    async def main():
        eng = engine_of(params)
        try:
            faults.configure("worker.morph:error,times=1", seed=1)
            with pytest.raises(faults.FaultError):
                await eng.morph("prefill")
            faults.reset()
            st = eng.stats()
            assert st["engine_role"] == "decode" and st["morph_state"] == "serving"
            assert st["morphs_rolled_back"] == 1 and st["morphs_completed"] == 0
            items = [i async for i in eng.generate(_req(8, 4, "rb"), Context())]
            assert items  # routable again
            await eng.morph("prefill")
            assert eng.stats()["morphs_completed"] == 1
        finally:
            await eng.close()

    run(main())


def test_morph_crash_propagates_without_rollback(params):
    async def main():
        eng = engine_of(params)
        try:
            faults.configure("worker.morph:crash,times=1", seed=1)
            with pytest.raises(faults.MorphCrash):
                await eng.morph("prefill")
            return eng.stats()
        finally:
            faults.reset()
            await eng.close()

    assert run(main())["morphs_rolled_back"] == 0


def test_morph_refuses_reentry_and_a_bad_role_and_new_streams_mid_morph(params):
    async def main():
        eng = engine_of(params)
        try:
            with pytest.raises(ValueError):
                await eng.morph("router")
            gate = asyncio.Event()
            t = asyncio.create_task(eng.morph("prefill", on_flip=gate.wait))
            await _until(lambda: eng.stats()["morph_state"] == "flipped")
            with pytest.raises(RuntimeError):
                await eng.morph("decode")  # one morph at a time
            # a new stream mid-morph is severed, so its caller re-routes
            with pytest.raises(StreamSevered):
                async for _ in eng.generate(_req(8, 4, "mid"), Context()):
                    pass
            with pytest.raises(StreamSevered):
                async for _ in eng.generate_decode_resume(_req(8, 4, "mid-d"), Context(), 5):
                    pass
            assert eng.begin_streamed_pull(_req(8, 4, "mid-s"), Context(),
                                           {"n_tokens": 8}) is None
            gate.set()
            await t
            assert eng.stats()["engine_role"] == "prefill"
        finally:
            await eng.close()

    run(main())


# ---------------------------------------------------------------------- #
# the worker's morph endpoint
# ---------------------------------------------------------------------- #


async def _keys(drt, prefix):
    return sorted(item["key"] for item in await drt.discovery.get_prefix(prefix))


def test_worker_morph_endpoint_moves_lanes_and_card(params):
    async def main():
        disc = DiscoveryServer(port=0)
        host, port = await disc.start()
        addr = f"tcp://{host}:{port}"
        engine = engine_of(params, role="prefill")
        worker, task = await start_worker(addr, engine, "--role", "prefill",
                                          "--kv-data-plane-host", "127.0.0.1")
        cfg = RuntimeConfig()
        cfg.discovery_endpoint = addr
        caller = await DistributedRuntime.create(cfg)
        inst = f"{worker.drt.instance_id:x}"
        try:
            async def morph(component, role):
                client = await caller.namespace("dynamo").component(component) \
                    .endpoint("morph").client()
                await client.wait_for_instances(10)
                out = [r async for r in await PushRouter(client).generate(
                    {"target_role": role}, Context())]
                await client.close()
                return out

            layout = {}
            for comp in ("prefill", "backend"):
                layout[comp] = [k for k in await _keys(caller, f"v1/instances/dynamo/{comp}/")]
            assert layout["prefill"] == [f"v1/instances/dynamo/prefill/generate/{inst}",
                                         f"v1/instances/dynamo/prefill/morph/{inst}"]
            assert layout["backend"] == [] and await _keys(caller, "v1/mdc/") == []

            reply = await morph("prefill", "decode")
            assert reply[0]["ok"] and reply[0]["from"] == "prefill" and reply[0]["to"] == "decode"
            assert await _keys(caller, "v1/instances/dynamo/prefill/") == []
            backend = await caller.discovery.get_prefix("v1/instances/dynamo/backend/")
            assert sorted(i["key"] for i in backend) == [
                f"v1/instances/dynamo/backend/generate/{inst}",
                f"v1/instances/dynamo/backend/morph/{inst}"]
            assert {json.loads(i["value"])["state"] for i in backend} == {"ready"}
            cards = await _keys(caller, "v1/mdc/dynamo/backend/generate/")
            assert len(cards) == 1 and worker.card_key == cards[0]
            assert worker.role == "decode" and engine.stats()["engine_role"] == "decode"
            # the moved lane serves
            gen = await caller.namespace("dynamo").component("backend").endpoint(
                "generate").client()
            await gen.wait_for_instances(10)
            items = [i async for i in await PushRouter(gen).generate(_req(12, 4, "w"), Context())]
            assert sum(len((i.get("data") or {}).get("token_ids") or []) for i in items) == 4
            await gen.close()

            again = await morph("backend", "decode")
            assert again == [{"ok": True, "noop": True, "role": "decode"}]
            bad = await morph("backend", "router")
            assert "bad target_role" in bad[0]["error"]
            back = await morph("backend", "prefill")
            assert back[0]["ok"] and back[0]["to"] == "prefill"
            assert await _keys(caller, "v1/instances/dynamo/backend/") == []
            assert await _keys(caller, "v1/mdc/") == [] and worker.card_key is None
            assert engine.stats()["morphs_completed"] == 2
        finally:
            await caller.close()
            await stop_worker(worker, task)
            await engine.close()
            await disc.stop()

    run(main())


def test_worker_morph_rollback_restores_lanes_and_aggregated_is_refused(params):
    async def main():
        disc = DiscoveryServer(port=0)
        host, port = await disc.start()
        addr = f"tcp://{host}:{port}"
        dec = engine_of(params)
        agg = engine_of(params)
        w_dec, t_dec = await start_worker(addr, dec, "--role", "decode")
        w_agg, t_agg = await start_worker(addr, agg)
        try:
            refused = [r async for r in w_agg.morph({"target_role": "prefill"}, Context())]
            assert refused == [{"error": "aggregated worker has no role to morph"}]
            assert w_agg.morph_served is None
            faults.configure("worker.morph:error,times=1", seed=1)
            reply = [r async for r in w_dec.morph({"target_role": "prefill"}, Context())]
            faults.reset()
            assert "morph rolled back: FaultError" in reply[0]["error"]
            assert w_dec.role == "decode" and w_dec.endpoint.component.name == "backend"
            assert w_dec.served.instance.state == w_dec.morph_served.instance.state == "ready"
            assert dec.stats()["morphs_rolled_back"] == 1
        finally:
            await stop_worker(w_agg, t_agg)
            await stop_worker(w_dec, t_dec)
            await agg.close()
            await dec.close()
            await disc.stop()

    run(main())


def test_reference_router_skips_a_morphing_port_worker(params):
    async def main():
        ref, disc = await reference_plane()
        engine = engine_of(params)
        worker, task = await start_worker(disc, engine, "--role", "decode")
        calls = []

        async def other(request, context):
            calls.append("B")
            yield {"worker": "B"}

        try:
            await ref.namespace("dynamo").component("backend").endpoint("generate") \
                .serve_endpoint(other)
            client = await ref.namespace("dynamo").component("backend").endpoint(
                "generate").client()
            await _until(lambda: len(client.ready_instance_ids()) == 2)
            # hold the morph in its drain: the lanes are `morphing` meanwhile
            faults.configure("worker.morph:delay,delay=3.0,times=1", seed=1)
            morph = asyncio.create_task(
                _collect(worker.morph({"target_role": "prefill"}, Context())))
            await _until(lambda: client.ready_instance_ids() == [ref.instance_id])
            # still present (lease alive), just unroutable
            assert set(client.instance_ids()) == {ref.instance_id, worker.drt.instance_id}
            router = RefPushRouter(client)
            for _ in range(4):
                async for item in await router.generate({"token_ids": [1, 2]}):
                    assert item["worker"] == "B"
            assert calls == ["B"] * 4
            assert (await morph)[0]["ok"]
            await client.close()
        finally:
            faults.reset()
            await stop_worker(worker, task)
            await engine.close()
            await ref.close()

    run(main())


async def _collect(stream):
    return [r async for r in stream]
