"""The port's scheduler estimates and TTFT routing trigger against the JAX
package's, on the CPU.

* `estimated_prefill_wait_ms`, `estimated_req_ms` and `estimated_role_tok_s`
  of a `TorchEngine` equal the `JaxEngine`'s when both cost models saw the
  same observations and both engines hold the same admitted and waiting
  prompts; `stats()` publishes them as the reference spells and rounds
  them (`sched_est_*`, 0.0 while the model is cold).
* The reference admission gate's `LoadSignals` projects a port worker's
  TTFT from the `sched_est_ttft_ms` the port's metrics publisher sends,
  not from the queue-depth watermark.
* `DisaggregatedRouter.prefill_remote` decides like the reference's on a
  grid of prompt, prefix hit, estimate, target, `min_remote_tokens` and
  `ttft_headroom`.
* The port's metric registry rows equal the reference's, name for name.
"""

import asyncio
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import EngineConfig as JaxEngineConfig, JaxEngine
from dynamo_tpu.gate.config import GateConfig
from dynamo_tpu.gate.signals import LoadSignals
from dynamo_tpu.llm.disagg import DisaggConfig as RefDisaggConfig
from dynamo_tpu.llm.disagg import DisaggregatedRouter as RefRouter
from dynamo_tpu.llm.protocols import PreprocessedRequest as JaxRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.runtime import metrics as ref_metrics
from dynamo_tpu.runtime.engine import Context as JaxContext
from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.llm.disagg import DisaggConfig, DisaggregatedRouter
from dynamo_tpu_torch.llm.kv_router.publisher import WorkerMetricsPublisher
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest
from dynamo_tpu_torch.models import llama as tllama
from dynamo_tpu_torch.runtime import metrics as port_metrics
from dynamo_tpu_torch.runtime.engine import Context

from .test_torch_engine import ENGINE_KW

EST_KEYS = ("sched_est_ttft_ms", "sched_est_req_ms", "sched_est_prefill_tok_s",
            "sched_est_decode_tok_s")
# (kind, bucket, lanes, seconds) fed to both cost models
OBSERVATIONS = [("prefill", 16, 1, 0.0041), ("prefill", 32, 2, 0.0113),
                ("prefill", 16, 1, 0.0037), ("block", 4, 4, 0.0062),
                ("block", 4, 2, 0.0049)]
PROMPT_LENS = {"admitted": (40, 23), "waiting": (17, 64, 9)}


def _engines():
    jax_engine = JaxEngine(JaxEngineConfig(**ENGINE_KW),
                           model_config=jllama.LlamaConfig.tiny(dtype=jnp.float32))
    port = TorchEngine(EngineConfig(**ENGINE_KW),
                       model_config=tllama.LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    return jax_engine, port


def _load(engine, request_cls, context_cls, warm: bool):
    """Admitted slots part-way through their prompts and waiting ones, the
    same on either engine; `warm` feeds the cost model."""
    rng = np.random.RandomState(3)
    if warm:
        for obs in OBSERVATIONS:
            engine.scheduler.cost.observe(*obs)
    for i, n in enumerate(PROMPT_LENS["admitted"]):
        req = request_cls(token_ids=rng.randint(3, 500, size=n).tolist(),
                          stop_conditions={"max_tokens": 8})
        slot = engine._new_slot(req, context_cls())
        slot.prefill_pos = 8 * (i + 1)
        slot.slot_idx = i
        engine.slots[i] = slot
    for n in PROMPT_LENS["waiting"]:
        req = request_cls(token_ids=rng.randint(3, 500, size=n).tolist(),
                          stop_conditions={"max_tokens": 8})
        engine._waiting.append(engine._new_slot(req, context_cls()))


def _estimates(engine):
    return {
        "wait_0": engine.estimated_prefill_wait_ms(),
        "wait_37": engine.estimated_prefill_wait_ms(37),
        "req": engine.estimated_req_ms(),
        **{f"role_{k}": v for k, v in engine.estimated_role_tok_s().items()},
    }


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
def test_estimates_equal_the_reference(warm):
    jax_engine, port = _engines()
    _load(jax_engine, JaxRequest, JaxContext, warm)
    _load(port, PreprocessedRequest, Context, warm)
    want, got = _estimates(jax_engine), _estimates(port)
    assert set(got) == set(want)
    for key in want:
        if want[key] is None:
            assert got[key] is None, key
        else:
            assert got[key] == pytest.approx(want[key], rel=1e-6), key
    if warm:
        assert got["wait_37"] > got["wait_0"] > 0 and got["req"] > 0
        assert got["role_prefill"] > 0 and got["role_decode"] > 0
    else:
        assert got["wait_0"] is None and got["req"] == 0.0 and got["role_decode"] == 0.0
    # published as the reference spells and rounds them
    ours = port.stats()
    theirs = jax_engine.stats()
    for key in EST_KEYS:
        assert ours[key] == pytest.approx(theirs[key], rel=1e-6), key
    assert ours["sched_est_ttft_ms"] == (round(want["wait_0"], 1) if warm else 0.0)
    asyncio.run(port.close())


def test_gate_projects_a_port_worker_from_its_ttft_estimate():
    """The port's metrics publisher carries `sched_est_ttft_ms`; the gate's
    projection is that estimate. Without it (the port before the estimates
    were published) the gate falls back to the queue-depth watermark."""
    _, port = _engines()
    _load(port, PreprocessedRequest, Context, warm=True)
    published = []

    class _Discovery:
        async def publish(self, topic, payload):
            published.append((topic, payload))

    drt = type("Drt", (), {"discovery": _Discovery(),
                           "server": type("S", (), {"stats": staticmethod(lambda s: None)})()})()
    component = type("C", (), {"namespace": "dynamo", "name": "backend"})()
    endpoint = type("E", (), {"subject": "dynamo/backend/generate", "component": component})()

    async def main():
        pub = WorkerMetricsPublisher(drt, endpoint, 7, port.stats, interval=10.0)
        await pub.start()
        while not published:
            await asyncio.sleep(0.01)
        await pub.close()
        await port.close()

        class _Sub:
            def __init__(self, payloads):
                self.payloads = payloads

            def __aiter__(self):
                return self._gen()

            async def _gen(self):
                for p in self.payloads:
                    yield p

        from dynamo_tpu.runtime import codec as ref_codec

        stats = ref_codec.unpack(published[0][1])["stats"]
        without = {k: v for k, v in stats.items()
                   if k not in ("sched_est_ttft_ms", "sched_est_req_ms")}
        out = []
        for payload in (published[0][1], ref_codec.pack({"worker_id": 7, "stats": without})):
            signals = LoadSignals(None, GateConfig(ttft_ms=800.0, queue_watermark=2))
            signals._models["m"] = ("dynamo", "backend")
            await signals._watch(("dynamo", "backend"), _Sub([payload]))
            out.append((signals.projected_ttft_ms("m"), signals.per_request_ms("m")))
        return published[0][0], stats, out

    topic, stats, ((est_proj, est_req), (wm_proj, _)) = asyncio.run(
        asyncio.wait_for(main(), 30))
    assert topic == "kv_metrics/dynamo/backend"
    depth = stats["num_waiting_reqs"] + stats["num_running_reqs"]
    assert depth == 5 and stats["sched_est_ttft_ms"] > 0
    assert est_proj == stats["sched_est_ttft_ms"]
    assert est_req == stats["sched_est_req_ms"]
    assert wm_proj == depth / 2 * 800.0 != est_proj


GRID = list(itertools.product(
    (10, 40, 100),  # prompt
    (0, 24, 64),  # prefix hit
    (None, 5.0, 60.0, 400.0),  # local TTFT estimate
    (None, 0.0, 200.0),  # target
    (16, 4),  # min_remote_tokens
    (0.5, 0.1),  # ttft_headroom
))


def test_prefill_remote_decides_as_the_reference():
    mismatches = []
    remote = 0
    for prompt, hit, est, target, floor, headroom in GRID:
        kw = dict(remote_prefill_threshold_tokens=32, min_remote_tokens=floor,
                  ttft_headroom=headroom)
        ref = RefRouter(RefDisaggConfig(**kw))
        port = DisaggregatedRouter(DisaggConfig(**kw))
        args = (prompt, min(hit, prompt), True)
        opts = dict(local_ttft_est_ms=est, ttft_target_ms=target, now=0.0)
        want, got = ref.prefill_remote(*args, **opts), port.prefill_remote(*args, **opts)
        remote += want
        if want != got:
            mismatches.append((prompt, hit, est, target, floor, headroom, want, got))
    assert not mismatches
    # the grid holds both decisions, and the trigger's own cases: a prompt
    # under the threshold sent remote by the estimate, one held by the floor
    assert 0 < remote < len(GRID)
    port = DisaggregatedRouter(DisaggConfig(remote_prefill_threshold_tokens=32))
    assert not port.prefill_remote(30, 0, True)
    assert port.prefill_remote(30, 0, True, local_ttft_est_ms=150.0, ttft_target_ms=200.0)
    assert not port.prefill_remote(30, 16, True, local_ttft_est_ms=150.0, ttft_target_ms=200.0)


def test_metric_rows_equal_the_reference():
    ours, theirs = port_metrics.METRICS, ref_metrics.METRICS
    for name, spec in ours.items():
        assert theirs[name] == spec, name
    for const in ("SCHED_EST_TTFT_MS", "SCHED_EST_REQ_MS", "SCHED_EST_PREFILL_TOK_S",
                  "SCHED_EST_DECODE_TOK_S"):
        assert getattr(port_metrics, const) == getattr(ref_metrics, const)
        assert ours[getattr(port_metrics, const)]["wire"]
    exported = set(port_metrics.worker_exported_stats())
    for name in EST_KEYS:
        assert name in exported, name
