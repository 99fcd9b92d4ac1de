"""The port's mock engine (`dynamo_tpu_torch/llm/mocker/`) against the reference's.

The reference's `tests/test_mocker.py` cases run on both packages; then the
same requests and `MockEngineArgs` go through both `MockEngine`s: the same
token streams, the same KV events (block hashes, parents, token blocks) in
the same order, and the same stats, under fifo and sla scheduling, with a
cancelled stream, a prefix-cache hit, eviction pressure and disaggregated
(decode-only) requests.
"""

import asyncio
import types
from pathlib import Path

import numpy as np
import pytest

from . import frontend_parity

MOCKER_TESTS = Path(__file__).resolve().parent / "test_mocker.py"
_CASES = frontend_parity.cases(frontend_parity.load_as(MOCKER_TESTS, "dynamo_tpu"))


@pytest.mark.parametrize("pkg,case", [
    (pkg, case) for case in _CASES for pkg in frontend_parity.PACKAGES])
def test_reference_mocker_cases(pkg, case, monkeypatch, tmp_path):
    mod = frontend_parity.load_as(MOCKER_TESTS, pkg)
    frontend_parity.run(mod, case, monkeypatch=monkeypatch, tmp_path=tmp_path)


def _requests(seed, n=10):
    rng = np.random.default_rng(seed)
    shared = [int(t) for t in rng.integers(35, 127, size=24)]
    out = []
    for i in range(n):
        tail = [int(t) for t in rng.integers(35, 127, size=int(rng.integers(1, 40)))]
        req = {"request_id": f"req-{seed}-{i}",
               "token_ids": (shared if i % 3 == 0 else []) + tail,
               "stop_conditions": {"max_tokens": int(rng.integers(3, 30)),
                                   "ignore_eos": bool(i % 2)},
               "eos_token_ids": [int(rng.integers(35, 127))],
               "priority": int(rng.integers(-2, 3)), "tenant": f"t{i % 3}"}
        if i == 5:
            req["disagg_params"] = {"remote_prefill_done": True}
        out.append(req)
    return out


def _run(pkg, seed, cancel_idx=None, **args):
    """One engine's run of the seed's requests, arriving together. The
    engine module reads a frozen clock (the sla policy's deadlines and
    their 100 ms tenant buckets come from it); its steps still sleep."""
    mocker = __import__(f"{pkg}.llm.mocker", fromlist=["x"])
    module = __import__(f"{pkg}.llm.mocker.engine", fromlist=["x"])
    Context = __import__(f"{pkg}.runtime.engine", fromlist=["x"]).Context
    real_time = module.time
    module.time = types.SimpleNamespace(monotonic=lambda: 1000.0)
    try:
        return _drive(mocker, Context, seed, cancel_idx, args)
    finally:
        module.time = real_time


def _drive(mocker, Context, seed, cancel_idx, args):
    events = []
    eng = mocker.MockEngine(mocker.MockEngineArgs(**args), event_sink=events.append)

    async def one(req, i):
        ctx = Context()
        toks, finish = [], None
        async for item in eng.generate(req, ctx):
            data = item.get("data") or {}
            toks += data.get("token_ids") or []
            finish = data.get("finish_reason") or finish
            if i == cancel_idx and len(toks) >= 2:
                ctx.stop_generating()
        return toks, finish

    async def main():
        outs = await asyncio.gather(*[one(r, i) for i, r in enumerate(_requests(seed))])
        stats = eng.stats()
        await eng.close()
        return outs, stats

    outs, stats = asyncio.run(main())
    evs = [(e.event_type, e.block_hashes, e.parent_hash, e.token_blocks) for e in events]
    return outs, evs, stats


@pytest.mark.parametrize("seed,args,cancel", [
    (0, dict(block_size=8, speedup_ratio=100.0), None),
    (1, dict(block_size=4, speedup_ratio=100.0, num_gpu_blocks=40, max_num_seqs=3), 2),
    (2, dict(block_size=8, speedup_ratio=100.0, max_num_batched_tokens=16,
             sched_policy="sla", ttft_target_ms=50.0, itl_target_ms=1.0), None),
    (3, dict(block_size=16, speedup_ratio=100.0, enable_prefix_caching=False,
             enable_chunked_prefill=False), 4),
])
def test_mock_engine_streams_and_events_equal(seed, args, cancel):
    ref = _run("dynamo_tpu", seed, cancel, **args)
    port = _run("dynamo_tpu_torch", seed, cancel, **args)
    assert port[0] == ref[0]  # token streams and finish reasons
    assert port[1] == ref[1]  # KV events, in order
    assert port[2] == ref[2]  # stats
    assert any(toks for toks, _ in ref[0]) and ref[1]
    assert {e[0] for e in ref[1]} >= {"stored"}


def test_mock_engine_estimates_equal_under_backlog():
    """The gate's and the planner's signals: TTFT and request-cost
    estimates and per-role throughput, on one backlog."""
    outs = {}
    for pkg in frontend_parity.PACKAGES:
        mocker = __import__(f"{pkg}.llm.mocker", fromlist=["x"])
        engine = __import__(f"{pkg}.llm.mocker.engine", fromlist=["x"])
        Context = __import__(f"{pkg}.runtime.engine", fromlist=["x"]).Context
        eng = mocker.MockEngine(mocker.MockEngineArgs(max_num_seqs=2, speedup_ratio=3.0))
        for i in range(5):
            r = engine._MockRequest(request_id=f"r{i}", prompt=list(range(30 + 7 * i)),
                                    max_tokens=10 + i, eos_token_ids=[], ignore_eos=True,
                                    queue=None, context=Context())
            (eng._running if i < 2 else eng._waiting).append(r)
        outs[pkg] = (eng.estimated_ttft_ms(), eng.estimated_req_ms(),
                     eng.estimated_role_tok_s())
    assert outs["dynamo_tpu_torch"] == outs["dynamo_tpu"]
    assert outs["dynamo_tpu"][0] > 0 and outs["dynamo_tpu"][1] > 0
