"""The port's autoscaling soak harness (`dynamo_tpu_torch/planner/soak.py`)
and connectors against the reference's.

The non-slow cases of the reference's `tests/test_planner_soak.py` run on
both packages (on the port: the port's planner, connectors, frontend,
discovery, request plane and in-process mock workers; the mid-stream kill
case migrates a stream through the port's frontend). Then, on the port
alone: `LocalProcessConnector` over `python -m dynamo_tpu_torch.mocker`
subprocesses (spawn counted only once registered, a request through the
port frontend, a SIGKILLed replica respawned by `reconcile`, and a
shutdown that leaves no child), and a seeded ramp through the port's own
HTTP client with zero lost or duplicated stream items.
"""

import asyncio
import inspect
import os
import time
from pathlib import Path

import pytest

from . import frontend_parity
# the reference's request plane writes each frame in one call here (see the
# fixture: its three-segment write hangs under CPython 3.12)
from .test_torch_runtime import single_write_frames  # noqa: F401 — an autouse fixture

SOAK_TESTS = Path(__file__).resolve().parent / "test_planner_soak.py"
_CASES = frontend_parity.cases(frontend_parity.load_as(SOAK_TESTS, "dynamo_tpu"))
ROOT = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("pkg,case", [
    (pkg, case) for case in _CASES for pkg in frontend_parity.PACKAGES])
def test_reference_soak_cases(pkg, case, monkeypatch, tmp_path):
    mod = frontend_parity.load_as(SOAK_TESTS, pkg)
    try:
        frontend_parity.run(mod, case, monkeypatch=monkeypatch, tmp_path=tmp_path)
    finally:
        mod.faults.reset()  # the file's autouse fixture


def _slow_cases():
    """The reference's slow-marked cases, each with its own parameters."""
    mod = frontend_parity.load_as(SOAK_TESTS, "dynamo_tpu")
    out = []
    for name, fn in vars(mod).items():
        marks = getattr(fn, "pytestmark", []) if inspect.isfunction(fn) else []
        if name.startswith("test_") and any(m.name == "slow" for m in marks):
            grids = [m.args for m in marks if m.name == "parametrize"]
            if grids:
                (argname, values), = grids
                out += [(name, {argname: v}) for v in values]
            else:
                out.append((name, {}))
    return out


@pytest.mark.slow
@pytest.mark.parametrize("case,params", _slow_cases(), ids=lambda v: str(v))
def test_reference_slow_soak_cases_on_port(case, params, monkeypatch):
    """The acceptance soaks, which the reference marks slow, on the port."""
    mod = frontend_parity.load_as(SOAK_TESTS, "dynamo_tpu_torch")
    try:
        result = getattr(mod, case)(**params)
        if inspect.iscoroutine(result):
            asyncio.run(result)
    finally:
        mod.faults.reset()


def test_local_connector_spawns_kills_and_respawns_port_mockers():
    from dynamo_tpu_torch.llm.http.client import ClientSession
    from dynamo_tpu_torch.planner import DiscoveryWorkerCounts, LocalProcessConnector
    from dynamo_tpu_torch.planner.soak import SoakFrontend, drive_stream, mocker_cmd

    async def served(fe, tag):
        async with ClientSession() as s:
            rec = await drive_stream(s, fe.base_url, "mock-model", f"{tag} hi", 8)
        assert rec.ok and rec.content_tokens == 8, rec

    async def main():
        fe = await SoakFrontend().start()
        disc = fe.cfg.discovery_endpoint
        env = dict(os.environ, PYTHONPATH=str(ROOT), DYN_DISCOVERY_ENDPOINT=disc)
        counts = DiscoveryWorkerCounts(fe.drt.discovery, decode_component="mocker")
        conn = LocalProcessConnector(
            prefill_cmd=[], decode_cmd=mocker_cmd(disc, speedup_ratio=20.0),
            env=env, grace_s=10.0, ready_fn=counts.ready_fn(), ready_timeout=60.0)
        try:
            t0 = time.monotonic()
            await conn.set_replicas(0, 1)  # returns once the worker registered
            assert (await counts.count()) == (0, 1), time.monotonic() - t0
            await fe.wait_model("mock-model")
            await served(fe, "a")
            victim = conn.procs["decode"][0]
            victim.kill()  # SIGKILL: no drain
            await victim.wait()
            assert conn.counts() == (0, 0)
            await conn.reconcile()  # the planner's per-interval call
            assert conn.counts() == (0, 1)
            assert conn.procs["decode"][0].pid != victim.pid
            assert conn.procs["decode"][0]._dyn_worker_index == 0  # the dead slot's index
            deadline = time.monotonic() + 30
            while True:
                try:
                    await served(fe, "b")
                    break
                except AssertionError:
                    if time.monotonic() > deadline:
                        raise
                    await asyncio.sleep(0.2)
            procs = list(conn.procs["decode"])
        finally:
            await conn.shutdown()
            await fe.stop()
        assert conn.counts() == (0, 0)
        assert all(p.returncode is not None for p in procs)

    asyncio.run(main())


def test_ramp_through_port_client_is_contiguous():
    """A short seeded ramp over two in-process workers, every stream read
    by the port's client: all finish, nothing lost or duplicated."""
    from dynamo_tpu_torch.llm.mocker import MockEngineArgs
    from dynamo_tpu_torch.planner.soak import (InProcWorkerPool, RampLoad, RampPhase,
                                               SoakFrontend, attainment,
                                               contiguity_report, window_attainment)

    async def main():
        fe = await SoakFrontend().start()
        pool = InProcWorkerPool(fe.cfg, MockEngineArgs(speedup_ratio=20.0, block_size=8))
        try:
            await pool.set_replicas(0, 2)
            await fe.wait_model("mock-model")
            load = RampLoad(fe.base_url, "mock-model", [
                RampPhase(qps=8, duration_s=0.75, label="a"),
                RampPhase(qps=16, duration_s=0.75, label="b", osl_tokens=24)], seed=4)
            t0 = time.monotonic()
            recs = await load.run()
        finally:
            await pool.shutdown()
            await fe.stop()
        assert len(recs) == 6 + 12
        assert not contiguity_report(recs)
        assert [r.content_tokens for r in recs] == [16] * 6 + [24] * 12
        assert attainment(recs, 10_000) == 1.0
        assert sum(n for _, _, n in window_attainment(recs, t0, 0.5, 10_000)) == 18

    asyncio.run(main())
