"""The port's admission gate (`dynamo_tpu_torch/gate/`) against the
reference's: the reference's `tests/test_gate.py` cases run on both
packages (on the port they drive the port's gate, PushRouter, StepPlanner,
mock engine and HTTP service, the last through an aiohttp client), and one
scripted admission sequence on a fake clock gives both gates the same
decisions, counters and `/metrics` lines."""

import asyncio
import time
from pathlib import Path

import pytest

from . import frontend_parity

GATE_TESTS = Path(__file__).resolve().parent / "test_gate.py"
_CASES = frontend_parity.cases(frontend_parity.load_as(GATE_TESTS, "dynamo_tpu"))


@pytest.mark.parametrize("pkg,case", [
    (pkg, case) for case in _CASES for pkg in frontend_parity.PACKAGES])
def test_reference_gate_cases(pkg, case, monkeypatch, tmp_path):
    mod = frontend_parity.load_as(GATE_TESTS, pkg)
    try:
        frontend_parity.run(mod, case, monkeypatch=monkeypatch, tmp_path=tmp_path)
    finally:
        mod.faults.reset()  # the file's autouse fixture


def _scripted(pkg, monkeypatch):
    """Admissions on a fake clock: rate limits per tenant, a projected TTFT
    over and under each class's ceiling, a forced fault, then the
    exposition."""
    gate_mod = __import__(f"{pkg}.gate", fromlist=["x"])
    faults = __import__(f"{pkg}.runtime.faults", fromlist=["x"])
    clock = {"t": 1000.0}
    monkeypatch.setattr(time, "monotonic", lambda: clock["t"])

    class _NoDiscovery:
        discovery = None

    cfg = gate_mod.GateConfig(enabled=True, ttft_ms=1000.0, ttft_headroom=1.5,
                              max_wait_ms=0.0, max_queue=4, tenant_rate=2.0,
                              tenant_burst=3.0, retry_after_floor_s=1.0)
    gate = gate_mod.AdmissionGate(_NoDiscovery(), cfg)

    def load(est):
        key = ("dynamo", "backend")
        gate.signals._models.setdefault("m", key)
        gate.signals._by_comp.setdefault(key, {})[1] = gate_mod.InstanceLoad(
            est_ttft_ms=est, queue_depth=3, updated=clock["t"])

    async def main():
        await gate.start()
        out = []
        try:
            plan = [("a", 0, None), ("a", 0, None), ("a", 0, None), ("a", 0, None),
                    ("b", 0, 900.0), ("b", 2, 900.0), ("c", -1, 2500.0), ("c", 0, 2500.0),
                    ("d", 1, 100.0)]
            for i, (tenant, prio, est) in enumerate(plan):
                clock["t"] += 0.2
                if est is not None:
                    load(est)
                d = await gate.admit("m", tenant, prio)
                out.append((d.admitted, d.reason, round(d.retry_after_s, 6)))
            faults.configure("gate.admit:reject")
            d = await gate.admit("m", "e", 0)
            out.append((d.admitted, d.reason, round(d.retry_after_s, 6)))
            faults.reset()
            out.append(gate.render_prometheus().decode())
            out.append({k: v for k, v in gate.stats().items() if not k.startswith("gate_signal")})
        finally:
            await gate.close()
        return out

    return asyncio.run(main())


def test_scripted_admissions_equal(monkeypatch):
    ref = _scripted("dynamo_tpu", monkeypatch)
    port = _scripted("dynamo_tpu_torch", monkeypatch)
    assert port == ref
    decisions = ref[:-2]
    assert [a for a, _r, _s in decisions].count(False) >= 3  # rate, SLA and fault refusals
    assert "dynamo_frontend_gate_rejected_total" in ref[-2]
