"""The port's SLA planner (`dynamo_tpu_torch/planner/`) against the reference's.

The reference's `tests/test_planner.py` cases run on both packages (less
the profiler round trip, which `test_torch_planner_profiler.py` holds on
the CPU, and the operator-lite case: `deploy/` is not ported). Then the
same inputs go through both packages: the predictors' values on one
series, the interpolators' grids and `find_best_throughput_per_chip` on
one raw_data, the `ScaleDecision` sequences of two `Planner`s fed one
`Metrics` sequence, the `DYN_PLANNER_*` defaults against the reference's
`ENV_REGISTRY`, `parse_prometheus_text` of the port frontend's `/metrics`,
and `FrontendMetricsSource.read` against a live port frontend on loopback.
"""

import asyncio
import math
from pathlib import Path

import numpy as np
import pytest

import dynamo_tpu.planner as jp
import dynamo_tpu_torch.planner as tp
from dynamo_tpu.planner.metrics_source import parse_prometheus_text as j_parse
from dynamo_tpu.runtime.config import ENV_REGISTRY
from dynamo_tpu_torch.planner.metrics_source import parse_prometheus_text as t_parse

from . import frontend_parity

PLANNER_TESTS = Path(__file__).resolve().parent / "test_planner.py"
_SKIP = {"TestProfilerRoundTrip.test_profile_tiny_and_interpolate",
         "TestFrontendRole.test_virtual_connector_publishes_num_frontends"}
_CASES = [c for c in frontend_parity.cases(frontend_parity.load_as(PLANNER_TESTS, "dynamo_tpu"))
          if c not in _SKIP]
PKGS = {"dynamo_tpu": jp, "dynamo_tpu_torch": tp}


@pytest.mark.parametrize("pkg,case", [
    (pkg, case) for case in _CASES for pkg in frontend_parity.PACKAGES])
def test_reference_planner_cases(pkg, case, monkeypatch, tmp_path):
    mod = frontend_parity.load_as(PLANNER_TESTS, pkg)
    frontend_parity.run(mod, case, monkeypatch=monkeypatch, tmp_path=tmp_path)


def _series(seed, n=60):
    rng = np.random.default_rng(seed)
    x = 50 + 10 * np.sin(np.arange(n) / 5) + rng.standard_normal(n) * 3
    x[rng.choice(n, 4, replace=False)] = np.nan  # dropped points
    return [float(v) for v in x]


@pytest.mark.parametrize("kind,kwargs", [
    ("constant", {}), ("moving-average", {"window_size": 7}), ("ar", {}),
    ("ar", {"order": 2, "window_size": 12}), ("arima", {}), ("prophet", {})])
def test_predictors_equal_on_one_series(kind, kwargs):
    preds = {k: m.make_predictor(kind, **kwargs) for k, m in PKGS.items()}
    for v in _series(len(kind)):
        out = {}
        for k, p in preds.items():
            p.add_data_point(v)
            out[k] = p.predict_next()
        assert out["dynamo_tpu_torch"] == out["dynamo_tpu"]
    with pytest.raises(ValueError):
        tp.make_predictor("nope")


def _raw(seed):
    rng = np.random.default_rng(seed)
    isl = np.sort(rng.choice(np.arange(64, 8192, 64), 6, replace=False)).astype(np.float64)
    prefill = {"prefill_isl": isl,
               "prefill_ttft": 5 + isl * rng.uniform(0.01, 0.03) + rng.uniform(0, 3, 6),
               "prefill_thpt_per_gpu": 12000 - isl * rng.uniform(0.2, 0.8)}
    xs, ys = np.meshgrid([0.1, 0.25, 0.5, 0.75, 0.95], [256.0, 1024.0, 4096.0])
    xs, ys = xs.ravel(), ys.ravel()
    itl = 4 + 20 * xs + ys / 2048 + rng.uniform(0, 1, xs.size)
    decode = {"x_kv_usage": xs, "y_context_length": ys, "z_itl": itl,
              "z_thpt_per_gpu": xs * 65536 / ys / (itl / 1e3),
              "max_kv_tokens": np.array([65536.0])}
    return prefill, decode


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interpolators_equal_on_one_raw_data(seed):
    prefill, decode = _raw(seed)
    ip = {k: m.PrefillInterpolator(raw_data=prefill) for k, m in PKGS.items()}
    idc = {k: m.DecodeInterpolator(raw_data=decode) for k, m in PKGS.items()}
    j, t = "dynamo_tpu", "dynamo_tpu_torch"
    for isl in np.linspace(0, 9000, 37):
        assert ip[t].interpolate_ttft(isl) == ip[j].interpolate_ttft(isl)
        assert ip[t].interpolate_thpt_per_chip(isl) == ip[j].interpolate_thpt_per_chip(isl)
    np.testing.assert_array_equal(idc[t].itl_grid, idc[j].itl_grid)
    np.testing.assert_array_equal(idc[t].thpt_grid, idc[j].thpt_grid)
    assert not np.isnan(idc[t].itl_grid).any()
    for itl in (0.001, 0.006, 0.012, 0.02, 0.05):
        for ctx in (100, 300, 1500, 4096, 9000):
            assert idc[t].find_best_throughput_per_chip(itl, ctx) == \
                idc[j].find_best_throughput_per_chip(itl, ctx)
            assert idc[t].interpolate_itl(8, ctx) == idc[j].interpolate_itl(8, ctx)


class _Counts:
    def __init__(self, p, d):
        self.p, self.d = p, d

    async def count(self):
        return self.p, self.d


class _Seq:
    def __init__(self, metrics, m):
        self.metrics = list(metrics)
        self.m = m

    async def read(self):
        return self.m.Metrics(**self.metrics.pop(0)) if self.metrics else self.m.Metrics()


def _metrics_seq(seed, n=24):
    """Quiet, ramping, bursty and empty intervals."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        if i in (0, 9):
            out.append({})  # no traffic
            continue
        load = 40 + 400 * (i % 12 > 3) * rng.uniform(0.5, 1.5)
        out.append(dict(num_req=float(round(load)), isl=float(rng.integers(200, 3000)),
                        osl=float(rng.integers(50, 400)), ttft=float(rng.uniform(0.05, 1.0)),
                        itl=float(rng.uniform(0.005, 0.05)),
                        request_duration=float(rng.uniform(1, 10))))
    return out


def _decisions(m, seed, **over):
    prefill, decode = _raw(seed)
    args = m.SlaArgs(ttft=0.4, itl=0.02, adjustment_interval=30, max_chip_budget=16,
                     load_predictor="ar", cooldown_intervals=1, max_step=2,
                     scale_down_stable_intervals=2, **over)
    connector = m.NoopMorphConnector() if over.get("morph_enabled") else m.NoopConnector()
    planner = m.Planner(args, m.PrefillInterpolator(raw_data=prefill),
                        m.DecodeInterpolator(raw_data=decode),
                        _Seq(_metrics_seq(seed), m), _Counts(1, 1), connector)

    async def run():
        for _ in range(24):
            await planner.observe_metrics()
            await planner.make_adjustments()

    asyncio.run(run())
    return ([(d.raw, d.target, d.applied, d.reason) for d in planner.decision_log],
            connector.decisions, getattr(connector, "morphs", None),
            (planner.p_correction_factor, planner.d_correction_factor))


@pytest.mark.parametrize("seed,over", [(0, {}), (1, {}), (2, {"workers_per_frontend": 3}),
                                       (3, {"morph_enabled": True})])
def test_scale_decision_sequences_equal(seed, over):
    ref = _decisions(jp, seed, **over)
    port = _decisions(tp, seed, **over)
    assert port == ref
    reasons = {r for _, _, _, r in ref[0]}
    assert "hold:no-traffic" in reasons and len(reasons) >= 3, reasons
    assert any(applied for _, _, applied, _ in ref[0])


def _registry_default(var):
    raw = var.default
    return {"int": int, "float": float,
            "bool": lambda s: s.lower() in ("1", "true", "yes", "on")}[var.type](raw)


FIELDS = {"DYN_PLANNER_SCRAPE_TIMEOUT": "scrape_timeout",
          "DYN_PLANNER_SCRAPE_RETRIES": "scrape_retries",
          "DYN_PLANNER_METRICS_MAX_AGE_S": "metrics_max_age",
          "DYN_PLANNER_COOLDOWN_INTERVALS": "cooldown_intervals",
          "DYN_PLANNER_MAX_STEP": "max_step",
          "DYN_PLANNER_SCALE_DOWN_STABLE_INTERVALS": "scale_down_stable_intervals",
          "DYN_PLANNER_WORKERS_PER_FRONTEND": "workers_per_frontend",
          "DYN_PLANNER_MORPH": "morph_enabled",
          "DYN_PLANNER_MORPH_COST_S": "morph_cost_s",
          "DYN_PLANNER_SPAWN_COST_S": "spawn_cost_s",
          "DYN_PLANNER_COLOCATE": "colocate"}


def test_planner_env_defaults_equal_reference_registry(monkeypatch):
    registry = {v.name: v for v in ENV_REGISTRY if v.name.startswith("DYN_PLANNER_")}
    assert set(registry) == set(FIELDS)
    for name in registry:
        monkeypatch.delenv(name, raising=False)
    args = tp.SlaArgs.from_env()
    for name, var in registry.items():
        assert getattr(args, FIELDS[name]) == _registry_default(var), name
    # set every variable: both packages read the same values
    values = {"DYN_PLANNER_SCRAPE_TIMEOUT": "1.5", "DYN_PLANNER_SCRAPE_RETRIES": "7",
              "DYN_PLANNER_METRICS_MAX_AGE_S": "9", "DYN_PLANNER_COOLDOWN_INTERVALS": "3",
              "DYN_PLANNER_MAX_STEP": "4", "DYN_PLANNER_SCALE_DOWN_STABLE_INTERVALS": "5",
              "DYN_PLANNER_WORKERS_PER_FRONTEND": "6", "DYN_PLANNER_MORPH": "0",
              "DYN_PLANNER_MORPH_COST_S": "2.5", "DYN_PLANNER_SPAWN_COST_S": "45",
              "DYN_PLANNER_COLOCATE": "yes"}
    for k, v in values.items():
        monkeypatch.setenv(k, v)
    t, j = tp.SlaArgs.from_env(itl=0.07), jp.SlaArgs.from_env(itl=0.07)
    assert vars(t) == vars(j)
    assert t.cooldown_intervals == 3 and t.colocate is True and t.morph_enabled is False


def _port_metrics_text():
    """The port frontend's exposition after a few requests."""
    import time

    from dynamo_tpu_torch.llm.http.metrics import HttpMetrics

    m = HttpMetrics()
    rng = np.random.default_rng(5)
    for i in range(12):
        model, ep = ("m", "n")[i % 2], ("chat_completions", "completions")[i % 3 == 0]
        t0 = time.monotonic() - float(rng.uniform(0.5, 3))
        m.request_start(model, ep)
        m.observe_ttft(model, float(rng.uniform(0.01, 2)))
        m.observe_tokens_per_frame(model, int(rng.integers(1, 9)))
        m.request_end(model, ep, t0, error=i == 7, output_tokens=int(rng.integers(2, 64)),
                      input_tokens=int(rng.integers(5, 500)), first_token_at=t0 + 0.1,
                      last_token_at=t0 + 0.4)
    m.client_disconnect("m")
    return m.render().decode()


def test_parse_prometheus_text_equal_on_port_exposition():
    text = _port_metrics_text()
    port, ref = t_parse(text), j_parse(text)
    assert port == ref
    assert ref["dynamo_frontend_requests_total"] == 12.0
    assert ref["dynamo_frontend_time_to_first_token_seconds_count"] == 12.0


def test_frontend_metrics_source_reads_live_port_frontend():
    """A port frontend on loopback (the soak harness's) in front of one
    in-process mock worker: the port's source differences its /metrics
    between reads, and the reference's source reads the same values."""
    from dynamo_tpu_torch.llm.http.client import ClientSession
    from dynamo_tpu_torch.llm.mocker import MockEngineArgs
    from dynamo_tpu_torch.planner.soak import InProcWorkerPool, SoakFrontend, drive_stream

    async def main():
        fe = await SoakFrontend().start()
        pool = InProcWorkerPool(fe.cfg, MockEngineArgs(speedup_ratio=50.0, block_size=8))
        try:
            await pool.set_replicas(0, 1)
            await fe.wait_model("mock-model")
            port_src = tp.FrontendMetricsSource(fe.base_url)
            ref_src = jp.FrontendMetricsSource(fe.metrics_url)
            assert not (await port_src.read()).is_valid()  # nothing to difference yet
            await ref_src.read()
            async with ClientSession() as s:
                recs = await asyncio.gather(*[
                    drive_stream(s, fe.base_url, "mock-model", f"{i} hello planner", 12)
                    for i in range(5)])
            assert all(r.ok and r.content_tokens == 12 for r in recs)
            port_m, ref_m = await port_src.read(), await ref_src.read()
            assert port_m.is_valid() and port_m.num_req == 5.0 and port_m.osl == 12.0
            assert math.isfinite(port_m.ttft) and math.isfinite(port_m.itl)
            assert vars(port_m) == vars(ref_m)
            quiet = await port_src.read()
            assert not quiet.is_valid() and quiet.num_req == 0.0
        finally:
            await pool.shutdown()
            await fe.stop()

    asyncio.run(main())


def test_discovery_worker_counts_count_workers_not_endpoints():
    """A prefill or decode worker registers `generate` and `morph` under
    one instance id: the port counts it once (the reference counts each
    record); draining and morphing instances count in neither role, and a
    one-endpoint worker counts the same in both packages."""
    import json

    from dynamo_tpu.planner.connector import DiscoveryWorkerCounts as JCounts
    from dynamo_tpu_torch.planner.connector import DiscoveryWorkerCounts as TCounts

    def rec(comp, ep, iid, state="ready"):
        return {"key": f"v1/instances/dynamo/{comp}/{ep}/{iid:x}",
                "value": json.dumps({"state": state}).encode()}

    class Kv:
        def __init__(self, items):
            self.items = items

        async def get_prefix(self, prefix):
            return [it for it in self.items if it["key"].startswith(prefix)]

    workers = [rec("prefill", "generate", 1), rec("prefill", "morph", 1),
               rec("backend", "generate", 2), rec("backend", "morph", 2),
               rec("backend", "generate", 3), rec("backend", "generate", 4, "draining"),
               rec("mocker", "generate", 5), rec("backend", "morph", 6, "morphing")]

    async def main():
        port = TCounts(Kv(workers))
        ref = JCounts(Kv(workers))
        assert await port.count() == (1, 2)
        assert await ref.count() == (2, 3)  # generate + morph records both count there
        assert await port.ready_fn()("decode") == 2
        one = [rec("mocker", "generate", 5), rec("mocker", "generate", 7)]
        assert await TCounts(Kv(one), decode_component="mocker").count() == \
            await JCounts(Kv(one), decode_component="mocker").count() == (0, 2)

    asyncio.run(main())
