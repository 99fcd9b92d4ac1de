"""Frontend metrics scraper for the planner.

Port of `dynamo_tpu/planner/metrics_source.py`, in the role of the reference's Prometheus client
(components/planner/src/dynamo/planner/utils/prometheus.py): supplies the
planner's per-interval averages. The reference queries a Prometheus server
with `avg_over_time`; here we scrape the frontend's /metrics endpoint and
difference counter/histogram samples between consecutive scrapes — the
same interval averages without a Prometheus deployment in the loop. The
scrape is one HTTP/1.1 GET on asyncio streams (`llm/http/client.py`): the
card's machine has no aiohttp.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

from ..llm.http.client import ClientSession
from ..runtime import faults
from .planner_core import Metrics

_NS = "dynamo_frontend"


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Sum samples per metric name (labels aggregated away — the planner
    sizes the whole deployment, not one model)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            name_part, value = line.rsplit(None, 1)
        except ValueError:
            continue
        name = name_part.split("{", 1)[0]
        try:
            out[name] = out.get(name, 0.0) + float(value)
        except ValueError:
            continue
    return out


class FrontendMetricsSource:
    """Scrapes /metrics and returns deltas between consecutive reads."""

    def __init__(self, url: str):
        self.url = url if url.endswith("/metrics") else url.rstrip("/") + "/metrics"
        self._prev: Optional[Dict[str, float]] = None

    async def _scrape(self) -> Dict[str, float]:
        f = faults.FAULTS
        if f.enabled:
            # `error` raises FaultError, `hang` parks until the planner's
            # per-attempt timeout cuts it, `delay` slows the scrape — all
            # land on the retry/staleness path the planner must survive
            await f.on("planner.scrape")
        async with ClientSession() as s:
            async with s.get(self.url) as resp:
                resp.raise_for_status()
                return parse_prometheus_text(await resp.text())

    @staticmethod
    def _delta(cur: Dict[str, float], prev: Dict[str, float], name: str) -> float:
        return cur.get(name, 0.0) - prev.get(name, 0.0)

    @staticmethod
    def _avg(cur, prev, sum_name: str, count_name: str) -> float:
        dc = cur.get(count_name, 0.0) - prev.get(count_name, 0.0)
        if dc <= 0:
            return math.nan
        return (cur.get(sum_name, 0.0) - prev.get(sum_name, 0.0)) / dc

    async def read(self) -> Metrics:
        cur = await self._scrape()
        prev = self._prev
        self._prev = cur
        if prev is None:
            return Metrics()  # first scrape: no interval to difference yet

    # counter names per llm/http/metrics.py
        num_req = self._delta(cur, prev, f"{_NS}_requests_total")
        out_tok = self._delta(cur, prev, f"{_NS}_output_tokens_total")
        in_tok = self._delta(cur, prev, f"{_NS}_input_tokens_total")
        return Metrics(
            num_req=num_req,
            isl=in_tok / num_req if num_req > 0 else math.nan,
            osl=out_tok / num_req if num_req > 0 else math.nan,
            ttft=self._avg(
                cur, prev,
                f"{_NS}_time_to_first_token_seconds_sum",
                f"{_NS}_time_to_first_token_seconds_count",
            ),
            itl=self._avg(
                cur, prev,
                f"{_NS}_inter_token_latency_seconds_sum",
                f"{_NS}_inter_token_latency_seconds_count",
            ),
            request_duration=self._avg(
                cur, prev,
                f"{_NS}_request_duration_seconds_sum",
                f"{_NS}_request_duration_seconds_count",
            ),
        )
