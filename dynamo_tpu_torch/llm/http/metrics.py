"""HTTP frontend Prometheus metrics.

Port of `dynamo_tpu/llm/http/metrics.py` on the port's
`runtime/metrics.py` in place of `prometheus_client`: the same metric
names, labels and buckets, rendered in the Prometheus text format with the
sample names prometheus_client writes (`_total` on counters; `_bucket`,
`_count` and `_sum` on histograms). The `_created` samples are left out.

Mirrors reference lib/llm/src/http/service/metrics.rs: request counters,
in-flight gauge, duration + TTFT + output-token histograms, disconnects —
labeled by model and endpoint type, exported at /metrics.
"""

from __future__ import annotations

import time

from ...runtime.metrics import CollectorRegistry


class HttpMetrics:
    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        ns = "dynamo_frontend"
        self.requests_total = self.registry.counter(
            f"{ns}_requests_total",
            "Total HTTP LLM requests",
            ["model", "endpoint", "status"],
        )
        self.inflight = self.registry.gauge(
            f"{ns}_inflight_requests",
            "Requests currently being processed",
            ["model", "endpoint"],
        )
        self.request_duration = self.registry.histogram(
            f"{ns}_request_duration_seconds",
            "End-to-end request duration",
            ["model", "endpoint"],
            buckets=(0.05, 0.1, 0.25, 0.5, 1, 2, 4, 8, 16, 32, 64, 128),
        )
        self.ttft = self.registry.histogram(
            f"{ns}_time_to_first_token_seconds",
            "Time to first token",
            ["model"],
            buckets=(0.01, 0.025, 0.05, 0.1, 0.2, 0.4, 0.8, 1.6, 3.2, 6.4, 12.8),
        )
        self.output_tokens = self.registry.counter(
            f"{ns}_output_tokens_total",
            "Total generated tokens",
            ["model"],
        )
        self.input_tokens = self.registry.counter(
            f"{ns}_input_tokens_total",
            "Total prompt tokens",
            ["model"],
        )
        self.itl = self.registry.histogram(
            f"{ns}_inter_token_latency_seconds",
            "Mean inter-token latency per request",
            ["model"],
            buckets=(0.002, 0.005, 0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64, 1.28),
        )
        self.disconnects = self.registry.counter(
            f"{ns}_client_disconnects_total",
            "Client disconnects mid-stream",
            ["model"],
        )
        # token-path batching visibility: tokens per streamed delta batch
        # (= per SSE event). Mean > 1 in steady decode means the batched
        # emit/coalesce path is active end-to-end; mean == 1 flags a
        # serving plane paying per-token overhead again.
        self.tokens_per_frame = self.registry.histogram(
            f"{ns}_tokens_per_frame",
            "Generated tokens carried by each streamed delta batch",
            ["model"],
            buckets=(1, 2, 4, 8, 16, 32, 64, 128),
        )

    def request_start(self, model: str, endpoint: str):
        self.inflight.labels(model, endpoint).inc()

    def request_end(
        self,
        model: str,
        endpoint: str,
        t0: float,
        error: bool = False,
        output_tokens: int = 0,
        input_tokens: int = 0,
        first_token_at: float | None = None,
        last_token_at: float | None = None,
    ):
        self.inflight.labels(model, endpoint).dec()
        self.requests_total.labels(model, endpoint, "error" if error else "success").inc()
        now = time.monotonic()
        self.request_duration.labels(model, endpoint).observe(now - t0)
        if output_tokens:
            self.output_tokens.labels(model).inc(output_tokens)
        if input_tokens:
            self.input_tokens.labels(model).inc(input_tokens)
        # ITL over first→last token, not request end (post-stream work such
        # as [DONE]/usage frames must not inflate the planner's signal)
        if first_token_at is not None and last_token_at is not None and output_tokens > 1:
            self.itl.labels(model).observe(
                max(last_token_at - first_token_at, 0.0) / (output_tokens - 1)
            )

    def observe_ttft(self, model: str, seconds: float):
        self.ttft.labels(model).observe(seconds)

    def observe_tokens_per_frame(self, model: str, n_tokens: int):
        self.tokens_per_frame.labels(model).observe(n_tokens)

    def client_disconnect(self, model: str):
        self.disconnects.labels(model).inc()

    def render(self) -> bytes:
        return self.registry.render()
