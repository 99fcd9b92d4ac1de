"""Mocker worker: `python -m dynamo_tpu_torch.mocker` — a fake engine worker.

Port of `dynamo_tpu/mocker/__main__.py`, with its flags. Mirrors reference
components/backends/mocker (main.py): registers a model card + generate
endpoint backed by the block-accounting MockEngine, so multi-worker
routing/disagg/migration and the planner can run without a card. It
registers on the port's discovery and request plane, with the KV event and
worker metrics publishers.
"""

import argparse
import asyncio
import logging

from dynamo_tpu_torch.llm.mocker import MockEngine, MockEngineArgs
from dynamo_tpu_torch.llm.model_card import ModelDeploymentCard, register_llm
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig, init_logging

logger = logging.getLogger("dynamo_tpu_torch.mocker")


def parse_args():
    ap = argparse.ArgumentParser(description="dynamo-tpu mocker worker (PyTorch port)")
    ap.add_argument("--model-name", default="mock-model")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="mocker")
    ap.add_argument("--endpoint", default="generate")
    ap.add_argument("--discovery", default=None, help="tcp://host:port of discovery")
    ap.add_argument("--block-size", type=int, default=64)
    ap.add_argument("--num-gpu-blocks", type=int, default=4096)
    ap.add_argument("--max-num-seqs", type=int, default=256)
    ap.add_argument("--max-num-batched-tokens", type=int, default=8192)
    ap.add_argument("--speedup-ratio", type=float, default=10.0)
    ap.add_argument("--no-prefix-caching", action="store_true")
    ap.add_argument("--migration-limit", type=int, default=3)
    ap.add_argument("--kv-events", action="store_true", help="publish KV events")
    ap.add_argument("--warmup-delay", type=float, default=0.0,
                    help="extra seconds of simulated compile time during "
                    "warmup (ordering tests observe the pre-registration "
                    "window with this)")
    return ap.parse_args()


async def main():
    init_logging()
    args = parse_args()
    cfg = RuntimeConfig.from_settings()
    if args.discovery:
        cfg.discovery_endpoint = args.discovery
    drt = await DistributedRuntime.create(cfg)
    # SIGTERM (planner scale-down) must walk the graceful drain, not the
    # interpreter's default hard exit that kills in-flight streams
    drt.install_signal_handlers()

    engine_args = MockEngineArgs(
        model_name=args.model_name,
        num_gpu_blocks=args.num_gpu_blocks,
        block_size=args.block_size,
        max_num_seqs=args.max_num_seqs,
        max_num_batched_tokens=args.max_num_batched_tokens,
        enable_prefix_caching=not args.no_prefix_caching,
        speedup_ratio=args.speedup_ratio,
    )

    endpoint = (
        drt.namespace(args.namespace).component(args.component).endpoint(args.endpoint)
    )

    publisher = None
    if args.kv_events:
        from dynamo_tpu_torch.llm.kv_router.publisher import KvEventPublisher

        publisher = KvEventPublisher(drt, endpoint, drt.instance_id)
        await publisher.start()

    engine = MockEngine(engine_args)

    # warmup BEFORE anything is registered in discovery: the worker must
    # not be routable until first-iteration costs are paid (same contract
    # as the worker's --warmup flow; the KV-event sink attaches after so
    # warmup prefixes never pollute the router index)
    n_warm = await engine.warmup(extra_delay=args.warmup_delay)
    logger.info("mocker warmup done: %d requests", n_warm)
    if publisher is not None:
        engine.kv.event_sink = publisher.publish

    from dynamo_tpu_torch.llm.kv_router.publisher import WorkerMetricsPublisher

    metrics_pub = WorkerMetricsPublisher(drt, endpoint, drt.instance_id, engine.stats)
    await metrics_pub.start()

    card = ModelDeploymentCard(
        name=args.model_name,
        tokenizer="byte",
        kv_cache_block_size=args.block_size,
        migration_limit=args.migration_limit,
    )

    # metrics publishing for the KV router's scheduler
    async def stats_loop():
        while True:
            stats = drt.server.stats(endpoint.subject)
            if stats is not None:
                stats.data = engine.stats()
            await asyncio.sleep(0.5)

    stats_task = asyncio.create_task(stats_loop())

    async def handler(request, context):
        if request.get("embed"):
            # deterministic fake embedding (hash-seeded) so the embeddings
            # path is testable without a real embedding model
            import hashlib

            token_ids = request.get("token_ids") or []
            h = hashlib.sha256(bytes(str(token_ids), "utf-8")).digest()
            dim = 32
            vec = [((h[i % len(h)] / 255.0) * 2 - 1) for i in range(dim)]
            yield {"embedding": vec, "finish_reason": "stop"}
            return
        # nvext annotation support: announce which worker serves the request
        # (reference annotations e.g. worker_id / kv_hit_rate)
        if "worker_instance_id" in (request.get("annotations") or []):
            yield {
                "event": "worker_instance_id",
                "comment": [f"{drt.instance_id:x}"],
            }
        if "kv_hit_rate" in (request.get("annotations") or []):
            hit = request.get("estimated_prefix_hit_num_blocks") or 0
            yield {"event": "kv_hit_rate", "comment": [str(hit)]}
        async for item in engine.generate(request, context):
            yield item

    # instance first, card second: frontends build a model pipeline the
    # moment the CARD appears, so the instance must already be live when
    # they look — the reverse order opens a routable-but-absent window
    # (StreamLost storms on cold start)
    await endpoint.serve_endpoint(handler)
    await register_llm(endpoint, card)
    logger.info("mocker worker up: model=%s instance=%x", args.model_name, drt.instance_id)
    await drt.wait_for_shutdown()
    stats_task.cancel()
    await drt.close()  # graceful drain (runtime/component.py close())


if __name__ == "__main__":
    asyncio.run(main())
