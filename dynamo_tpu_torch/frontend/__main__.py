"""OpenAI frontend: `python -m dynamo_tpu_torch.frontend`.

Port of `dynamo_tpu/frontend/__main__.py`: the same flags, routes and
drain, on the standard library (plus jinja2 for chat templates). It does no
device work and never touches CUDA: it shares the card with its workers.
KServe gRPC (`--grpc-port` other than 0) is refused: the port has no
`grpc`/`protobuf`.

Mirrors reference components/frontend (main.py) + lib/llm entrypoint
(input.rs:109 run_input / http.rs): starts (or embeds) the discovery
service, watches model cards, serves the OpenAI HTTP API with the chosen
router mode.
"""

import argparse
import asyncio
import logging
import os

from dynamo_tpu_torch.llm.discovery import ModelManager, ModelWatcher
from dynamo_tpu_torch.llm.http import HttpService
from dynamo_tpu_torch.runtime import (
    DistributedRuntime,
    RouterMode,
    RuntimeConfig,
    init_logging,
)

logger = logging.getLogger("dynamo_tpu_torch.frontend")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="dynamo-tpu OpenAI frontend (PyTorch/CUDA port)")
    ap.add_argument("--http-host", default="0.0.0.0")
    ap.add_argument("--http-port", type=int, default=8000)
    ap.add_argument("--grpc-port", type=int, default=0,
                    help="KServe gRPC port (0 = disabled; reference "
                    "lib/llm/src/grpc/service/kserve.rs)")
    ap.add_argument(
        "--router-mode",
        choices=["round-robin", "random", "kv"],
        default="round-robin",
    )
    ap.add_argument("--discovery", default=None, help="tcp://host:port of discovery")
    ap.add_argument("--encoder", default=None,
                    help="multimodal encode worker endpoint "
                    "('component' | 'ns/component' | 'ns/component/endpoint'): "
                    "adds the E/P/D encode hop to every model pipeline")
    ap.add_argument(
        "--embed-discovery",
        action="store_true",
        help="host the discovery service inside this process",
    )
    ap.add_argument("--kv-overlap-score-weight", type=float, default=1.0)
    ap.add_argument("--router-temperature", type=float, default=0.0)
    ap.add_argument("--router-replica-sync", "--mirror-routing",
                    action="store_true",
                    help="mirror routing decisions between KV-mode frontends "
                    "sharing discovery, so replica fleets keep one view of "
                    "active blocks / in-flight prefixes (reference "
                    "kv_router/subscriber.rs; docs/frontend_scaleout.md)")
    args = ap.parse_args(argv)
    if args.grpc_port:
        from dynamo_tpu_torch.engine.config import UnsupportedConfigError

        raise UnsupportedConfigError(
            f"--grpc-port {args.grpc_port}: the KServe gRPC service is not ported "
            "(the port has no grpc/protobuf); serve OpenAI HTTP with --http-port"
        )
    # frontend replicas are stateless over shared discovery: the planner /
    # operator-lite scales them with ONE argv template, so each replica
    # offsets its listen ports by its index (DYN_WORKER_INDEX, the same
    # contract workers use; docs/frontend_scaleout.md)
    index = int(os.environ.get("DYN_WORKER_INDEX") or 0)
    if index:
        if args.http_port:
            args.http_port += index
    return args


async def main():
    init_logging()
    args = parse_args()
    cfg = RuntimeConfig.from_settings()
    if args.discovery:
        cfg.discovery_endpoint = args.discovery
    drt = await DistributedRuntime.create(cfg, embed_discovery=args.embed_discovery)
    # SIGTERM walks the graceful drain, not a hard exit mid-stream
    drt.install_signal_handlers()

    manager = ModelManager()
    router_mode = RouterMode(args.router_mode)

    # dynogate admission control (gate/, docs/overload.md): DYN_GATE=0
    # compiles the whole overload discipline out of this process
    gate = None
    from dynamo_tpu_torch.gate import AdmissionGate, GateConfig

    gate_cfg = GateConfig.from_env()
    if gate_cfg.enabled:
        gate = AdmissionGate(drt, gate_cfg)
        await gate.start()
        logger.info(
            "admission gate active (ttft=%.0fms headroom=%.1fx watermark=%d)",
            gate_cfg.ttft_ms, gate_cfg.ttft_headroom, gate_cfg.queue_watermark,
        )

    kv_router_factory = None
    if router_mode == RouterMode.KV:
        from dynamo_tpu_torch.llm.kv_router import KvRouterConfig, make_kv_router_factory

        kv_router_factory = make_kv_router_factory(
            KvRouterConfig(
                overlap_score_weight=args.kv_overlap_score_weight,
                router_temperature=args.router_temperature,
                replica_sync=args.router_replica_sync,
            )
        )

    watcher = ModelWatcher(
        drt, manager, router_mode, kv_router_factory, encoder=args.encoder,
        gate=gate,
    )
    await watcher.start()

    service = HttpService(
        manager, host=args.http_host, port=args.http_port, gate=gate
    )
    await service.start()
    logger.info("frontend ready on :%d (router=%s)", service.port, router_mode.value)
    await drt.wait_for_shutdown()
    if gate is not None:
        await gate.close()  # parked admissions resolve before the drain
    await drt.close()  # graceful drain (runtime/component.py close())


if __name__ == "__main__":
    asyncio.run(main())
