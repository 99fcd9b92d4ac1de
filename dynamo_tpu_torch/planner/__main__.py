"""`python -m dynamo_tpu_torch.planner` — run the SLA planner against a frontend.

Port of `dynamo_tpu/planner/__main__.py`, with its flags.

Reference CLI shape: components/planner/src/dynamo/planner/planner_sla.py
(+ planner_argparse.py). Scales via the virtual connector (decision in
discovery KV) or local worker subprocesses.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import shlex

logger = logging.getLogger(__name__)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="SLA planner")
    ap.add_argument("--frontend-url", default="http://127.0.0.1:8080")
    ap.add_argument("--profile-results-dir", required=True)
    ap.add_argument("--ttft", type=float, default=0.5, help="TTFT SLA seconds")
    ap.add_argument("--itl", type=float, default=0.05, help="ITL SLA seconds")
    ap.add_argument("--adjustment-interval", type=float, default=60.0)
    ap.add_argument("--prefill-engine-num-chips", type=int, default=1)
    ap.add_argument("--decode-engine-num-chips", type=int, default=1)
    ap.add_argument("--max-chip-budget", type=int, default=64)
    ap.add_argument("--min-endpoint", type=int, default=1)
    ap.add_argument(
        "--load-predictor", default="constant",
        choices=["constant", "moving-average", "ar", "arima", "prophet"],
    )
    ap.add_argument("--no-operation", action="store_true",
                    help="log decisions without scaling")
    ap.add_argument(
        "--connector", default="virtual", choices=["virtual", "local", "noop"]
    )
    ap.add_argument("--prefill-cmd", default="", help="argv for a prefill worker (local connector)")
    ap.add_argument("--decode-cmd", default="", help="argv for a decode worker (local connector)")
    ap.add_argument("--frontend-cmd", default="",
                    help="argv for a frontend replica (local connector); "
                    "each replica's DYN_WORKER_INDEX offsets its ports "
                    "(docs/frontend_scaleout.md)")
    ap.add_argument("--workers-per-frontend", type=int, default=None,
                    help="size the frontend tier to ceil(workers / N) "
                    "replicas alongside every applied worker target "
                    "(default: DYN_PLANNER_WORKERS_PER_FRONTEND; 0 = "
                    "frontends not planner-managed)")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--prefill-component", default="prefill",
                    help="discovery component name counted as prefill capacity")
    ap.add_argument("--decode-component", default="backend",
                    help="discovery component name counted as decode capacity "
                    "(mocker workers default to 'mocker')")
    ap.add_argument("--log-level", default="INFO")
    return ap.parse_args(argv)


async def amain(args: argparse.Namespace) -> None:
    from ..runtime.config import discovery_address
    from ..runtime.discovery import DiscoveryClient
    from .connector import (
        DiscoveryWorkerCounts,
        LocalProcessConnector,
        NoopConnector,
        VirtualConnector,
    )
    from .metrics_source import FrontendMetricsSource
    from .perf_interpolation import DecodeInterpolator, PrefillInterpolator
    from .planner_core import Planner, SlaArgs

    host, port = discovery_address()
    # NB: connect is a classmethod factory — `DiscoveryClient(host, port)`
    # followed by an instance .connect() was a TypeError waiting for the
    # first real deployment of this entrypoint
    disc = await DiscoveryClient.connect(host, port)

    counts = DiscoveryWorkerCounts(
        disc, namespace=args.namespace,
        prefill_component=args.prefill_component,
        decode_component=args.decode_component,
    )
    if args.no_operation or args.connector == "noop":
        connector = NoopConnector()
    elif args.connector == "local":
        connector = LocalProcessConnector(
            shlex.split(args.prefill_cmd), shlex.split(args.decode_cmd),
            ready_fn=counts.ready_fn(),
            frontend_cmd=shlex.split(args.frontend_cmd),
        )
    else:
        connector = VirtualConnector(disc)

    planner = Planner(
        SlaArgs.from_env(
            ttft=args.ttft,
            itl=args.itl,
            adjustment_interval=args.adjustment_interval,
            prefill_engine_num_chips=args.prefill_engine_num_chips,
            decode_engine_num_chips=args.decode_engine_num_chips,
            max_chip_budget=args.max_chip_budget,
            min_endpoint=args.min_endpoint,
            load_predictor=args.load_predictor,
            **({"workers_per_frontend": args.workers_per_frontend}
               if args.workers_per_frontend is not None else {}),
        ),
        PrefillInterpolator(profile_results_dir=args.profile_results_dir),
        DecodeInterpolator(profile_results_dir=args.profile_results_dir),
        FrontendMetricsSource(args.frontend_url),
        counts,
        connector,
    )
    # SIGTERM/SIGINT stop the loop cleanly so the finally below actually
    # runs — the interpreter's default SIGTERM exit would orphan every
    # connector-managed worker subprocess
    import signal

    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, planner.stop)
        except (NotImplementedError, RuntimeError):
            break
    try:
        await planner.run()
    finally:
        # shielded: a cancellation (Ctrl-C) landing mid-close must not
        # abandon the teardown. Connector-managed children die with the
        # planner (SIGTERM → their own graceful drain) — otherwise a
        # planner restart would spawn a duplicate fleet beside orphans.
        async def _teardown():
            shutdown = getattr(connector, "shutdown", None)
            if shutdown is not None:
                try:
                    await shutdown()
                except Exception:  # noqa: BLE001 — teardown is best-effort
                    logger.exception("connector shutdown failed")
            await disc.close()

        await asyncio.shield(_teardown())


def main(argv=None) -> None:
    args = parse_args(argv)
    logging.basicConfig(
        level=args.log_level.upper(),
        format="%(asctime)s %(levelname)s %(name)s %(message)s",
    )
    try:
        asyncio.run(amain(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
