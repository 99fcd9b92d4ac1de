"""PyTorch/CUDA engine worker: `python -m dynamo_tpu_torch.worker`.

Port of `dynamo_tpu/jax_worker/__main__.py`: build the engine, warm it up
BEFORE joining the control plane, start the KV data plane (prefill and
aggregated roles), create the `DistributedRuntime`, publish KV events
(`--kv-events`) and engine load metrics, serve `generate`, register the
model card (not on prefill workers: the prefill pool is reached through
decode workers only), then wait for SIGTERM/SIGINT and drain gracefully.
It registers on the same discovery service and speaks the same frames —
the KV data plane's too — as a JAX worker, so the unmodified
`python -m dynamo_tpu.frontend` routes to it and a JAX worker can stand
on the other side of a prefill/decode handoff.

Roles: `aggregated` (default) serves whole requests; `--role prefill`
serves under `--prefill-component` and answers disaggregated prefills
(`disagg_params`) with a data-plane descriptor; `--role decode` serves
under `--component`, and sends prompts with more than
`--disagg-threshold` uncached tokens to the prefill pool
(`worker/disagg_handler.py`), watching its published queue depth.

KVBM: `--kvbm-host-blocks N` keeps a host tier of N blocks (one page of
every layer, K and V) in pinned memory, `--kvbm-disk-blocks N
--kvbm-disk-path DIR` a disk tier below it; committed blocks are written
through, and admission onboards what the device cache lost. A worker with
tiers joins the announcement mesh (`kvbm/distributed.py`) on its KV data
plane — a decode-role worker opens one for it — so workers pull each
other's tiered blocks (G4). `DYN_KV_CHECKPOINT=N` turns on session
checkpoints: the worker's committed blocks (N staged at most) are
replicated into its ring successor's host tier, so a stream whose worker
dies resumes on a survivor from the replica and re-prefills only a tail.
With `DYN_SYSTEM_PORT` the runtime serves
/health, /live and /metrics (the engine's stats as `dynamo_worker_*`
gauges, the `kvbm_*` ones included); with `DYN_HEALTH_CHECK_ENABLED` an
idle `generate` endpoint gets a one-token canary request.

Role morphing: a prefill or decode worker also serves a `morph` endpoint
beside `generate`. `{"target_role": "prefill"|"decode"}` re-roles the live
worker: both lanes go `morphing`, the engine severs the streams of the role
that goes away (their callers migrate them), `generate` and `morph` move to
the new role's component (born `morphing`), the metrics and KV-event
publishers follow, the model card is dropped or registered, the engine
re-warms, and the lanes go `ready`. A failed morph restores the old lanes;
`DYN_MORPH_DRAIN_TIMEOUT_S` (default 10) bounds the wait for the severed
streams. An aggregated worker answers with a typed error.

Speculative decoding: `--spec ngram` drafts `--spec-draft-len` tokens a
round from the most recent `--spec-ngram`-gram of each stream and verifies
them in one pass, `--spec-rounds` rounds a decode block (engine/spec.py);
penalties and logprobs are then refused. Guided requests (`response_format`
json_object / json_schema, nvext `guided_choice` / `guided_regex` /
`guided_json`) are served against the tokenizer the model card advertises.

LoRA: `--lora NAME=PATH` (repeatable) serves an HF PEFT export directory
as adapter NAME, `--lora NAME=random:SEED` a random adapter drawn from the
seed; a request selects one with `lora_name` (`nvext.lora_name` at the
frontend), and the model card lists them. `DYN_LORA_POOL_SLOTS` (default 8)
device slots hold the resident adapters; a larger roster pages on demand.

Flags keep the reference's names. Those whose feature the port lacks
(parallelism, multi-host) raise
`UnsupportedConfigError` when set. `--device` (default `cuda`) picks the card; with no CUDA device
the worker raises instead of running on the CPU, unless `--device cpu`
asks for it.

Weights: `--model-path` loads a checkpoint (models/loader.py): an HF
safetensors directory (one file or index-sharded; an `org/name` repo id
resolves through the local HF hub cache only, never a download), a .gguf
file, or a directory holding one. A GGUF's own metadata gives the model's
shape and its embedded vocabulary is the served tokenizer
(`gguf:<path>` on the model card); otherwise `--model` names the shape.
An HF directory's config.json may give a smaller depth than `--model`'s
(its first `num_hidden_layers` layers; the widths must agree). Without
`--model-path` the weights are random, drawn from `--seed`.
`--quantize int8` stores projections, embedding and head as int8 with
per-channel scales (an MoE model's expert stacks too, one (layer, expert)
matrix at a time; its router stays f32). The KV pool is auto-sized after
the weights are resident, so int8 weights leave room for more pages. The
MoE models (`--model tiny-moe|mixtral-8x7b|gptoss-120b`, or a Mixtral-
named HF checkpoint / an MoE .gguf under `--model-path`) serve on one
device; `--ep-size` stays refused, and `--lora` on an MoE model fails.

    python -m dynamo_tpu_torch.worker --model llama3-3b --discovery tcp://HOST:PORT
    python -m dynamo_tpu_torch.worker --model llama3-3b --model-path DIR --quantize int8
    python -m dynamo_tpu_torch.worker --model-path FILE.gguf
    python -m dynamo_tpu_torch.worker --model mixtral-8x7b --quantize int8
    python -m dynamo_tpu_torch.worker --model llama3-3b --lora sql=/adapters/sql --lora demo=random:3
    DYN_SYSTEM_PORT=9100 python -m dynamo_tpu_torch.worker --model llama3-3b \
        --kvbm-host-blocks 256 --kvbm-disk-blocks 512 --kvbm-disk-path /var/kvbm
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..engine import EngineConfig, TorchEngine, UnsupportedConfigError
from ..llm.disagg import DisaggConfig, DisaggregatedRouter
from ..llm.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from ..llm.kv_transfer import KvDataPlaneServer
from ..engine.engine import _resolve_model
from ..llm.model_card import ModelDeploymentCard, card_tokenizer, register_llm
from ..llm.tokenizers import load_tokenizer
from ..models.loader import (_find_gguf, config_from_gguf, depth_from_hf, load_llama_params,
                             load_moe_params)
from ..models.moe import MoeConfig
from ..models.quant import param_bytes
from ..runtime import DistributedRuntime, RuntimeConfig, init_logging
from ..runtime.component import STATE_MORPHING, STATE_READY, Endpoint, ServedEndpoint
from ..runtime.metrics import worker_exported_stats
from .disagg_handler import maybe_remote_prefill

logger = logging.getLogger("dynamo_tpu_torch.worker")

# the health canary: a one-token request through the whole engine
CANARY = {"token_ids": [1, 2, 3, 4], "stop_conditions": {"max_tokens": 1, "ignore_eos": True}}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="dynamo-tpu PyTorch/CUDA engine worker")
    ap.add_argument("--model", default="tiny", help="model registry key (tiny/llama3-3b/llama3-8b/llama3-70b, "
                         "MoE: tiny-moe/mixtral-8x7b/gptoss-120b)")
    ap.add_argument("--model-name", default=None, help="served model name (defaults to --model)")
    ap.add_argument("--model-path", default=None,
                    help="HF safetensors checkpoint dir (or cached repo id), a .gguf file, or a "
                    "directory holding one; omitted = random weights from --seed")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default="cuda",
                    help="torch device; cuda raises when no CUDA device is present")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="backend")
    ap.add_argument("--endpoint", default="generate")
    ap.add_argument("--discovery", default=None)
    ap.add_argument("--page-size", type=int, default=64)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="KV page pool; 0 = auto-size from free device memory "
                    "(DYN_HBM_UTILIZATION; CPU falls back to a fixed 2048)")
    ap.add_argument("--max-num-seqs", type=int, default=64)
    ap.add_argument("--max-model-len", type=int, default=8192)
    ap.add_argument("--decode-pool-mode", choices=["scatter", "local"], default=None,
                    help="KV-write strategy in the fused decode block (default scatter)")
    ap.add_argument("--decode-block-unroll", type=int, default=0,
                    help="accepted for the reference's sake; no effect here")
    ap.add_argument("--lora", action="append", default=[], metavar="NAME=PATH",
                    help="serve a LoRA adapter (HF PEFT export dir); repeatable. "
                    "NAME=random:<seed> makes a random adapter (tests/demos). "
                    "Select per request via nvext.lora_name.")
    ap.add_argument("--spec", choices=["ngram"], default=None,
                    help="speculative decoding: self-drafting n-gram prompt lookup "
                    "verified in one pass (engine/spec.py)")
    ap.add_argument("--spec-draft-len", type=int, default=4)
    ap.add_argument("--spec-ngram", type=int, default=2)
    ap.add_argument("--spec-rounds", type=int, default=4)
    ap.add_argument("--kv-quant", choices=["none", "int8", "int4"], default=None,
                    help="quantized KV cache page format (default: DYN_KV_QUANT, none)")
    ap.add_argument("--quantize", choices=["int8"], default=None,
                    help="int8 weight-only quantization (per-channel f32 scales)")
    ap.add_argument("--tp-size", type=int, default=1)
    ap.add_argument("--ep-size", type=int, default=1)
    ap.add_argument("--pp-size", type=int, default=1)
    ap.add_argument("--sp-size", type=int, default=1)
    ap.add_argument("--ring-prefill-threshold", type=int, default=512)
    ap.add_argument("--dp-attention", action="store_true")
    ap.add_argument("--kv-events", action="store_true")
    ap.add_argument("--kvbm-host-blocks", type=int, default=0)
    ap.add_argument("--kvbm-disk-blocks", type=int, default=0)
    ap.add_argument("--kvbm-disk-path", default=None)
    ap.add_argument("--migration-limit", type=int, default=3)
    ap.add_argument("--sched-policy", choices=["fifo", "sla"], default=None)
    ap.add_argument("--ttft-target-ms", type=float, default=None)
    ap.add_argument("--itl-target-ms", type=float, default=None)
    ap.add_argument("--warmup", choices=["auto", "full", "none"], default="auto",
                    help="drive every dispatch kind (and build the kernels) before "
                    "joining the control plane (auto: on for CUDA, off on the CPU)")
    ap.add_argument("--context-length", type=int, default=None)
    ap.add_argument("--role", choices=["aggregated", "prefill", "decode"], default="aggregated")
    ap.add_argument("--prefill-component", default="prefill")
    ap.add_argument("--disagg-threshold", type=int, default=64)
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--spmd-port", type=int, default=17300)
    ap.add_argument("--kv-data-plane-port", type=int, default=0,
                    help="port of the KV data plane (prefill/aggregated roles; 0 = any)")
    ap.add_argument("--kv-data-plane-host", default=None,
                    help="host the data plane advertises (default: the routable address)")
    ap.add_argument("--no-kv-data-plane", action="store_true",
                    help="answer disaggregated prefills with the KV inline")
    return ap.parse_args(argv)


def unsupported_flags(args) -> list:
    """The flags set to a value the port cannot honour."""
    bad = [f"--{n.replace('_', '-')}" for n in ("tp_size", "ep_size", "pp_size", "sp_size",
                                               "num_hosts") if getattr(args, n) > 1]
    bad += [f"--{n.replace('_', '-')}" for n in (
        "dp_attention", "host_id", "coordinator") if getattr(args, n)]
    return bad


def register_lora_flags(engine: TorchEngine, specs) -> None:
    """Register the `--lora NAME=PATH|random:SEED` adapters on `engine`."""
    if not specs:
        return
    from ..models import lora as lora_mod

    adapters = []
    for spec in specs:
        name, _, src = spec.partition("=")
        if not src:
            raise SystemExit(f"--lora expects NAME=PATH, got {spec!r}")
        if src.startswith("random:"):
            gen = torch.Generator().manual_seed(int(src.split(":", 1)[1]))
            adapters.append(lora_mod.init_adapter(engine.model_config, name, gen))
        else:
            adapters.append(lora_mod.load_peft_adapter(src, engine.model_config, name=name))
    engine.register_adapters(adapters)
    logger.info("LoRA adapters registered: %s", engine.lora_names())


def build_engine(args) -> TorchEngine:
    """The engine the flags describe: weights from `--model-path`, else
    random from `--seed`; its tokenizer is the one the card advertises."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda needs a CUDA device and none is present; pass "
            "--device cpu to run on the CPU"
        )
    params = model_config = None
    gguf_path = gguf_checkpoint(args)
    if args.model_path:
        # a GGUF is authoritative for the shape; otherwise --model names it
        # and an HF config.json may cut its depth
        model_config = (config_from_gguf(gguf_path) if gguf_path
                        else depth_from_hf(args.model_path, _resolve_model(args.model)))
        t0 = time.monotonic()
        load = load_moe_params if isinstance(model_config, MoeConfig) else load_llama_params
        params = load(args.model_path, model_config, quantize=args.quantize, device=device)
        logger.info("loaded %s (%s) in %.1fs: %.2f GiB of weights", args.model_path,
                    args.quantize or model_config.dtype, time.monotonic() - t0,
                    param_bytes(params) / 2**30)
    cfg = EngineConfig(
        model=args.model,
        page_size=args.page_size,
        num_pages=args.num_pages,
        max_num_seqs=args.max_num_seqs,
        max_model_len=args.max_model_len,
        decode_pool_mode=args.decode_pool_mode,
        decode_block_unroll=args.decode_block_unroll,
        kv_quant=args.kv_quant,
        spec_mode=args.spec,
        spec_draft_len=args.spec_draft_len,
        spec_ngram=args.spec_ngram,
        spec_rounds=args.spec_rounds,
        sched_policy=args.sched_policy,
        ttft_target_ms=args.ttft_target_ms,
        itl_target_ms=args.itl_target_ms,
        seed=args.seed,
        quantize=args.quantize,
        kvbm_host_blocks=args.kvbm_host_blocks,
        kvbm_disk_blocks=args.kvbm_disk_blocks,
        kvbm_disk_path=args.kvbm_disk_path,
        # aggregated serving drives both surfaces, as the reference's "decode"
        role="prefill" if args.role == "prefill" else "decode",
    )
    engine = TorchEngine(cfg, model_config=model_config, params=params, device=device)
    del params
    # the served vocabulary: a GGUF checkpoint's own, else the byte
    # tokenizer at the model's vocabulary size
    engine.tokenizer = load_tokenizer(
        f"gguf:{gguf_path}" if gguf_path else f"byte:{engine.model_config.vocab_size}")
    return engine


def gguf_checkpoint(args) -> Optional[str]:
    """The .gguf file `--model-path` names, if it names one."""
    return _find_gguf(args.model_path) if args.model_path else None


@dataclass
class Worker:
    """A serving worker, handed to `serve`'s `started` future. A morph moves
    the lanes: `endpoint`, `served`, the publishers and `card_key` follow."""

    drt: DistributedRuntime
    engine: TorchEngine
    endpoint: Endpoint
    served: ServedEndpoint
    kv_publisher: Optional[KvEventPublisher]
    metrics_publisher: WorkerMetricsPublisher
    card_key: Optional[str]  # None on a prefill worker (no card)
    role: str = "aggregated"  # the live role
    morph_served: Optional[ServedEndpoint] = None  # prefill/decode roles
    # the morph control handler: `async for reply in morph(request, ctx)`
    morph: Optional[Callable[..., Any]] = None


async def _watch_prefill_queue(drt, args, prefill_client, router: DisaggregatedRouter):
    """Conditional-disagg queue guard: feed the least-loaded live prefill
    worker's published queue depth (waiting + running) into the router, so
    remote prefill stops while the whole pool is backed up."""
    from ..llm.kv_router.publisher import METRICS_TOPIC_FMT
    from ..runtime import codec

    if drt.discovery is None:
        return
    sub = await drt.discovery.subscribe(METRICS_TOPIC_FMT.format(
        namespace=args.namespace, component=args.prefill_component))
    depths: dict = {}
    announced = False
    async for payload in sub:
        try:
            msg = codec.unpack(payload)
            stats = msg.get("stats", {})
            depths[int(msg["worker_id"])] = (int(stats.get("num_waiting_reqs", 0))
                                             + int(stats.get("num_running_reqs", 0)))
            live = set(prefill_client.instance_ids())
            for w in list(depths):
                if w not in live:
                    del depths[w]
            if depths:
                router.update_queue_depth(min(depths.values()))
            else:
                # no live publisher left: unknown, not empty
                router.invalidate("no live prefill publishers")
            if not announced and depths:
                # logged once a live prefill worker has been heard: from
                # here on this worker sends prompts to the prefill pool
                announced = True
                logger.info("prefill queue watcher active (%d worker(s), depth=%d)",
                            len(depths), router.prefill_queue_depth)
        except Exception:  # noqa: BLE001 — stats are advisory
            logger.debug("bad prefill metrics message", exc_info=True)


async def _watch_prefill_set(prefill_client, router: DisaggregatedRouter):
    """Forget the published depth as soon as the prefill instance set
    changes (a worker joined, drained or died), without waiting for the
    depth's TTL."""
    prev = set(prefill_client.instance_ids())
    while True:
        await asyncio.sleep(0.25)
        live = set(prefill_client.instance_ids())
        if live != prev:
            router.invalidate(f"prefill set changed {len(prev)}->{len(live)}")
        prev = live


async def serve(args, engine: Optional[TorchEngine] = None,
                started: Optional[asyncio.Future] = None) -> None:
    """Run one worker until shutdown (SIGTERM/SIGINT, or `drt.shutdown()`).

    `engine`: serve this engine instead of building one from the flags
    (tests hand in an engine built from converted weights); the caller then
    keeps it and closes it. `started`: set to the `Worker` once the endpoint
    serves and the card is registered."""
    bad = unsupported_flags(args)
    if bad:
        raise UnsupportedConfigError(
            f"worker flags not supported by the PyTorch/CUDA port yet: {bad}"
        )
    owns_engine = engine is None
    if owns_engine:
        engine = build_engine(args)
    # before the warmup, which then drives a LoRA request too
    register_lora_flags(engine, args.lora)
    # events of the warmup are held until the publisher exists
    pending_events: list = []
    engine.allocator.event_sink = pending_events.append
    drt = None
    data_plane = None
    kvbm_dist = None
    watchers: list = []
    try:
        # drive every dispatch kind — and so build the kernels with nvcc —
        # BEFORE joining the control plane: a first-request build after
        # registration would starve the lease keepalives, and the frontend
        # would drop the worker mid-stream
        if args.warmup == "full" or (args.warmup == "auto" and engine.device.type == "cuda"):
            t0 = time.monotonic()
            n_warm = await engine.warmup()
            logger.info("engine warmup: %d dispatches in %.1fs", n_warm, time.monotonic() - t0)

        # KV data plane: prefill-capable workers stage finished prompts here;
        # a worker with KVBM tiers serves its blocks to peers on it
        if not args.no_kv_data_plane and (
                engine.kvbm is not None or args.role in ("prefill", "aggregated")):
            data_plane = KvDataPlaneServer(
                advertise_host=args.kv_data_plane_host, port=args.kv_data_plane_port)
            await data_plane.start()
            engine.data_plane = data_plane
            logger.info("kv data plane listening on %s", data_plane.addr)

        cfg = RuntimeConfig.from_settings()
        if args.discovery:
            cfg.discovery_endpoint = args.discovery
        drt = await DistributedRuntime.create(cfg)
        drt.install_signal_handlers()
        if data_plane is not None:
            await data_plane.register(drt)
        if engine.kvbm is not None and data_plane is not None:
            # distributed KVBM: announce our tiered blocks namespace-wide so
            # any worker can onboard them over the data plane
            from ..kvbm import KvbmDistributed

            kvbm_dist = KvbmDistributed(drt, engine.kvbm, data_plane, args.namespace,
                                        "kvbm", drt.instance_id)
            await kvbm_dist.start()
            logger.info("distributed KVBM mesh joined (namespace %s)", args.namespace)
        def role_component(role: str) -> str:
            return args.prefill_component if role == "prefill" else args.component

        endpoint = (drt.namespace(args.namespace).component(role_component(args.role))
                    .endpoint(args.endpoint))

        publisher = None
        if args.kv_events:
            publisher = KvEventPublisher(drt, endpoint, drt.instance_id)
            await publisher.start()
            for ev in pending_events:
                publisher.publish(ev)
            # the allocator runs on the event loop's thread (admission,
            # commits and releases happen in the step loop; only the
            # `_dev_*` programs run on the device executor), so the plain
            # publish is the right sink
            engine.allocator.event_sink = publisher.publish
        else:
            engine.allocator.event_sink = None
        pending_events.clear()

        metrics_pub = WorkerMetricsPublisher(drt, endpoint, drt.instance_id, engine.stats)
        await metrics_pub.start()

        snap = {"t": 0.0, "v": {}}

        def snap_stat(k):
            # one engine.stats() per render, shared by the gauges
            now = time.monotonic()
            if now - snap["t"] > 0.5:
                snap["v"] = engine.stats()
                snap["t"] = now
            return float(snap["v"].get(k, 0) or 0)

        for stat in worker_exported_stats():
            drt.metrics.callback_gauge(
                f"worker_{stat}", f"engine stat {stat}", (lambda k=stat: snap_stat(k))
            )
        hcm = drt.health_check_manager
        if hcm is not None:
            drt.metrics.callback_gauge("worker_health_canaries", "canary requests sent",
                                       lambda: float(hcm.probes))
            drt.metrics.callback_gauge("worker_health_canary_failures",
                                       "canary requests failed",
                                       lambda: float(hcm.probe_failures))

        prefill_client = disagg_router = None
        if args.role in ("prefill", "decode"):
            # both disagg roles: a prefill worker may be morphed into a
            # decode worker, which then needs the conditional-disagg wiring
            prefill_client = await (drt.namespace(args.namespace)
                                    .component(args.prefill_component)
                                    .endpoint(args.endpoint).client())
            disagg_router = DisaggregatedRouter(
                DisaggConfig(remote_prefill_threshold_tokens=args.disagg_threshold))
            loop = asyncio.get_running_loop()
            watchers = [
                loop.create_task(_watch_prefill_queue(drt, args, prefill_client, disagg_router)),
                loop.create_task(_watch_prefill_set(prefill_client, disagg_router)),
            ]

        async def handler(request, context):
            annotations = request.get("annotations") or []
            if "worker_instance_id" in annotations:
                yield {"event": "worker_instance_id", "comment": [f"{drt.instance_id:x}"]}
            if "clear_kv_blocks" in annotations:
                # admin flush (reference service_v2.rs:319-339 clear-kv-blocks)
                yield {"event": "clear_kv_blocks", "comment": [str(engine.clear_kv_blocks())]}
                return
            if worker.role == "decode" and disagg_router is not None:
                stream = maybe_remote_prefill(
                    engine, prefill_client, disagg_router, request, context)
            else:
                stream = engine.generate(request, context)
            async for item in stream:
                yield item

        def make_card() -> ModelDeploymentCard:
            return ModelDeploymentCard(
                name=args.model_name or args.model,
                tokenizer=card_tokenizer(gguf_checkpoint(args)),
                kv_cache_block_size=args.page_size,
                context_length=args.context_length or args.max_model_len,
                migration_limit=args.migration_limit,
                lora_adapters=engine.lora_names(),
            )

        async def apply_lanes(role: str):
            """Reconcile discovery to `role`: move `generate` and `morph` to
            the role's component (the new lanes born `morphing` until the
            morph commits), re-home the metrics and KV-event publishers, and
            drop or register the model card. The engine's morph awaits this
            between its flip and its re-warm; a rollback calls it again
            toward the old role."""
            nonlocal metrics_pub, publisher
            new_ep = (drt.namespace(args.namespace).component(role_component(role))
                      .endpoint(args.endpoint))
            if new_ep.subject != worker.endpoint.subject:
                morph_ep = (drt.namespace(args.namespace).component(role_component(role))
                            .endpoint("morph"))
                if hcm is not None:
                    hcm.unregister(worker.served.instance.subject)
                for lane in (worker.served, worker.morph_served):
                    if lane is not None:
                        await lane.remove()
                worker.served = await new_ep.serve_endpoint(handler)
                if hcm is not None:
                    hcm.register(worker.served, CANARY)
                await worker.served.set_state(STATE_MORPHING)
                worker.morph_served = await morph_ep.serve_endpoint(morph_handler)
                await worker.morph_served.set_state(STATE_MORPHING)
                worker.endpoint = new_ep
                # the load-signal and KV-event topics are per component
                await metrics_pub.close()
                metrics_pub = WorkerMetricsPublisher(drt, new_ep, drt.instance_id,
                                                     engine.stats)
                await metrics_pub.start()
                worker.metrics_publisher = metrics_pub
                if publisher is not None:
                    await publisher.close()
                    publisher = KvEventPublisher(drt, new_ep, drt.instance_id)
                    await publisher.start()
                    engine.allocator.event_sink = publisher.publish
                    worker.kv_publisher = publisher
            if role != "prefill" and worker.card_key is None:
                worker.card_key = await register_llm(worker.endpoint, make_card())
            elif role == "prefill" and worker.card_key is not None:
                drt._leased_keys.pop(worker.card_key, None)
                if drt.discovery is not None:
                    await drt.discovery.delete(worker.card_key)
                worker.card_key = None

        async def set_lane_states(state: str):
            for lane in (worker.served, worker.morph_served):
                if lane is not None:
                    await lane.set_state(state)

        async def morph_handler(request, context):
            """`{"target_role": "prefill"|"decode"}` -> one reply: `{"ok":
            true, "from", "to", "drained", "duration_s"}`, or `{"error": ...}`
            (a bad role, an aggregated worker, a rolled-back morph). An
            injected MorphCrash propagates."""
            from ..runtime import faults

            target = (request or {}).get("target_role", "")
            if target not in ("prefill", "decode"):
                yield {"error": f"bad target_role {target!r}"}
                return
            if args.role == "aggregated":
                yield {"error": "aggregated worker has no role to morph"}
                return
            if worker.role == target:
                yield {"ok": True, "noop": True, "role": target}
                return
            old_role = worker.role
            await set_lane_states(STATE_MORPHING)
            try:
                summary = await engine.morph(target, on_flip=lambda: apply_lanes(target))
            except (faults.MorphCrash, asyncio.CancelledError):
                raise
            except Exception as e:  # noqa: BLE001 — a typed reply for the caller
                # the engine rolled back (its severed sessions are already
                # migrating): restore the old lanes, routable
                await apply_lanes(old_role)
                await set_lane_states(STATE_READY)
                yield {"error": f"morph rolled back: {type(e).__name__}: {e}"}
                return
            worker.role = target
            await set_lane_states(STATE_READY)
            yield {"ok": True, **summary}

        worker = Worker(drt, engine, endpoint, None, publisher, metrics_pub, None,
                        role=args.role, morph=morph_handler)
        worker.served = await endpoint.serve_endpoint(handler)
        if args.role in ("prefill", "decode"):
            worker.morph_served = await (drt.namespace(args.namespace)
                                         .component(role_component(args.role))
                                         .endpoint("morph").serve_endpoint(morph_handler))
        if hcm is not None:
            hcm.register(worker.served, CANARY)
        if args.role != "prefill":
            # the card goes up after the endpoint serves: it is what makes
            # a frontend build a pipeline to this worker
            worker.card_key = await register_llm(endpoint, make_card())
        logger.info(
            "torch worker up: model=%s role=%s device=%s num_pages=%d instance=%x",
            args.model_name or args.model, args.role, engine.device,
            engine.config.num_pages, drt.instance_id,
        )
        if started is not None:
            started.set_result(worker)
        try:
            await drt.wait_for_shutdown()
        finally:
            await metrics_pub.close()
            if publisher is not None:
                await publisher.close()
    finally:
        for task in watchers:
            task.cancel()
        await asyncio.gather(*watchers, return_exceptions=True)
        engine.allocator.event_sink = None
        if kvbm_dist is not None:
            await kvbm_dist.close()
        if drt is not None:
            # graceful drain: lease revoked first (routers stop picking this
            # worker), in-flight streams finish within
            # DYN_RUNTIME_GRACEFUL_SHUTDOWN_TIMEOUT, survivors are cancelled
            await drt.close()
        if data_plane is not None:
            # staged transfers release their pages (on_done(False))
            await data_plane.close()
            engine.data_plane = None
        if owns_engine:
            await engine.close()


def main(argv=None):
    init_logging()
    asyncio.run(serve(parse_args(argv)))


if __name__ == "__main__":
    main()
