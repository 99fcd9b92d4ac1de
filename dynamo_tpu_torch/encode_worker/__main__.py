"""Encode worker: `python -m dynamo_tpu_torch.encode_worker` — the E of E/P/D.

Port of `dynamo_tpu/encode_worker/__main__.py` on the port's runtime. It
turns multimodal content parts into embedding rows for the prefill
engine's splice and registers a plain runtime endpoint (no model card: it
is not a generation model). The reference frontend started with
`--encoder dynamo/encoder/encode` calls it ahead of the engine hop
(`llm/multimodal.EncodeOperator`), so an image request reaches a port
worker with its placeholder tokens and embeddings stamped on.

`--encoder vit` runs the ViT (`--vit-size base`: ViT-Base/16 at 224 px;
`--vit-checkpoint DIR`: an HF export, else random weights from seed 0)
with its projector to `--hidden-size` (default: `--model`'s width) on
`--device` (default cuda, which raises when no CUDA device is present;
`--device cpu` runs on the CPU). `--encoder mock` is the content-hash
stand-in the tests use.
"""

import argparse
import asyncio
import logging

from dynamo_tpu_torch.llm.multimodal import DEFAULT_MM_TOKENS, MockVisionEncoder, encode_parts
from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig, init_logging

logger = logging.getLogger("dynamo_tpu_torch.encode_worker")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="dynamo-tpu PyTorch/CUDA encode worker "
                                 "(multimodal E/P/D)")
    ap.add_argument("--namespace", default="dynamo")
    ap.add_argument("--component", default="encoder")
    ap.add_argument("--endpoint", default="encode")
    ap.add_argument("--discovery", default=None, help="tcp://host:port of discovery")
    ap.add_argument("--hidden-size", type=int, default=None,
                    help="embedding width; defaults from --model")
    ap.add_argument("--model", default="tiny",
                    help="model registry key the embeddings target")
    ap.add_argument("--mm-tokens", type=int, default=DEFAULT_MM_TOKENS,
                    help="placeholder span length per content part (mock)")
    ap.add_argument("--encoder", choices=["mock", "vit"], default="mock",
                    help="mock: content-hash projection (tests); vit: the ViT (models/vit.py)")
    ap.add_argument("--vit-checkpoint", default=None,
                    help="local HF ViT export dir (safetensors/bin); random-init when omitted")
    ap.add_argument("--vit-size", choices=["tiny", "base"], default="tiny",
                    help="ViT architecture when no checkpoint config")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the ViT; cuda raises when no CUDA device is present")
    return ap.parse_args(argv)


def build_encoder(args):
    hidden = args.hidden_size
    if hidden is None:
        from dynamo_tpu_torch.engine.engine import _resolve_model

        hidden = _resolve_model(args.model).hidden_size
    if args.encoder == "vit":
        from dynamo_tpu_torch.llm.multimodal import ViTEncoder
        from dynamo_tpu_torch.models.vit import ViTConfig

        vcfg = ViTConfig() if args.vit_size == "base" else ViTConfig.tiny()
        return ViTEncoder(config=vcfg, llm_hidden=hidden, checkpoint=args.vit_checkpoint,
                          device=args.device)
    return MockVisionEncoder(hidden, n_tokens=args.mm_tokens)


async def main(argv=None):
    init_logging()
    args = parse_args(argv)
    encoder = build_encoder(args)
    cfg = RuntimeConfig.from_settings()
    if args.discovery:
        cfg.discovery_endpoint = args.discovery
    drt = await DistributedRuntime.create(cfg)
    # SIGTERM (planner scale-down) walks the graceful drain, not a hard exit
    drt.install_signal_handlers()
    n_encoded = 0

    endpoint = drt.namespace(args.namespace).component(args.component).endpoint(args.endpoint)

    async def handler(request, context):
        nonlocal n_encoded
        parts = request.get("multimodal") or []
        encoded = encode_parts(parts, encoder)
        n_encoded += len(encoded)
        logger.info("encoded %d part(s) (total %d)", len(encoded), n_encoded)
        yield {"data": {"multimodal": encoded, "n_tokens": encoder.n_tokens}}

    logger.info("encode worker up: hidden=%d mm_tokens=%d instance=%x",
                encoder.hidden_size, encoder.n_tokens, drt.instance_id)
    await endpoint.serve_endpoint(handler)
    await drt.wait_for_shutdown()
    await drt.close()  # graceful drain


if __name__ == "__main__":
    asyncio.run(main())
