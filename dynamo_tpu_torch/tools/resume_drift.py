"""Does a migrated resume continue the stream that died?

    python3 -m dynamo_tpu_torch.tools.resume_drift [--layers 28] [--seed 0]

At the full width of Llama-3.2-3B (bf16, scatter pool, random weights from
--seed), each of four requests (prompts of ~1,000 tokens, two greedy, two
seeded at temperature 0.7) is served alone for 256 tokens; then, for cuts
k in 128, 131, 150 and 191, the migration retry of the same stream (prompt
plus its first k tokens, `migration=1`) is served on the same engine, whose
prefix cache holds the stream's own decode-written blocks — the survivor's
state after a checkpointed death. Its un-checkpointed tail is recomputed
two ways: decode-shaped (the engine's migrated resume) and prefilled (the
reference's). For each it prints how many of the 256 - k continuation
tokens equal the uninterrupted stream's before the first difference, as
one JSON line. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import subprocess

import numpy as np
import torch

from ..engine import EngineConfig, TorchEngine
from ..llm.protocols import PreprocessedRequest
from ..llm.tokenizers import ByteTokenizer
from ..models import llama
from ..runtime.engine import Context

CUTS = (128, 131, 150, 191)
OUT = 256
WORDS = ["paged", "attention", "kernel", "hopper", "decode", "prefill",
         "ragged", "token", "cache", "block", "stream", "engine"]


def prompts(seed: int, vocab: int) -> list:
    tok = ByteTokenizer(vocab)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(4):
        text = f"request {9000 + i}: "
        while len(text) < 1000 + 7 * i:
            text += WORDS[int(rng.integers(len(WORDS)))] + " "
        out.append(tok.encode(text[:1000 + 7 * i]))
    return out


async def tokens_of(engine, ids, n, rid, sampling, migration=0) -> list:
    req = PreprocessedRequest(token_ids=ids, request_id=rid, migration=migration,
                              stop_conditions={"max_tokens": n},
                              sampling_options=sampling).to_dict()
    out = []
    async for item in engine.generate(req, Context()):
        out += (item.get("data") or {}).get("token_ids") or []
    return out


async def run(layers: int, seed: int) -> dict:
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=layers)
    engine = TorchEngine(EngineConfig(model="llama3-3b", seed=seed, num_pages=1024),
                         model_config=cfg, device="cuda")
    await engine.warmup()
    rows = {}
    try:
        for i, ids in enumerate(prompts(seed, cfg.vocab_size)):
            sampling = {} if i < 2 else {"temperature": 0.7, "seed": 100 + i}
            engine.clear_kv_blocks()
            whole = await tokens_of(engine, ids, OUT, f"whole-{i}", sampling)
            row = {"sampling": "greedy" if i < 2 else "seeded"}
            for arm, decode_shaped in (("decode_shaped", True), ("prefilled", False)):
                engine._replay_tail = decode_shaped
                matched = []
                for k in CUTS:
                    cont = await tokens_of(engine, ids + whole[:k], OUT - k, f"cut-{i}-{k}",
                                           sampling, migration=1)
                    matched.append(next((j for j, (a, b) in enumerate(zip(cont, whole[k:]))
                                         if a != b), len(cont)))
                row[arm] = matched
            engine._replay_tail = True
            rows[f"stream{i}"] = row
        stats = engine.stats()
    finally:
        await engine.close()
    return {"rows": rows, "replay_dispatches": stats["dev_time"].get("replay", {}).get("count"),
            "migrations_resumed": stats["migrations_resumed"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("resume_drift needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    out = asyncio.run(run(args.layers, args.seed))
    print(json.dumps({"tool": "resume_drift", "device": torch.cuda.get_device_name(0),
                      "nvidia_smi": smi, "layers": args.layers, "cuts": list(CUTS),
                      "continuation_tokens": [OUT - k for k in CUTS], **out}), flush=True)


if __name__ == "__main__":
    main()
