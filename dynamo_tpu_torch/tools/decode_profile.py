"""Where one decode step's time goes on the card.

    python3 -m dynamo_tpu_torch.tools.decode_profile [--layers 28] [--ctx 512]

Runs the engine's decode step (models.llama.decode_forward + sampling, as
`TorchEngine._dev_block` runs it) at the full width of Llama-3.2-3B with
64 lanes, random weights, under `torch.profiler`, and prints one JSON
line: host wall time per step, device-busy time per step (sum of kernel
times), the device's idle share, kernel launches per step and the kernels
that take the most device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from ..engine.sampling import SamplingParams, sample_lp
from ..models import llama


@torch.no_grad()
def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=28)
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--ctx", type=int, default=512, help="context length of every lane")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA device")
    dev = torch.device("cuda")
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=args.layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = llama.init_params(cfg, gen, device=dev)
    B, ps, P = args.lanes, 64, 128
    pages = B * ((args.ctx + args.steps * 3) // ps + 1) + 1
    kv_k = torch.zeros((cfg.num_layers, pages, ps, cfg.num_kv_heads, cfg.head_dim),
                       dtype=cfg.dtype, device=dev)
    kv_v = torch.zeros_like(kv_k)
    per = (pages - 1) // B
    tables = torch.zeros((B, P), dtype=torch.int32, device=dev)
    tables[:, :per] = 1 + torch.arange(B * per, device=dev, dtype=torch.int32).reshape(B, per)
    samp = SamplingParams.full(B, device=dev)._replace(all_greedy=True, no_penalties=True)

    def run(n_steps, tokens, positions):
        for _ in range(n_steps):
            logits, _, _ = llama.decode_forward(
                params, cfg, tokens, positions, kv_k, kv_v, tables, positions + 1)
            nxt, _, _, _ = sample_lp(logits, samp, positions, raw=logits)
            tokens, positions = nxt.to(torch.int32), positions + 1
        return tokens, positions

    tokens = torch.randint(5, cfg.vocab_size, (B,), device=dev, dtype=torch.int32)
    positions = torch.full((B,), args.ctx, dtype=torch.int32, device=dev)
    tokens, positions = run(args.steps, tokens, positions)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tokens, positions = run(args.steps, tokens, positions)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.steps

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run(args.steps, tokens, positions)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in kernels)
    launches = sum(e.count for e in kernels)
    top = sorted(kernels, key=lambda e: -e.device_time_total)[:8]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    busy_ms = busy_us / 1e3 / args.steps
    print(json.dumps({
        "card": smi, "layers": args.layers, "lanes": B, "ctx": args.ctx,
        "wall_ms_per_step": round(wall_ms, 3),
        "device_busy_ms_per_step": round(busy_ms, 3),
        "device_idle_share": round(max(0.0, 1.0 - busy_ms / wall_ms), 3),
        "launches_per_step": round(launches / args.steps, 1),
        "top_kernels_ms_per_step": {
            e.key[:60]: round(e.device_time_total / 1e3 / args.steps, 3) for e in top},
    }))


if __name__ == "__main__":
    main()
