"""Where one decode step's time goes on the card.

    python3 -m dynamo_tpu_torch.tools.decode_profile [--model llama3-3b] [--layers N]
                                                    [--ctx 512] [--kv-quant none|int8|int4]
                                                    [--pool-mode scatter|local]
                                                    [--quantize none|int8]
                                                    [--lora N]

Runs the engine's decode step (models.llama.decode_forward + sampling, as
`TorchEngine._dev_block` runs it under decode_pool_mode="scatter"; under
"local", `decode_forward_local` steps over a read-only pool and one
`kv_write_all_layers` commit per block of --steps) at the full width of
the registry model --model (default Llama-3.2-3B; an MoE model such as
mixtral-8x7b runs models.moe's forwards; --layers cuts its depth) with
64 lanes, random weights (int8 weight-only quantized with --quantize
int8, each matrix as it is drawn: every projection, expert stack and the
head then widen int8 to bf16 ahead of their GEMM; the widen of every int8
leaf a step reads is also timed alone, beside the step's bound of
reading its weights once), over a KV pool in the given format (its writes
quantize in place), under `torch.profiler`, and prints one JSON
line: host wall time per step, device-busy time per step (sum of kernel
times), the device's idle share, kernel launches per step and the kernels
that take the most device time (under "local" also the commit's own
device time). With --lora N it prints the plain step and, beside it, the
step of the engine's LoRA block (`decode_forward` with the adapter stack,
pool written in place, as `TorchEngine._dev_block` runs a block with LoRA
lanes): N random adapters of rank 16 (the largest the smoke serves) in
the stack, lane i on adapter i % N + 1, with the bytes of the stack the
deltas read a step. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import torch

from ..engine.engine import _resolve_model
from ..engine.sampling import SamplingParams, sample_lp
from ..models import llama, lora as lora_mod, moe
from ..models.quant import is_quant, param_bytes
from ..ops.kv_quant import KV_QUANT_MODES, alloc_kv_store, kv_write_all_layers


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama3-3b", help="model registry key")
    ap.add_argument("--layers", type=int, default=None, help="depth (default: the model's)")
    ap.add_argument("--lanes", type=int, default=64)
    ap.add_argument("--ctx", type=int, default=512, help="context length of every lane")
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kv-quant", choices=KV_QUANT_MODES, default="none")
    ap.add_argument("--pool-mode", choices=("scatter", "local"), default="scatter")
    ap.add_argument("--quantize", choices=("none", "int8"), default="none")
    ap.add_argument("--lora", type=int, default=0, help="adapters spread over the lanes")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("decode_profile needs a CUDA device")
    dev = torch.device("cuda")
    cfg = _resolve_model(args.model)
    cfg = dataclasses.replace(cfg, num_layers=args.layers or cfg.num_layers)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    params = family(cfg).init_params(cfg, gen, device=dev,
                                     quantize=None if args.quantize == "none" else "int8")
    kw = dict(lanes=args.lanes, ctx=args.ctx, steps=args.steps, kv_quant=args.kv_quant,
              pool_mode=args.pool_mode)
    if not args.lora:
        print(json.dumps({"model": args.model, **profile(params, cfg, **kw)}))
        return
    op = lora_operand(cfg, args.lora, args.lanes, args.seed, dev)
    print(json.dumps({"model": args.model, "plain": profile(params, cfg, **kw),
                      "lora": profile(params, cfg, lora=op, **kw)}))


HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (data sheet)
LORA_RANK = 16  # the rank of the profile's adapters


def family(cfg):
    """The forwards' module of the model: models.moe for an MoeConfig."""
    return moe if isinstance(cfg, moe.MoeConfig) else llama


def lora_operand(cfg, n_adapters: int, lanes: int, seed: int, dev) -> dict:
    """A LoRA block's operand: `n_adapters` random adapters of LORA_RANK
    (from `seed`) stacked on `dev`, lane i on slot i % n_adapters + 1."""
    gen = torch.Generator().manual_seed(seed)
    ads = [lora_mod.init_adapter(cfg, f"ad{i}", gen, rank=LORA_RANK) for i in range(n_adapters)]
    stack = lora_mod.stack_adapters(cfg, ads, device=dev)
    idx = torch.arange(lanes, device=dev, dtype=torch.int32) % n_adapters + 1
    return dict(stack, idx=idx)


@torch.no_grad()
def profile(params, cfg, lanes: int = 64, ctx: int = 512, steps: int = 8,
            kv_quant: str = "none", pool_mode: str = "scatter", lora=None) -> dict:
    """The profile of `steps` decode steps of `params` (on the card) as a
    dict: the JSON line `main` prints. `lora` (an adapter stack with each
    lane's slot in "idx") profiles the LoRA block's step, which writes the
    pool in place whatever `pool_mode` says."""
    if lora is not None:
        pool_mode = "scatter"
    args = argparse.Namespace(lanes=lanes, ctx=ctx, steps=steps, kv_quant=kv_quant,
                              pool_mode=pool_mode, layers=cfg.num_layers)
    dev = torch.device("cuda")
    quantized = "int8" if is_quant(params["layers"]["wq"]) else "none"
    B, ps, P = args.lanes, 64, 128
    pages = B * ((args.ctx + args.steps * 3) // ps + 1) + 1
    kv_k, kv_v = (alloc_kv_store(cfg.num_layers, pages, ps, cfg.num_kv_heads,
                                 cfg.head_dim, cfg.dtype, args.kv_quant, device=dev)
                  for _ in range(2))
    per = (pages - 1) // B
    tables = torch.zeros((B, P), dtype=torch.int32, device=dev)
    tables[:, :per] = 1 + torch.arange(B * per, device=dev, dtype=torch.int32).reshape(B, per)
    samp = SamplingParams.full(B, device=dev)._replace(all_greedy=True, no_penalties=True)

    model = family(cfg)
    K = args.steps
    step_idx = [torch.full((1,), j, dtype=torch.int32, device=dev) for j in range(K)]

    def commit(start, loc):
        pos = start[:, None] + torch.arange(K, device=dev)[None, :]
        phys, offs = llama._page_slots(pos, tables[:, None, :].expand(-1, K, -1), ps)
        kv_write_all_layers(kv_k, phys, offs, loc[0])
        kv_write_all_layers(kv_v, phys, offs, loc[1])

    def run(n_steps, tokens, positions):
        if args.pool_mode == "local":
            pool_lens, start = positions, positions
            loc = torch.zeros((2, cfg.num_layers, B, K, cfg.num_kv_heads, cfg.head_dim),
                              dtype=cfg.dtype, device=dev)
        for j in range(n_steps):
            if args.pool_mode == "local":
                logits, _, _ = model.decode_forward_local(
                    params, cfg, tokens, positions, loc[0], loc[1], step_idx[j],
                    kv_k, kv_v, tables, pool_lens)
            else:
                logits, _, _ = model.decode_forward(
                    params, cfg, tokens, positions, kv_k, kv_v, tables, positions + 1,
                    lora=lora)
            nxt, _, _, _ = sample_lp(logits, samp, positions, raw=logits)
            tokens, positions = nxt.to(torch.int32), positions + 1
        if args.pool_mode == "local":
            commit(start, loc)
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
    # kernels whose names share their first 60 characters are summed
    by_name: dict = {}
    for e in kernels:
        by_name[e.key[:60]] = by_name.get(e.key[:60], 0.0) + e.device_time_total
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    busy_ms = busy_us / 1e3 / args.steps
    commit_ms = None
    if args.pool_mode == "local":  # the commit alone, device time
        loc = torch.randn((2, cfg.num_layers, B, K, cfg.num_kv_heads, cfg.head_dim),
                          device=dev).to(cfg.dtype)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        commit(positions, loc)
        torch.cuda.synchronize()
        ev[0].record()
        for _ in range(3):
            commit(positions, loc)
        ev[1].record()
        torch.cuda.synchronize()
        commit_ms = round(ev[0].elapsed_time(ev[1]) / 3, 3)
    widen_ms = widen_ms_per_step(params, cfg) if quantized == "int8" else None
    weight_bytes = param_bytes(params)
    return {
        "card": smi, "layers": args.layers,
        "hidden_size": cfg.hidden_size,
        "experts": getattr(cfg, "num_experts", None), "lanes": B, "ctx": args.ctx,
        "kv_quant": args.kv_quant, "pool_mode": args.pool_mode,
        "quantize": quantized, "weight_bytes": weight_bytes,
        # the least a step can take: every weight byte read once
        "weight_read_bound_ms": round(1e3 * weight_bytes / HBM_BYTES_PER_S, 3),
        # the int8 -> bf16 widen of every int8 leaf a step reads, alone
        # (device time), and its share of the step's device-busy time
        "widen_ms_per_step": widen_ms,
        "widen_share_of_busy": None if widen_ms is None else round(widen_ms / busy_ms, 3),
        "lora_stack_bytes": None if lora is None else sum(
            t.numel() * t.element_size() for part in ("a", "b") for t in lora[part].values()),
        "lora_slots": None if lora is None else int(lora["scale"].numel()),
        "commit_ms_per_block": commit_ms,
        "wall_ms_per_step": round(wall_ms, 3),
        "device_busy_ms_per_step": round(busy_ms, 3),
        "device_idle_share": round(max(0.0, 1.0 - busy_ms / wall_ms), 3),
        "launches_per_step": round(launches / args.steps, 1),
        "top_kernels_ms_per_step": {
            name: round(us / 1e3 / args.steps, 3) for name, us in top},
    }


@torch.no_grad()
def widen_ms_per_step(params, cfg, reps: int = 3) -> float:
    """Device ms of widening every int8 leaf one decode step reads (each
    layer's projections and expert stacks, and the head) to the model
    dtype, timed alone with CUDA events."""
    leaves = [v["q"][li] for v in params["layers"].values() if is_quant(v)
              for li in range(cfg.num_layers)]
    head = params.get("lm_head") if params.get("lm_head") is not None else params["embed"]
    if is_quant(head):
        leaves.append(head["q"])

    def widen():
        for q in leaves:
            q.to(cfg.dtype)

    widen()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    torch.cuda.synchronize()
    ev[0].record()
    for _ in range(reps):
        widen()
    ev[1].record()
    torch.cuda.synchronize()
    return round(ev[0].elapsed_time(ev[1]) / reps, 3)


if __name__ == "__main__":
    main()
