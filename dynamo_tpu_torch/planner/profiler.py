"""Pre-deployment SLA profiler: sweep the port's forwards, write planner profiles.

Port of `dynamo_tpu/planner/profiler.py` (the role of the reference's
benchmarks/profiler/profile_sla.py): measure, per card, (a) prefill
throughput and TTFT across input lengths and (b) decode ITL and throughput
across (kv-cache usage, context length) operating points, then write npz
files in the exact raw_data layout the planner's interpolators load
(selected_prefill_interpolation/raw_data.npz and
selected_decode_interpolation/raw_data.npz; field names per
perf_interpolation.py, where "gpu" reads "chip"). The keys, units and
grids are the reference's, so a profile from either package loads in the
other's interpolators.

The prefill sweep runs `llama.prefill_forward` (one sequence, one chunk:
the prefill kernel at B=1) and the decode sweep `llama.decode_forward` +
`sampling.sample` (the paged-decode kernel at up to
`kv_usage * max_kv_tokens / context` lanes). Each timed region ends with
`torch.cuda.synchronize()`, so a step is timed as the host sees it, as the
reference's `device_get` fence does. Entry points run on the card unless
the caller passes `device="cpu"`.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np


def _fence(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _params(cfg, device):
    import torch

    from ..models import llama

    return llama.init_params(cfg, torch.Generator(device=device).manual_seed(0),
                             device=device)


def profile_prefill(
    cfg, isl_grid: Sequence[int], page: int = 64, num_chips: int = 1,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Time single-sequence prefill at each ISL; returns the planner's
    prefill raw_data dict (ttft in ms, throughput in tok/s/chip)."""
    import torch

    from ..engine.kv_cache import alloc_kv_arrays
    from ..models import llama

    isl_grid = sorted(isl_grid)
    max_isl = isl_grid[-1]
    pages_per_seq = (max_isl + page - 1) // page
    num_pages = pages_per_seq + 1
    params = _params(cfg, device)
    kv_k, kv_v = alloc_kv_arrays(
        cfg.num_layers, num_pages, page, cfg.num_kv_heads, cfg.head_dim, cfg.dtype,
        device=device,
    )
    page_table = torch.arange(pages_per_seq, dtype=torch.int32, device=device)

    ttft_ms: List[float] = []
    thpt: List[float] = []
    rng = np.random.RandomState(0)
    with torch.inference_mode():
        for isl in isl_grid:
            toks = torch.from_numpy(
                rng.randint(3, cfg.vocab_size - 1, size=isl).astype(np.int64)).to(device)
            pos = torch.arange(isl, dtype=torch.int32, device=device)
            li = torch.tensor(isl - 1, dtype=torch.int32, device=device)

            def step():
                return llama.prefill_forward(params, cfg, toks, pos, kv_k, kv_v,
                                             page_table, 0, li)[0]

            step()  # warmup
            _fence(device)
            reps = 3
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            _fence(device)
            dt = (time.perf_counter() - t0) / reps
            ttft_ms.append(dt * 1000.0)
            thpt.append(isl / dt / num_chips)

    return {
        "prefill_isl": np.asarray(isl_grid, np.float64),
        "prefill_ttft": np.asarray(ttft_ms, np.float64),
        "prefill_thpt_per_gpu": np.asarray(thpt, np.float64),
    }


def decode_batch(usage: float, ctx: int, max_kv_tokens: int, page: int) -> int:
    """Lanes of the (usage, context) point, 0 when not one fits the pool."""
    num_pages = max_kv_tokens // page + 1
    pages_per_seq = (ctx + page - 1) // page
    B = max(1, int(usage * max_kv_tokens / ctx))
    if B * pages_per_seq >= num_pages:
        B = (num_pages - 1) // pages_per_seq
    return max(B, 0)


def profile_decode(
    cfg,
    context_grid: Sequence[int],
    kv_usage_grid: Sequence[float],
    max_kv_tokens: int,
    page: int = 64,
    num_chips: int = 1,
    decode_steps: int = 8,
    device="cuda",
) -> Dict[str, np.ndarray]:
    """Time batched decode at each (kv_usage, context) operating point
    (batch = kv_usage * max_kv_tokens / context); returns the planner's
    decode raw_data dict (itl in ms, throughput in tok/s/chip)."""
    import torch

    from ..engine.kv_cache import alloc_kv_arrays
    from ..engine.sampling import SamplingParams, sample
    from ..models import llama

    params = _params(cfg, device)
    num_pages = max_kv_tokens // page + 1
    kv_k, kv_v = alloc_kv_arrays(
        cfg.num_layers, num_pages, page, cfg.num_kv_heads, cfg.head_dim, cfg.dtype,
        device=device,
    )

    xs: List[float] = []
    ys: List[float] = []
    itl: List[float] = []
    thpt: List[float] = []
    with torch.inference_mode():
        for ctx in context_grid:
            pages_per_seq = (ctx + page - 1) // page
            for usage in kv_usage_grid:
                B = decode_batch(usage, ctx, max_kv_tokens, page)
                if B < 1:
                    continue
                pt = (1 + np.arange(B)[:, None] * pages_per_seq
                      + np.arange(pages_per_seq)) % num_pages
                page_tables = torch.from_numpy(pt.astype(np.int32)).to(device)
                positions = torch.full((B,), ctx - 1, dtype=torch.int32, device=device)
                seq_lens = torch.full((B,), ctx, dtype=torch.int32, device=device)
                samp = SamplingParams.full(B, temperature=0.0, device=device)
                samp = samp._replace(all_greedy=True, no_penalties=True)

                def step(tokens):
                    lg, _, _ = llama.decode_forward(
                        params, cfg, tokens, positions, kv_k, kv_v, page_tables, seq_lens)
                    return sample(lg, samp, positions)

                tokens = step(torch.zeros((B,), dtype=torch.int64, device=device))
                _fence(device)
                t0 = time.perf_counter()
                for _ in range(decode_steps):
                    tokens = step(tokens)
                _fence(device)
                dt = (time.perf_counter() - t0) / decode_steps
                xs.append(usage)
                ys.append(float(ctx))
                itl.append(dt * 1000.0)
                thpt.append(B / dt / num_chips)

    return {
        "x_kv_usage": np.asarray(xs, np.float64),
        "y_context_length": np.asarray(ys, np.float64),
        "z_itl": np.asarray(itl, np.float64),
        "z_thpt_per_gpu": np.asarray(thpt, np.float64),
        "max_kv_tokens": np.asarray([max_kv_tokens], np.float64),
    }


def write_profiles(
    output_dir: str,
    prefill_raw: Dict[str, np.ndarray],
    decode_raw: Dict[str, np.ndarray],
) -> None:
    """Write both npz files in the directory layout the interpolators read."""
    for sub, raw in (
        ("selected_prefill_interpolation", prefill_raw),
        ("selected_decode_interpolation", decode_raw),
    ):
        d = os.path.join(output_dir, sub)
        os.makedirs(d, exist_ok=True)
        np.savez(os.path.join(d, "raw_data.npz"), **raw)


def parse_args(argv: Optional[Sequence[str]] = None):
    import argparse

    ap = argparse.ArgumentParser(description="SLA profiler sweep (PyTorch port)")
    ap.add_argument("--model", default="tiny", choices=sorted(MODELS))
    ap.add_argument("--output-dir", required=True)
    ap.add_argument("--isl-grid", type=int, nargs="+", default=[128, 512, 1024, 2048, 4096])
    ap.add_argument("--context-grid", type=int, nargs="+", default=[256, 1024, 4096])
    ap.add_argument(
        "--kv-usage-grid", type=float, nargs="+", default=[0.1, 0.25, 0.5, 0.75, 0.95]
    )
    ap.add_argument("--max-kv-tokens", type=int, default=1 << 16)
    ap.add_argument("--num-chips", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the sweep (tests pass cpu)")
    return ap.parse_args(argv)


#: --model presets (the reference's names)
MODELS = {"tiny": "tiny", "llama3-3b": "llama3_2_3b", "llama3-8b": "llama3_8b"}


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Dict[str, np.ndarray]]:
    """Run both sweeps, write the profiles; returns their raw_data dicts."""
    args = parse_args(argv)

    from ..models import llama

    cfg = getattr(llama.LlamaConfig, MODELS[args.model])()
    prefill_raw = profile_prefill(cfg, args.isl_grid, num_chips=args.num_chips,
                                  device=args.device)
    decode_raw = profile_decode(
        cfg, args.context_grid, args.kv_usage_grid, args.max_kv_tokens,
        num_chips=args.num_chips, device=args.device,
    )
    write_profiles(args.output_dir, prefill_raw, decode_raw)
    print(f"profiles written to {args.output_dir}")
    return {"prefill": prefill_raw, "decode": decode_raw}


if __name__ == "__main__":
    main()
