"""Time both decode kernels of one checkout of the port, to set two trees side by side.

    python3 dynamo_tpu_torch/tools/decode_ab.py --tree PATH [--seed 0] [--reps 50]

Imports `dynamo_tpu_torch` from the checkout at PATH (which may be an older
tree without this script), builds its kernels (`build_s`: the load's wall
time, `nvcc_s`: the build's, None when the library was already built), and
times its `paged_attention_decode` and `paged_attention_decode_mixed` on
the card at chip_smoke.py's three timed decode shapes in each KV format
(Llama-3.2-3B widths: H=24, KH=8, D=128, page 64, tables [B, 128]): `B64`,
chip_smoke's 64-lane draw (mean length 965); `B4_long` and `B64_12live`,
its two extra shapes' lengths (their q and tables are drawn here). The
local kernel sees pool lengths len - 1 and K=8 block-local rows at step 7.
Each timing is reported two ways over the same calls: `ms`, device ms a
call with the calls queued behind a ~10 ms device sleep;
`ms_back_to_back`, the calls issued straight after a sync, which a host
slower than the kernel stretches; and `host_us`, the host's microseconds a
call; beside them the largest difference from the plain version and the
split count where the tree's wrapper reports one. Run it on each tree in
turns within one session (A, B, B, A): numbers from different sessions or
cards do not compare. Prints the card, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

FORMATS = ("none", "int8", "int4")
SLEEP_CYCLES = 20_000_000  # device sleep ahead of a queued run (~10 ms)


def smoke_draws(seed: int) -> dict:
    """chip_smoke.py's decode draws as numpy: its B=64 case (replaying the
    tiny f32 case drawn before it from the same generator) and the two
    extra shapes' lengths."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for shape in ((40, 8, 2, 16), (40, 8, 2, 16), (5, 4, 16)):  # tiny k, v, q
        rng.standard_normal(shape)
    rng.integers(1, 40, size=(5, 6))  # tiny tables
    lens = rng.integers(1, 2049, size=64)
    lens[:4] = [0, 1, 64, 65]
    k = rng.standard_normal((2049, 64, 8, 128)).astype(np.float32)
    v = rng.standard_normal((2049, 64, 8, 128)).astype(np.float32)
    q = rng.standard_normal((64, 24, 128)).astype(np.float32)
    tables = rng.integers(1, 2049, size=(64, 128))
    rng4 = np.random.default_rng(seed + 4)
    live = np.ones(64, np.int64)
    live[rng4.choice(64, 12, replace=False)] = rng4.integers(1200, 1801, size=12)
    long4 = rng4.integers(7600, 8193, size=4)
    rng6 = np.random.default_rng(seed + 6)
    shapes = {"B64": (lens, q, tables)}
    for name, ln in (("B4_long", long4), ("B64_12live", live)):
        shapes[name] = (ln, rng6.standard_normal((len(ln), 24, 128)).astype(np.float32),
                        rng6.integers(1, 2049, size=(len(ln), 128)))
    return {"k": k, "v": v, "shapes": shapes}


def timed(torch, fn, reps: int) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    ev[2].record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    ev[3].record()
    torch.cuda.synchronize()
    return {"ms": ev[2].elapsed_time(ev[3]) / reps,
            "ms_back_to_back": ev[0].elapsed_time(ev[1]) / reps,
            "host_us": 1e6 * host_s / reps}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".", help="checkout whose dynamo_tpu_torch is timed")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_ab needs a CUDA device")
    from dynamo_tpu_torch.models.quant import QMAX, pack_int4
    from dynamo_tpu_torch.ops import (
        _build,
        hopper_paged_attention as hp,
        hopper_paged_attention_local as hpl,
        kv_quant,
        paged_attention as pa,
    )

    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    build_s = time.perf_counter() - t0

    def quantize(x, fmt):  # as chip_smoke.quantize_layer
        if fmt == "none":
            return x
        bits = kv_quant.kv_quant_bits(fmt)
        x32 = x.float()
        s = x32.abs().amax(dim=(1, 3)) / QMAX[bits]
        q = torch.round(x32 / s.clamp(min=1e-30)[:, None, :, None]).clamp(-QMAX[bits], QMAX[bits])
        q = q.to(torch.int8)
        if bits == 4:
            q = pack_int4(q, axis=1)
        return kv_quant.QuantKV(q.contiguous(), s.contiguous(), bits, x.shape[1])

    draws = smoke_draws(args.seed)
    k = torch.from_numpy(draws["k"]).to(dev, torch.bfloat16)
    v = torch.from_numpy(draws["v"]).to(dev, torch.bfloat16)
    shapes = {name: (torch.tensor(ln, dtype=torch.int32, device=dev),
                     torch.from_numpy(q).to(dev, torch.bfloat16),
                     torch.from_numpy(tb.astype(np.int32)).to(dev))
              for name, (ln, q, tb) in draws["shapes"].items()}
    lens64 = shapes["B64"][0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    loc = [torch.randn((64, 8, 8, 128), generator=gen, device=dev).to(torch.bfloat16)
           for _ in range(2)]
    step = torch.tensor([7], dtype=torch.int32, device=dev)
    out = {"tree": tree, "build_s": build_s, "nvcc_s": _build.build_seconds,
           "reps": args.reps, "mean_len_B64": float(lens64.clamp(min=1).float().mean()),
           "decode": {}, "local": {}}

    def run(fn, plain, wrapper):
        err = (fn().float() - plain().float()).abs().max().item()
        return {**timed(torch, fn, args.reps), "max_abs_err": err,
                "splits": getattr(wrapper, "last_splits", None)}

    for fmt in FORMATS:
        kk, vv = quantize(k, fmt), quantize(v, fmt)
        for name, (ln, q, tb) in shapes.items():
            dargs = (q, kk, vv, tb, ln)
            out["decode"][f"{name}/{fmt}"] = run(
                lambda: pa.paged_attention_decode(*dargs),
                lambda: pa.paged_attention_decode_plain(*dargs), hp)
            B = q.shape[0]
            largs = (q, kk, vv, tb, (ln - 1).clamp(min=0), loc[0][:B], loc[1][:B], step)
            out["local"][f"{name}/{fmt}"] = run(
                lambda: pa.paged_attention_decode_mixed(*largs),
                lambda: pa.paged_attention_decode_mixed_plain(*largs), hpl)
        del kk, vv
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
