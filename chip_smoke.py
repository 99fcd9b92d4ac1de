#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the Hopper kernels from dynamo_tpu_torch/csrc, holds each against its
plain PyTorch version on the card, holds the three model forwards against
the same forwards fed the plain attention, then serves a few requests
through `TorchEngine.generate` at the full width of Llama-3.2-3B (random
weights from --seed) and checks that the main path went through the
kernels. Every phase prints one JSON line; any failure raises (non-zero
exit). The last line of output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
It exits non-zero without printing a result when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import subprocess
import sys
import time

import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

import numpy as np  # noqa: E402

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine  # noqa: E402
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest  # noqa: E402
from dynamo_tpu_torch.llm.tokenizers import ByteTokenizer  # noqa: E402
from dynamo_tpu_torch.models import llama  # noqa: E402
from dynamo_tpu_torch.ops import (  # noqa: E402
    _build,
    hopper_paged_attention,
    hopper_prefill_attention,
    hopper_ragged_attention,
    paged_attention as pa,
)
from dynamo_tpu_torch.runtime.engine import Context  # noqa: E402

DEV = torch.device("cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device-memory rate (data sheet)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core rate (data sheet)
TOL_F32_TINY = 2e-3  # f32: only the softmax summation order differs
TOL_BF16_FULL = 5e-2  # bf16: probabilities/outputs round at other places
# bf16 at full width, per output row (one token x one head, D values):
# |out - ref|_2 / |ref|_2. Long-context rows are small (~1/sqrt(keys)), so
# the absolute limit alone would pass a kernel that dropped a page there.
TOL_BF16_ROW_REL = 2e-2
# bf16 logits / written pages of a 2-layer forward, kernel vs plain attention,
# per row (one token's logits; one token x one KV head of a page) as
# |a - b|_2 / |b|_2: the two attentions differ by bf16 rounding (the kernel
# keeps probabilities in f32, the plain version rounds them to bf16 as the
# reference does), and a one-ulp flip (2^-8 relative) is carried through the
# residual stream and the next layer. Layer 0's pages do not depend on
# attention and must be equal bit for bit.
TOL_FORWARD_REL = 3e-2
LAYERS = 28  # Llama-3.2-3B's own depth
MAX_TOKENS = 64  # output tokens of every served request
STAGGER_S = 0.08  # gap between request arrivals in the serve phase

KERNELS = {
    "paged_decode": {
        "module": hopper_paged_attention,
        "source": "dynamo_tpu_torch/csrc/paged_decode.cu",
        "replaces": "dynamo_tpu/ops/pallas_paged_attention.py:514",
    },
    "prefill_attention": {
        "module": hopper_prefill_attention,
        "source": "dynamo_tpu_torch/csrc/prefill_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_prefill_attention.py:250",
    },
    "ragged_attention": {
        "module": hopper_ragged_attention,
        "source": "dynamo_tpu_torch/csrc/ragged_attention.cu",
        "replaces": "dynamo_tpu/ops/pallas_ragged_attention.py:336",
    },
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(fn, warm: int = 3, reps: int = 20) -> float:
    """Mean device milliseconds of fn() over `reps` launches (CUDA events)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, flops: float) -> tuple:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    err = (a.float() - b.float()).abs().max().item()
    if not (torch.isfinite(a.float()).all() and err == err):
        raise AssertionError("kernel output is not finite")
    return err


def row_rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b|_2 / |b|_2 over rows (the last dim); a row that is zero
    in both counts as 0."""
    a, b = a.float(), b.float()
    num = (a - b).norm(dim=-1)
    return (num / b.norm(dim=-1).clamp(min=1e-6)).max().item()


def make_pool(rng, pages, ps, KH, D, dtype):
    shape = (pages, ps, KH, D)
    k = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DEV, dtype)
    v = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(DEV, dtype)
    return k, v


def rand_tables(rng, rows, P, pages):
    # random physical pages (>= 1: page 0 is the scratch page), with repeats
    return torch.from_numpy(
        rng.integers(1, pages, size=(rows, P)).astype(np.int32)).to(DEV)


def i32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=DEV)


def sdpa_ms(q, k, v, mask) -> float:
    """One scaled_dot_product_attention call over the gathered context
    (q [B, H, T, D], k/v [B, KH, S, D], mask [B, 1, T, S]); a yardstick only."""
    G = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    f = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: f(q, k, v, attn_mask=mask), warm=2, reps=10)


# ---------------------------------------------------------------------- #
# phase: kernels
# ---------------------------------------------------------------------- #


def decode_case(rng, B, H, KH, D, ps, P, pages, dtype, lens):
    k, v = make_pool(rng, pages, ps, KH, D, dtype)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32)).to(DEV, dtype)
    return q, k, v, rand_tables(rng, B, P, pages), i32(lens)


def check_decode(rng, measured):
    # tiny f32: GQA 2, page-straddling lengths, an empty lane
    q, k, v, tab, lens = decode_case(
        rng, 5, 4, 2, 16, 8, 6, 40, torch.float32, [1, 8, 9, 37, 0])
    err = max_err(pa.paged_attention_decode(q, k, v, tab, lens),
                  pa.paged_attention_decode_plain(q, k, v, tab, lens))
    torch.cuda.synchronize()
    assert err <= TOL_F32_TINY, f"paged_decode f32 tiny: {err}"
    # full width bf16: the engine's decode shape (64 lanes, 128-entry tables)
    B, H, KH, D, ps, P = 64, 24, 8, 128, 64, 128
    lens = rng.integers(1, 2049, size=B)
    lens[:4] = [0, 1, 64, 65]
    q, k, v, tab, lens_t = decode_case(rng, B, H, KH, D, ps, P, 2049, torch.bfloat16, lens)
    out = pa.paged_attention_decode(q, k, v, tab, lens_t)
    ref = pa.paged_attention_decode_plain(q, k, v, tab, lens_t)
    torch.cuda.synchronize()
    err_full = max_err(out, ref)
    rel_full = row_rel_err(out, ref)
    assert err_full <= TOL_BF16_FULL, f"paged_decode bf16 full: {err_full}"
    assert rel_full <= TOL_BF16_ROW_REL, f"paged_decode bf16 full, per row: {rel_full}"
    ctx = np.maximum(lens, 1).astype(np.float64)
    bytes_moved = ctx.sum() * KH * D * 2 * 2 + 2 * q.numel() * 2
    flops = 4.0 * H * D * ctx.sum()
    b_ms, b_by = bound(bytes_moved, flops)
    # library yardstick: SDPA over the dense gathered context
    S = P * ps
    kd = k[tab.long()].reshape(B, S, KH, D).transpose(1, 2).contiguous()
    vd = v[tab.long()].reshape(B, S, KH, D).transpose(1, 2).contiguous()
    mask = (torch.arange(S, device=DEV)[None, :] < lens_t.clamp(min=1)[:, None])[:, None, None, :]
    lib = sdpa_ms(q[:, :, None, :], kd, vd, mask)
    del kd, vd
    measured["paged_decode"] = {
        "max_abs_err": err_full, "max_row_rel_err": rel_full, "max_abs_err_f32_tiny": err,
        "ms": time_ms(lambda: pa.paged_attention_decode(q, k, v, tab, lens_t)),
        "plain_ms": time_ms(lambda: pa.paged_attention_decode_plain(q, k, v, tab, lens_t), 1, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"B={B} H={H} KH={KH} D={D} ps={ps} tables=[{B},{P}] mean_len={ctx.mean():.0f}",
    }


def prefill_case(rng, B, T, H, KH, D, ps, P, pages, dtype, starts, reals):
    k, v = make_pool(rng, pages, ps, KH, D, dtype)
    q = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32)).to(DEV, dtype)
    starts = np.asarray(starts)
    totals = starts + np.asarray(reals)
    pos = i32(starts[:, None] + np.arange(T)[None, :])
    return q, k, v, pos, rand_tables(rng, B, P, pages), i32(totals), i32(starts)


def check_prefill(rng, measured):
    # tiny f32: history + chunk, page-straddling, a padded tail, a dummy lane
    args = prefill_case(rng, 3, 24, 4, 2, 16, 8, 9, 40, torch.float32,
                        starts=[0, 13, 0], reals=[24, 17, 1])
    err = max_err(pa.prefill_attention_batched(*args),
                  pa.prefill_attention_batched_plain(*args))
    torch.cuda.synchronize()
    assert err <= TOL_F32_TINY, f"prefill_attention f32 tiny: {err}"
    H, KH, D, ps = 24, 8, 128, 64
    errs, rels = {}, {}
    # the engine's batch shape: 8 lanes x bucket 128, varied history
    a8 = prefill_case(rng, 8, 128, H, KH, D, ps, 17, 2049, torch.bfloat16,
                      starts=[0, 64, 100, 256, 512, 777, 900, 0],
                      reals=[128, 128, 90, 128, 128, 33, 128, 1])
    out, ref = pa.prefill_attention_batched(*a8), pa.prefill_attention_batched_plain(*a8)
    errs["B8_T128"], rels["B8_T128"] = max_err(out, ref), row_rel_err(out, ref)
    # the lone-arrival shape: 1 lane x bucket 1024, second chunk of a prompt
    B, T, P, start = 1, 1024, 33, 1024
    a1 = prefill_case(rng, B, T, H, KH, D, ps, P, 2049, torch.bfloat16,
                      starts=[start], reals=[T])
    q, k, v, pos, tab, totals, starts = a1
    out, ref = pa.prefill_attention_batched(*a1), pa.prefill_attention_batched_plain(*a1)
    errs["B1_T1024"], rels["B1_T1024"] = max_err(out, ref), row_rel_err(out, ref)
    torch.cuda.synchronize()
    del out, ref
    err_full, rel_full = max(errs.values()), max(rels.values())
    assert err_full <= TOL_BF16_FULL, f"prefill_attention bf16 full: {errs}"
    assert rel_full <= TOL_BF16_ROW_REL, f"prefill_attention bf16 full, per row: {rels}"
    visible = float(sum(min(start + i + 1, start + T) for i in range(T)))
    bytes_moved = (start + T) * KH * D * 2 * 2 + 2 * q.numel() * 2
    b_ms, b_by = bound(bytes_moved, 4.0 * H * D * visible)
    S = P * ps
    kd = k[tab.long()].reshape(B, S, KH, D).transpose(1, 2).contiguous()
    vd = v[tab.long()].reshape(B, S, KH, D).transpose(1, 2).contiguous()
    key = torch.arange(S, device=DEV)
    mask = ((key[None, None, :] <= pos[:, :, None]) &
            (key[None, None, :] < totals[:, None, None]))[:, None]
    lib = sdpa_ms(q.transpose(1, 2), kd, vd, mask)
    del kd, vd
    measured["prefill_attention"] = {
        "max_abs_err": err_full, "max_row_rel_err": rel_full,
        "max_abs_err_f32_tiny": err, "errs": errs, "row_rel_errs": rels,
        "ms": time_ms(lambda: pa.prefill_attention_batched(*a1)),
        "plain_ms": time_ms(lambda: pa.prefill_attention_batched_plain(*a1), 1, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"B={B} T={T} H={H} KH={KH} D={D} ps={ps} start={start} total={start + T}",
    }


def ragged_case(rng, N, R, H, KH, D, ps, P, pages, dtype, rows):
    """rows: list of (row_len, ctx_len), packed densely in order."""
    k, v = make_pool(rng, pages, ps, KH, D, dtype)
    q = torch.from_numpy(rng.standard_normal((N, H, D)).astype(np.float32)).to(DEV, dtype)
    row_starts = np.full((R,), N, np.int32)
    row_lens = np.zeros((R,), np.int32)
    ctx_lens = np.zeros((R,), np.int32)
    off = 0
    for r, (ln, ctx) in enumerate(rows):
        row_starts[r], row_lens[r], ctx_lens[r] = off, ln, ctx
        off += ln
    assert off <= N
    real = torch.zeros((N,), dtype=torch.bool, device=DEV)
    real[:off] = True
    return (q, k, v, rand_tables(rng, R, P, pages), i32(row_starts), i32(row_lens),
            i32(ctx_lens)), real


def check_ragged(rng, measured):
    # tiny f32: decode rows + prefill rows, page-straddling, a padding row,
    # a decode row with no history, tail padding tokens
    rows = [(1, 12), (11, 0), (1, 0), (20, 7), (1, 8), (5, 16)]
    args, real = ragged_case(rng, 64, 8, 4, 2, 16, 8, 6, 40, torch.float32, rows)
    out, ref = pa.ragged_attention(*args), pa.ragged_attention_plain(*args)
    torch.cuda.synchronize()
    err = max_err(out[real], ref[real])
    assert err <= TOL_F32_TINY, f"ragged_attention f32 tiny: {err}"
    assert torch.isfinite(out.float()).all(), "ragged padding tokens are not finite"
    # full width bf16: one 1024-token chunk with history beside 48 decode lanes
    H, KH, D, ps, P, N, R = 24, 8, 128, 64, 33, 2048, 128
    rows = [(1024, 512), (200, 0)] + [(1, int(c)) for c in rng.integers(0, 2048, size=48)]
    args, real = ragged_case(rng, N, R, H, KH, D, ps, P, 2049, torch.bfloat16, rows)
    out, ref = pa.ragged_attention(*args), pa.ragged_attention_plain(*args)
    torch.cuda.synchronize()
    err_full, rel_full = max_err(out[real], ref[real]), row_rel_err(out[real], ref[real])
    assert err_full <= TOL_BF16_FULL, f"ragged_attention bf16 full: {err_full}"
    assert rel_full <= TOL_BF16_ROW_REL, f"ragged_attention bf16 full, per row: {rel_full}"
    visible = sum(sum(min(c + j + 1, c + ln) for j in range(ln)) for ln, c in rows)
    ctx_bytes = sum(c + ln for ln, c in rows) * KH * D * 2 * 2
    n_real = sum(ln for ln, _ in rows)
    b_ms, b_by = bound(ctx_bytes + 2 * n_real * H * D * 2, 4.0 * H * D * visible)
    # library yardstick: the rows scattered into a padded batch [rows, Tmax]
    # against each row's densely gathered context, one masked SDPA call
    q, k, v, tab, row_starts, row_lens, ctx_lens = args
    Rr, Tmax, S = len(rows), max(ln for ln, _ in rows), P * ps
    qp = torch.zeros((Rr, Tmax, H, D), dtype=q.dtype, device=DEV)
    off = 0
    for r, (ln, _) in enumerate(rows):
        qp[r, :ln] = q[off:off + ln]
        off += ln
    qp = qp.transpose(1, 2).contiguous()
    kd = k[tab[:Rr].long()].reshape(Rr, S, KH, D).transpose(1, 2).contiguous()
    vd = v[tab[:Rr].long()].reshape(Rr, S, KH, D).transpose(1, 2).contiguous()
    key = torch.arange(S, device=DEV)[None, None, :]
    pos = ctx_lens[:Rr, None] + torch.arange(Tmax, device=DEV)[None, :]
    mask = ((key <= pos[:, :, None]) &
            (key < (ctx_lens + row_lens)[:Rr, None, None]))[:, None]
    lib = sdpa_ms(qp, kd, vd, mask)
    del qp, kd, vd, mask
    measured["ragged_attention"] = {
        "max_abs_err": err_full, "max_row_rel_err": rel_full, "max_abs_err_f32_tiny": err,
        "ms": time_ms(lambda: pa.ragged_attention(*args)),
        "plain_ms": time_ms(lambda: pa.ragged_attention_plain(*args), 1, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"N={N} R={R} H={H} KH={KH} D={D} ps={ps} rows=1024@512+200@0+48 decode",
    }


def phase_kernels(seed: int) -> dict:
    measured: dict = {}
    rng = np.random.default_rng(seed)
    check_decode(rng, measured)
    torch.cuda.empty_cache()
    check_prefill(rng, measured)
    torch.cuda.empty_cache()
    check_ragged(rng, measured)
    torch.cuda.empty_cache()
    emit("kernels", tol_f32_tiny=TOL_F32_TINY, tol_bf16_full=TOL_BF16_FULL,
         tol_bf16_row_rel=TOL_BF16_ROW_REL, kernels=measured)
    return measured


# ---------------------------------------------------------------------- #
# phase: forward (kernels vs plain attention inside the model forwards)
# ---------------------------------------------------------------------- #


@torch.no_grad()
def phase_forward(seed: int) -> None:
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=2)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    params = llama.init_params(cfg, gen, device=DEV)
    rng = np.random.default_rng(seed + 1)
    ps, pages = 64, 64
    tok = lambda *shape: i32(rng.integers(5, cfg.vocab_size, size=shape))  # noqa: E731
    worst = {}

    def both(fn, *args_before_kv, after_kv):
        outs = []
        for arm, (kk, kv_) in enumerate(pools):
            logits, _, _ = fn(params, cfg, *args_before_kv, kk, kv_, *after_kv,
                              plain_attention=bool(arm))
            outs.append(logits)
        torch.cuda.synchronize()
        return outs

    def new_pool():
        return (torch.zeros((2, pages, ps, cfg.num_kv_heads, cfg.head_dim),
                            dtype=cfg.dtype, device=DEV),
                torch.zeros((2, pages, ps, cfg.num_kv_heads, cfg.head_dim),
                            dtype=cfg.dtype, device=DEV))

    pools = [new_pool(), new_pool()]  # arm 0: kernels, arm 1: plain attention

    def record(name, outs):
        max_err(outs[0], outs[1])  # finite
        worst[name + "_logits"] = row_rel_err(outs[0], outs[1])
        # page 0 is the scratch page: pads and idle lanes all write one slot
        for kv, (a, b) in zip("kv", zip(pools[0], pools[1])):
            assert torch.equal(a[0, 1:], b[0, 1:]), f"{name}: layer-0 {kv} pages differ"
            worst[f"{name}_pages_{kv}1"] = row_rel_err(a[1, 1:], b[1, 1:])

    # two sequences of 16 pages each (+ a scratch tail entry), two chunks of
    # 256 tokens each (the second attends history)
    B, T, P = 2, 256, 17
    pad_pos = P * ps - 1
    tables = torch.zeros((B, P), dtype=torch.int32, device=DEV)
    tables[:, :16] = i32(np.arange(1, 1 + B * 16).reshape(B, 16))
    toks = tok(B, T)
    pos = i32(np.arange(T)[None, :].repeat(B, 0))
    record("prefill_chunk0", both(
        llama.prefill_forward_batched, toks, pos,
        after_kv=(tables, i32([0, 0]), i32([T - 1, T - 1]))))
    pos2 = pos + T
    pos2[1, 200:] = pad_pos  # lane 1: a 200-token chunk, padded tail
    record("prefill_chunk1", both(
        llama.prefill_forward_batched, tok(B, T), pos2,
        after_kv=(tables, i32([T, T]), i32([T - 1, 199]))))
    # decode step: the two sequences plus two inactive (scratch-row) lanes,
    # whose logits are garbage by contract and are not compared
    dec_tables = torch.zeros((4, P), dtype=torch.int32, device=DEV)
    dec_tables[:2] = tables
    outs = both(
        llama.decode_forward, tok(4), i32([2 * T, T + 200, 0, 0]),
        after_kv=(dec_tables, i32([2 * T + 1, T + 201, 0, 0])))
    record("decode", [o[:2] for o in outs])
    # ragged: a fresh 100-token chunk (row 0, new pages) + both decode lanes
    N, R = 128, 8
    rag_tables = torch.zeros((R, P), dtype=torch.int32, device=DEV)
    rag_tables[0, :8] = i32(np.arange(40, 48))
    rag_tables[1:3] = tables
    row_starts = i32([0, 100, 101] + [N] * 5)
    row_lens = i32([100, 1, 1] + [0] * 5)
    ctx_lens = i32([0, 2 * T + 1, T + 201] + [0] * 5)
    positions = torch.full((N,), pad_pos, dtype=torch.int32, device=DEV)
    positions[:100] = torch.arange(100, device=DEV)
    positions[100], positions[101] = 2 * T + 1, T + 201
    row_ids = torch.full((N,), R - 1, dtype=torch.int32, device=DEV)
    row_ids[:100], row_ids[100], row_ids[101] = 0, 1, 2
    outs = both(
        llama.ragged_forward, tok(N), positions, row_ids,
        after_kv=(rag_tables, row_starts, row_lens, ctx_lens, i32([99, 100, 101] + [0] * 5)))
    record("ragged", [o[:3] for o in outs])
    bad = {k: v for k, v in worst.items() if not v <= TOL_FORWARD_REL}
    emit("forward", layers=2, dtype="bfloat16", tol_rel=TOL_FORWARD_REL,
         layer0_pages_equal=True, max_row_rel_err=worst)
    assert not bad, f"forward: kernels vs plain attention disagree: {bad}"


# ---------------------------------------------------------------------- #
# phase: serve
# ---------------------------------------------------------------------- #


def pct(xs, p):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p)) if xs else None


async def run_request(engine, req: dict, record: dict, after=None) -> None:
    """Stream one request into `record`; `after` (an asyncio.Event) delays
    the submission until another request has produced its first token."""
    if after is not None:
        await after.wait()
    t0 = time.perf_counter()
    last = t0
    async for item in engine.generate(req, Context()):
        if item.get("event") == "error":
            raise RuntimeError(f"engine error: {item}")
        data = item.get("data")
        if not data:
            continue
        now = time.perf_counter()
        n = len(data["token_ids"])
        if n:
            if not record["tokens"]:
                record["ttft_s"] = now - t0
                record["first"].set()
            else:
                record["itl_s"].extend([(now - last) / n] * n)
            record["tokens"].extend(data["token_ids"])
            last = now
        if data.get("finish_reason"):
            record["finish"] = data["finish_reason"]
    record["done_s"] = time.perf_counter() - t0


async def serve(seed: int) -> dict:
    model_cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=LAYERS)
    engine = TorchEngine(
        EngineConfig(model="llama3-3b", seed=seed), model_config=model_cfg,
        device="cuda",
    )
    t0 = time.perf_counter()
    n_warm = await engine.warmup()
    warm_s = time.perf_counter() - t0
    tok = ByteTokenizer(model_cfg.vocab_size)
    rng = np.random.default_rng(seed)
    words = ["paged", "attention", "kernel", "hopper", "decode", "prefill",
             "ragged", "token", "cache", "block", "stream", "engine"]

    def text(n_tokens: int, salt: int) -> list:
        out = f"request {salt}: "
        while len(out) < n_tokens:
            out += words[int(rng.integers(len(words)))] + " "
        return tok.encode(out[:n_tokens])

    shared = text(256, 99)  # four full pages of common prefix
    lengths = [40, 300, 1500, 120, 700, 64, 1100, 40, 500, 900, 220, 1300]
    reqs = []
    for i, n in enumerate(lengths):
        ids = text(n, i)
        sampling = {}
        if i in (1, 8):
            ids = shared + ids[256:] if n > 256 else shared + ids
        if i in (3, 10):  # two differently seeded sampled streams in the traffic
            sampling = {"temperature": 0.7, "seed": 1000 + i}
        reqs.append(PreprocessedRequest(
            token_ids=ids, request_id=f"smoke-{i}",
            stop_conditions={"max_tokens": MAX_TOKENS},
            sampling_options=sampling,
        ).to_dict())

    # counts to zero just before the main path is driven
    for k in KERNELS.values():
        k["module"].launch_count = 0
    for name in pa.plain_calls:
        pa.plain_calls[name] = 0
    torch.cuda.reset_peak_memory_stats()
    base = engine.stats()

    def new_record():
        return {"tokens": [], "itl_s": [], "finish": None, "first": asyncio.Event()}

    records = [new_record() for _ in reqs]
    t_start = time.perf_counter()
    tasks = []
    for i, (req, rec) in enumerate(zip(reqs, records)):
        # the second shared-prefix request arrives once the first has its
        # first token (its prompt pages are committed by then), whatever
        # the host's speed
        after = records[1]["first"] if i == 8 else None
        tasks.append(asyncio.create_task(run_request(engine, req, rec, after)))
        await asyncio.sleep(STAGGER_S)
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t_start
    launches = {name: k["module"].launch_count for name, k in KERNELS.items()}
    plain = dict(pa.plain_calls)
    stats = engine.stats()

    # seeded reproducibility: the same seeded request twice, each alone on
    # the engine (identical dispatch shapes, so the arithmetic is identical)
    seeded = PreprocessedRequest(
        token_ids=text(40, 777), stop_conditions={"max_tokens": MAX_TOKENS},
        sampling_options={"temperature": 0.7, "seed": 4242},
    )
    pair = []
    for run in range(2):
        rec = new_record()
        req = dict(seeded.to_dict(), request_id=f"seeded-{run}")
        await run_request(engine, req, rec)
        pair.append(rec["tokens"])
    await engine.close()

    for i, rec in enumerate(records):
        assert rec["finish"] == "length", f"request {i} finished with {rec['finish']}"
        assert len(rec["tokens"]) == MAX_TOKENS, (i, len(rec["tokens"]))
        assert all(0 <= t < model_cfg.vocab_size for t in rec["tokens"]), i
    assert pair[0] == pair[1] and len(pair[0]) == MAX_TOKENS, \
        "the two runs of the seeded request differ"
    assert all(n > 0 for n in launches.values()), f"a path kernel never launched: {launches}"
    assert not any(plain.values()), f"plain attention ran on the card's main path: {plain}"
    mixed = stats["mixed_steps"] - base["mixed_steps"]
    hits = (stats["kv_prefix_hit_blocks_total"] - base["kv_prefix_hit_blocks_total"]
            + stats["kv_skip_ahead_blocks"] - base["kv_skip_ahead_blocks"])
    assert mixed >= 1, "no mixed step ran"
    assert hits > 0, "the shared prefix never hit the prefix cache"

    dev_time = {}
    for tag, cur in stats["dev_time"].items():
        prev = base["dev_time"].get(tag, {"count": 0, "seconds": 0.0})
        n = cur["count"] - prev["count"]
        s = cur["seconds"] - prev["seconds"]
        if n:
            dev_time[tag] = {"count": n, "seconds": round(s, 4),
                             "ms_per_dispatch": round(1e3 * s / n, 3)}
    n_out = sum(len(r["tokens"]) for r in records)
    itl = [x for r in records for x in r["itl_s"]]
    ttft = [r["ttft_s"] for r in records]
    emit(
        "serve", model="llama-3.2-3b", layers=LAYERS, dtype="bfloat16",
        requests=len(reqs), prompt_tokens=[len(r["token_ids"]) for r in reqs],
        max_tokens=MAX_TOKENS, warmup_dispatches=n_warm,
        warmup_s=round(warm_s, 3), wall_s=round(wall, 3),
        output_tok_s=round(n_out / wall, 1),
        ttft_ms={"p50": round(1e3 * pct(ttft, 50), 2), "p99": round(1e3 * pct(ttft, 99), 2)},
        itl_ms={"p50": round(1e3 * pct(itl, 50), 3), "p99": round(1e3 * pct(itl, 99), 3)},
        mixed_steps=mixed, split_steps=stats["split_steps"] - base["split_steps"],
        prefix_hit_blocks=hits, num_preemptions=stats["num_preemptions"],
        launches=launches, plain_calls=plain, dev_time=dev_time,
        seeded_pair_equal=True,
        peak_memory_gib=round(torch.cuda.max_memory_allocated() / 2**30, 2),
    )
    return launches


# ---------------------------------------------------------------------- #


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_all = time.perf_counter()

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    nvcc = subprocess.run([_build.find_nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-2:]
    emit("env", nvidia_smi=smi.splitlines(), torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0])

    t0 = time.perf_counter()
    _build.load_library()
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         nvcc_seconds=None if _build.build_seconds is None else round(_build.build_seconds, 2),
         sources=sorted(p.name for p in _build.CSRC_DIR.glob("*.cu*")))

    measured = phase_kernels(args.seed)
    phase_forward(args.seed)
    launches = asyncio.run(serve(args.seed))

    line = {"kernels": [
        {
            "name": name, "route": "cuda", "source": k["source"],
            "replaces": k["replaces"], "launches": launches[name],
            **{key: measured[name][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        }
        for name, k in KERNELS.items()
    ]}
    emit("total", seconds=round(time.perf_counter() - t_all, 1))
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
