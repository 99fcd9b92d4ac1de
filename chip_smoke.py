#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py            # needs one CUDA device and nvcc

Builds the Hopper kernels from dynamo_tpu_torch/csrc, holds each kernel in
each KV format (bf16/f32 pages, int8, int4) against its plain PyTorch
version on the card (prefill and ragged attention in both of their bodies:
f32 on the FMA body, bf16 on the tensor-core body at tiny width, at full
width and at 2, 3, 4 and 8 query heads per KV head; both split-KV decode
kernels at tiny width across split boundaries in f32 and bf16, with
quantized rows only 8-byte aligned (the local one at 1, 8 and 64
block-local rows, first and last step), at 3 and 16 query heads per KV
head (plain decode also at 4 and 8), and timed at three shapes: 64 lanes,
4 long lanes, 64 lanes of which 12 are live;
every kernel timed with its calls queued behind a device sleep and issued
back to back, with the host's time a call), holds the card's
quantized page writes to the CPU's
bit for bit, holds the model forwards against the same forwards fed the
plain attention, then serves a few requests through `TorchEngine.generate`
at the full width of Llama-3.2-3B (random weights from --seed; bf16 KV at
28 layers, the quantized pools at 4) in each
decode-pool mode and KV format, and checks that every served path went
through the kernels. The worker phase then serves the same model over the
wire: in one event loop the port's discovery server, a port worker
(`dynamo_tpu_torch.worker.serve`) around the engine and a PushRouter
client, at (scatter, bf16) and (local, int8) (4 layers each), 8
requests each in process and over the wire (tok/s, TTFT, ITL side by
side; each request alone must stream the same tokens both ways; the
kernels must carry the wire's traffic; KV events and worker metrics must
reach their topics), and
finally `python -m dynamo_tpu_torch.worker --model llama3-3b` as a
subprocess with its pool auto-sized, which must register, answer a request
and drain on SIGTERM. The disagg phases split serving between a prefill
and a decode engine (1,024 pages each) on the worker phase's requests, all
prefilled remotely: `disagg` (4 layers, bf16, scatter) and
`disagg_local_int8` (4 layers) put the two engines in this process, the
KV pages handed over as CUDA tensors through the data plane's in-process
registry and the decode side driven through its disagg handler (streamed
handoff), then time one serial handoff of the longest prompt over TCP and
in process (extract, inject and socket ms a page, GB/s); `disagg_subprocess`
first serves the same mix from one aggregated `python -m
dynamo_tpu_torch.worker` of the same pool (its baseline: the wire without
the handoff), then runs `--role prefill` and `--role decode` as two
processes with the handoff over TCP, driven through a PushRouter, and
pulls one staged prompt across processes (its CLI workers serve the
4-layer `weights_load` checkpoint, so the worker phase's in-process
streams are its reference).
Each checks that every
request alone streams the same tokens as the aggregated engine, and that
the prefill side launched only prefill attention and the decode side only
its decode kernel (per process, from the stats each worker publishes).
The weights phases: `weights_int8` quantizes the weights to int8 on the
card (`quantize_tree`), holds the int8 products and the 28-layer f32
forward to the same over the dequantized weights, and serves the worker
phase's mix on int8 beside bf16 weights in (scatter, bf16 KV; 4 layers)
and (local, int8 KV; 4 layers), with one decode step profiled on each (4
layers); `weights_load` writes the weights' first 4 layers as a BF16
safetensors checkpoint whose config.json says 4 layers, loads it back bit
for bit (seconds, GB/s, host memory), and `python -m
dynamo_tpu_torch.worker --model-path <it> --quantize int8` (pool
auto-sized, its depth from the config.json) must register, stream each request alone as the in-process
int8 engine does and drain on SIGTERM; `weights_gguf` writes a 2-layer
full-width q8_0 .gguf with a vocabulary, loads it with and without int8,
holds every matrix to numpy's decode of the file and serves two requests
from each.
The KVBM phases: `kvbm` (scatter, bf16 KV, 4 layers) and
`kvbm_local_int8` (4 layers) serve three waves on a 200-page pool — A (8
sessions of 2,048 tokens, each alone), B (8 other prompts, staggered, which
push A out of the pool), A2 (each A session extended by a 256-token turn,
alone) — with KVBM off (recompute) and on (256 host + 512 disk blocks): A2
must onboard from both tiers, stream the same tokens as recompute, launch
the prefill kernel over the onboarded pages, and the tier copies must equal
the device pages bit for bit; `kvbm` adds an sla-policy run (which arm the
onboard budget picks for host and disk spans) and a warm restart on the
same disk pool.
`kvbm_peer` starts `python -m dynamo_tpu_torch.frontend --router-mode kv
--embed-discovery` and two CLI workers (serving the 4-layer weights_load
checkpoint) with host tiers, KV events, the status server,
canaries and session checkpoints; worker 2 must pull worker 1's blocks over
the data plane and stream its tokens, and both /metrics, /health and /live
are read; then the frontend is driven over HTTP (its `frontend` line,
below); then four streams run through the port's Migration on worker 1,
beside one HTTP stream pinned there, and worker 1 is SIGKILLed mid-decode
once their prompts are checkpointed into worker 2: each must finish on
worker 2 as it did uninterrupted, resumed from the checkpoint (the resume
gap, the tokens recomputed and the checkpoint push ms a block are
printed), and the HTTP stream through the frontend's migration. `durable` does the same in one
process with two engines, the streams severed by a live `morph` of the
first; an injected morph error must roll it back to a routable role.
`disagg_subprocess` also morphs its prefill worker into a decode worker
over the wire (`morph` endpoint), serves a stream from it, and morphs it
back.
The `spec_guided` phases serve 8 greedy prompts built from repeated
phrases on a plain engine, a split-spec engine (`spec_mode="ngram"`, mixed
dispatch off: spec blocks verify on the prefill kernel at B=64, T=5) and a
fused-spec engine (verify rows on the ragged kernel, a staircase of 5 rows a
lane) — `spec_guided` at 4 layers, bf16 KV; `spec_guided_int8` and
`spec_guided_int4` at 4 layers — and hold each spec stream equal to the
plain one, or parted only at a near-tie (the plain logits' top-two gap at
the first divergent position within SPEC_GAP_ULPS bf16 ulps; in a quantized
pool both tokens within that plus the pool's quantization shift of the top
logit); guided choice
and json_schema requests on the plain and the fused-spec engines must fit
their constraint, and in `spec_guided` the ITL of 4 unguided lanes is read
alone and beside a guided lane. The kernel phase holds the prefill kernel
at the verify shape and the ragged kernel on the staircase against their
plain versions in every format and times them (the `@verify` and
`@staircase` entries of the kernels line).
The `lora` phase writes a rank-8 and a rank-16 PEFT export, loads them and
draws a `random:SEED` adapter, and serves 12 requests arriving together (4
base, 8 over the three adapters; 8 layers, bf16, scatter, mixed on, 4
device slots) beside the same mix all-base on a plain engine: base
streams must equal the plain engine's, every LoRA stream must differ from
its base stream and equal its solo run or part at a near-tie
(LORA_GAP_ULPS at the solo logits with the adapter), and the prefill,
ragged and decode kernels must carry the LoRA traffic (tok/s, TTFT, ITL,
the LoRA block's device ms beside the plain block's, mixed_rows_lora).
`lora_f32` (4 layers, f32) holds the three LoRA forwards on the card to
the same on the CPU and needs LoRA streams equal to their solo runs;
`lora_pool` (one slot, three adapters) drives a hit, a miss with an
eviction, a refusal under a pinned slot and an injected `lora.onboard`
error through an engine and holds its counters to the port's pool on the
CPU. `worker_subprocess` runs its CLI worker with two `--lora` flags.
The MoE phases (models/moe.py: the llama attention over the same kernels,
the top-k capacity-bounded expert MLP): `moe_mlp` holds one Mixtral-width
MoE MLP layer in f32 on the card to the CPU at 64 and 2,048 tokens that
overflow the capacity (factor 1.25; equal kept (token, expert, slot) sets,
outputs within 2e-3); `moe_serve` serves the serve mix on Mixtral-8x7B at
full width and all 32 layers with int8 weights drawn and quantized on the
card one matrix at a time, a bf16 KV pool auto-sized in the room left
(scatter, mixed on), holds one decode step on the served pool through the
kernels to the same through plain attention (the plain run replaying the
kernel run's routing) and profiles its decode step (`moe_decode_step`:
busy ms, launches, wall, the weights' byte bound, the share spent widening
int8 to bf16); `moe_local_int8` (4 layers, bf16 weights, local pool, int8
KV) and `gptoss` (gpt-oss-120b widths at 2 layers: top-4 of 128 experts,
D=64 with 8 query heads a KV head) serve and check the same way; and
`moe_worker` writes a 2-layer Mixtral-named BF16 checkpoint whose
config.json gives the depth, and `python -m dynamo_tpu_torch.worker --model
mixtral-8x7b --model-path <it> --quantize int8` must register, stream 4
requests alone as an in-process int8 engine of the same weights does, and
drain on SIGTERM. `moe_launches` gives the MoE phases' share of the
kernels line's launches.
The multimodal phases (E/P/D: llm/multimodal.py, models/vit.py, the
engine's prefill splice): `vit` holds ViT-Base/16 with its projector to
3,072 in f32 on the card (TF32 off) to the port's CPU forward on the same
weights and pixels (2e-3), times its forward at B=1 beside its bound, and
times the decode and resize of a 640x480 PNG the smoke writes with zlib;
`mm_serve` serves 8 image requests (4 PNGs of 224x224, 320x240, 640x480
and 96x128, one or two a request) and 4 text requests, staggered, on
Llama-3.2-3B at 28 layers (bf16, scatter, mixed on) behind the in-process
ViT through `EncodeOperator`: every stream finishes, two exact repeats
stream as their first runs (or part at a near-tie) and, alone again, hit
the prefix cache into their last image, the same text with another image
gives other first-token logits, one spliced prefill through the kernels
matches plain attention, and the prefill, decode and ragged kernels carry
the traffic (TTFT of image and text requests, tok/s, encode ms and wire
bytes a part); `mm_worker` runs `python -m dynamo_tpu_torch.encode_worker
--encoder vit --vit-size base --model llama3-3b` and a CLI worker on the
weights_load checkpoint, drives 4 image requests through the port's
EncodeOperator and PushRouter, holds each stream to an in-process engine's
on the same checkpoint and stamped requests and the wire's embeddings to an
encoder from the same seed, and splits each hop's ms into decode, forward,
pack, unpack and the wire's rest. `mm_launches` gives their share of the
kernels line's launches.
The `frontend` line is `kvbm_peer`'s frontend over HTTP on asyncio
streams: /v1/models and /health, a streamed and a unary chat, a greedy
completion equal to the port tokenizer's decode of the same request
through a PushRouter, six requests each landing on the worker that holds
their five-page prefix (the workers' prefix-hit counters), the workers'
kernel launches over the HTTP traffic alone, the frontend's and the gate's
metrics, the frontend's absence from the card (no libcuda or torch mapped,
no extra compute process), TTFT and ITL of 8 prompts over HTTP beside
PushRouters' with each request on the same worker in both runs, and the
stream whose worker is SIGKILLed mid-decode finishing on the other
through the frontend's migration.
The `profiler` phase runs the SLA planner's pre-deployment sweep
(`planner.profiler.main --model llama3-3b`, in process) at full width and
28 layers with the default grids: single-sequence prefill at ISL 128-4,096
and decode at 15 (usage, context) points of 65,536 KV tokens, up to 243
lanes; the sweep must launch the prefill kernel exactly 560 times and the
paged-decode kernel 3,780 times with no plain call, and both kernels are
then held to their plain versions at its widest shapes and timed there
(the `@profile` entries of the kernels line). The `planner` phase profiles
the 4-layer checkpoint's depth on small grids, starts the port's frontend
and `python -m dynamo_tpu_torch.planner --connector local` over
`--role prefill|decode` CLI workers on that checkpoint: the cold start
must register one of each, closed-loop HTTP streams must make the planner
read finite TTFT and ITL and scale decode to two replicas by the
arithmetic PERF.md writes down, the third worker must serve a request
pinned to it, and SIGTERM must take the planner and every child down.
Every phase prints one JSON line; any failure raises (non-zero exit). The last line of output is
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
It exits non-zero without printing a result when there is no CUDA device.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import gc
import json
import math
import shutil
import subprocess
import sys
import time
import types
from functools import partial

import torch

if not torch.cuda.is_available():
    raise SystemExit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

import numpy as np  # noqa: E402

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine  # noqa: E402
from dynamo_tpu_torch.engine.engine import _resolve_model  # noqa: E402
from dynamo_tpu_torch.llm.protocols import PreprocessedRequest  # noqa: E402
from dynamo_tpu_torch.llm.tokenizers import ByteTokenizer  # noqa: E402
from dynamo_tpu_torch.models import llama  # noqa: E402
from dynamo_tpu_torch.models import loader  # noqa: E402
from dynamo_tpu_torch.models import moe  # noqa: E402
from dynamo_tpu_torch.models.quant import (  # noqa: E402
    QMAX,
    dequantize_leaf,
    head_leaf,
    is_quant,
    pack_int4,
    param_bytes,
    qdot,
    quantize_array,
    quantize_tree,
)
from dynamo_tpu_torch.ops import (  # noqa: E402
    _build,
    hopper_paged_attention,
    hopper_paged_attention_local,
    hopper_prefill_attention,
    hopper_ragged_attention,
    kv_quant,
    paged_attention as pa,
)
from dynamo_tpu_torch.runtime.engine import Context  # noqa: E402
from dynamo_tpu_torch.tools import decode_profile, hash_cost  # noqa: E402

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
# |a - b|_2 / |b|_2: the two attentions differ by bf16 rounding (the decode
# kernels keep probabilities in f32; the prefill/ragged tensor-core body
# rounds unnormalised probabilities to bf16, the plain version normalised
# ones, as the reference does), and a one-ulp flip (2^-8 relative) is
# carried through the residual stream and the next layer. Layer 0's pages do
# not depend on attention and must be equal bit for bit.
TOL_FORWARD_REL = 3e-2
LAYERS = 28  # Llama-3.2-3B's own depth
MAX_TOKENS = 64  # output tokens of every served request
STAGGER_S = 0.08  # gap between request arrivals in the serve phase
FORMATS = ("none", "int8", "int4")
LOCAL_K, LOCAL_STEP = 8, 7  # the local kernel's timed shape: a full K=8 block
SLEEP_CYCLES = 20_000_000  # device sleep ahead of a timed run (~10 ms)

KERNELS = {
    "paged_decode": {
        "module": hopper_paged_attention,
        "source": "dynamo_tpu_torch/csrc/paged_decode.cu",
        "replaces": {"none": "dynamo_tpu/ops/pallas_paged_attention.py:514",
                     "quant": "dynamo_tpu/ops/pallas_paged_attention.py:40"},
        # split-KV over a grid of live items, cp.async ring, register state
        # (csrc/flash_decode.cuh)
        "body": {"bfloat16": "splitkv-fma", "float32": "splitkv-fma"},
    },
    "paged_decode_local": {
        "module": hopper_paged_attention_local,
        "source": "dynamo_tpu_torch/csrc/paged_decode_local.cu",
        "replaces": {"none": "dynamo_tpu/ops/pallas_paged_attention.py:422",
                     "quant": "dynamo_tpu/ops/pallas_paged_attention.py:40"},
        # the same split-KV body, block-local rows one more tile of the last split
        "body": {"bfloat16": "splitkv-fma", "float32": "splitkv-fma"},
    },
    "prefill_attention": {
        "module": hopper_prefill_attention,
        "source": "dynamo_tpu_torch/csrc/prefill_attention.cu",
        # the reference has no quantized prefill kernel: the quantized
        # variant extends this one (a port-side addition)
        "replaces": {"none": "dynamo_tpu/ops/pallas_prefill_attention.py:250",
                     "quant": "dynamo_tpu/ops/pallas_prefill_attention.py:250"},
        # bf16 runs the tensor-core body (csrc/flash_mma.cuh), f32 the FMA one
        "body": {"bfloat16": "mma", "float32": "fma"},
    },
    "ragged_attention": {
        "module": hopper_ragged_attention,
        "source": "dynamo_tpu_torch/csrc/ragged_attention.cu",
        "replaces": {"none": "dynamo_tpu/ops/pallas_ragged_attention.py:336",
                     "quant": "dynamo_tpu/ops/pallas_ragged_attention.py:142"},
        "body": {"bfloat16": "mma", "float32": "fma"},
    },
}

# served paths: (phase, decode_pool_mode, kv_quant, layers). The first three
# are the model's full depth; the last three cover the remaining (decode
# kernel, format) pairs at a cut depth.
SERVE_PHASES = [
    ("serve", "scatter", "none", LAYERS),
    # the quantized paths at a cut depth pay for the durable phases' time
    ("serve_local_int8", "local", "int8", 4),
    ("serve_scatter_int4", "scatter", "int4", 4),
    ("serve_local_none", "local", "none", 4),
    ("serve_scatter_int8", "scatter", "int8", 4),
    ("serve_local_int4", "local", "int4", 4),
]


T_START = time.perf_counter()


def emit(phase: str, **fields) -> None:
    """One JSON line; `at_s` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "at_s": round(time.perf_counter() - T_START, 1)}), flush=True)


def time_ms(fn, warm: int = 3, reps: int = 20) -> float:
    """Mean device milliseconds of fn() over `reps` launches (CUDA events).
    The launches queue behind a device sleep of ~10 ms, so a kernel faster
    than the host's launch rate is timed by its own work."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_kernel(fn, reps: int = 20) -> dict:
    """A kernel wrapper's times over `reps` calls each way: `ms`, device ms
    a call with the calls queued behind a device sleep (as time_ms);
    `ms_back_to_back`, the same calls issued straight after a sync, so a
    call whose host work outlasts its kernel is timed by the host (the
    engine's eager step issues them so); `host_us`, the host's
    microseconds a call, measured while the calls queue behind the sleep."""
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
    """K and V pools of standard normals, drawn on the card from a seed
    that `rng` draws: the full-width pools hold 2.7e8 values, which the
    host draws in seconds each."""
    gen = torch.Generator(device=DEV).manual_seed(int(rng.integers(1 << 62)))
    shape = (pages, ps, KH, D)
    k = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    v = torch.randn(shape, generator=gen, device=DEV).to(dtype)
    return k, v


def quantize_layer(x: torch.Tensor, fmt: str):
    """A per-layer pool [pages, ps, KH, D] in `fmt`: the tensor itself, or
    a QuantKV with one scale per page and head (amax / qmax) and the values
    rounded to it — the layout the engine's writes produce."""
    if fmt == "none":
        return x
    bits = kv_quant.kv_quant_bits(fmt)
    x32 = x.float()
    s = x32.abs().amax(dim=(1, 3)) / QMAX[bits]  # [pages, KH]
    q = torch.round(x32 / s.clamp(min=1e-30)[:, None, :, None]).clamp(-QMAX[bits], QMAX[bits])
    q = q.to(torch.int8)
    if bits == 4:
        q = pack_int4(q, axis=1)
    return kv_quant.QuantKV(q.contiguous(), s.contiguous(), bits, x.shape[1])


def pool_in(k, v, fmt):
    return quantize_layer(k, fmt), quantize_layer(v, fmt)


def dense_ctx(layer, tables, dtype):
    """[rows, KH, S, D] context gathered (and dequantized) for a library call."""
    g = kv_quant.gather_dequant(layer, tables, dtype)  # [rows, P, ps, KH, D]
    R, P, ps, KH, D = g.shape
    return g.reshape(R, P * ps, KH, D).transpose(1, 2).contiguous()


def kv_bytes_per_token(KH, D, fmt, elem=2) -> float:
    """K + V bytes one context token occupies in a pool of format `fmt`."""
    per = {"none": elem, "int8": 1, "int4": 0.5}[fmt]
    return 2 * KH * D * per


def scale_bytes(pages_read: float, KH: int, fmt: str) -> float:
    return 0.0 if fmt == "none" else 2 * 4 * KH * pages_read


def rand_tables(rng, rows, P, pages):
    # random physical pages (>= 1: page 0 is the scratch page), with repeats
    return torch.from_numpy(
        rng.integers(1, pages, size=(rows, P)).astype(np.int32)).to(DEV)


def i32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.int32, device=DEV)


def sdpa_ms(q, k, v, mask, is_causal: bool = False) -> float:
    """One scaled_dot_product_attention call over the gathered context
    (q [B, H, T, D], k/v [B, KH, S, D], mask [B, 1, T, S]); a yardstick only.
    Where every key is visible (mask None) or the mask is the causal one
    (is_causal, T == S), no mask is passed, so the flash backend may run."""
    G = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(G, dim=1)
    v = v.repeat_interleave(G, dim=1)
    f = torch.nn.functional.scaled_dot_product_attention
    return time_ms(lambda: f(q, k, v, attn_mask=mask, is_causal=is_causal), warm=2, reps=10)


def check_full(name, fmt, out, ref, case="full"):
    torch.cuda.synchronize()
    err, rel = max_err(out, ref), row_rel_err(out, ref)
    assert err <= TOL_BF16_FULL, f"{name}[{fmt}] bf16 {case}: {err}"
    assert rel <= TOL_BF16_ROW_REL, f"{name}[{fmt}] bf16 {case}, per row: {rel}"
    return err, rel


def tflops(flops: float, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e12


# ---------------------------------------------------------------------- #
# phase: kernels
# ---------------------------------------------------------------------- #


def decode_case(rng, B, H, KH, D, ps, P, pages, dtype, lens):
    k, v = make_pool(rng, pages, ps, KH, D, dtype)
    q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32)).to(DEV, dtype)
    return q, k, v, rand_tables(rng, B, P, pages), i32(lens)


def decode_bound(lens, KH, D, ps, fmt, q, H):
    """(bound ms, bound_by) of one decode launch over these lengths."""
    ctx = np.maximum(np.asarray(lens), 1).astype(np.float64)
    bytes_moved = (ctx.sum() * kv_bytes_per_token(KH, D, fmt, q.element_size())
                   + scale_bytes(np.ceil(ctx / ps).sum(), KH, fmt) + 2 * q.numel() * q.element_size())
    return bound(bytes_moved, 4.0 * H * D * ctx.sum())


def rows8(layer):
    """A quantized pool as a view whose rows are only 8-byte aligned (D
    padded by 8 bytes): the decode kernel copies such rows 8 bytes at a time."""
    if not isinstance(layer, kv_quant.QuantKV):
        return layer
    q = layer.q
    full = torch.zeros((*q.shape[:-1], q.shape[-1] + 8), dtype=q.dtype, device=q.device)
    full[..., :q.shape[-1]] = q
    return kv_quant.QuantKV(full[..., :q.shape[-1]], layer.s, layer.bits, layer.page_size)


# lanes of the tiny split-KV decode checks: D=16, page 8, 130-entry tables
# cut into 3 splits of 64 pages (512 keys): empty, length 1, one split, one
# split + 1, page-straddling, more than two splits
SPLIT_LENS = [0, 1, 512, 513, 37, 1030]


def g16_case(rng):
    """Full width at G=16 (H=32, KH=2): the decode body loops over two
    groups of 8 rows. 8 lanes, 128-entry tables, lengths 1..2048."""
    return decode_case(rng, 8, 32, 2, 128, 64, 128, 2049, torch.bfloat16,
                       rng.integers(1, 2049, size=8))


def decode_timed_shapes(seed: int) -> dict:
    """The two extra timed decode shapes, from their own generator (so the
    B=64 shape's draw is unchanged): 4 long lanes, and the serve phases'
    shape — 64 lanes of which 12 are live at ~1500 keys, the rest length 1."""
    rng = np.random.default_rng(seed + 4)
    live = np.ones(64, np.int64)
    live[rng.choice(64, 12, replace=False)] = rng.integers(1200, 1801, size=12)
    return {"B4_long": rng.integers(7600, 8193, size=4), "B64_12live": live}


def check_decode(rng, measured, rng_dec, shapes, rng_g16):
    # tiny f32: GQA 2, page-straddling lengths, an empty lane
    q, k, v, tab, lens = decode_case(
        rng, 5, 4, 2, 16, 8, 6, 40, torch.float32, [1, 8, 9, 37, 0])
    tiny = {}
    for fmt in FORMATS:
        kk, vv = pool_in(k, v, fmt)
        tiny[fmt] = max_err(pa.paged_attention_decode(q, kk, vv, tab, lens),
                            pa.paged_attention_decode_plain(q, kk, vv, tab, lens))
        torch.cuda.synchronize()
        assert tiny[fmt] <= TOL_F32_TINY, f"paged_decode[{fmt}] f32 tiny: {tiny[fmt]}"
    # where the split-KV body can break, drawn from their own generator: D=16,
    # page 8 and G=2 (a split is 64 pages = 512 keys; 130-entry tables make
    # 3 splits) with lanes of length 0, 1, one split, one split + 1, a
    # page-straddling length and more than two splits — in f32 (2e-3), in
    # bf16, and with quantized rows only 8-byte aligned; then full width at
    # G=4 (H=32/KH=8) and G=8 (H=64/KH=8); and G=16 (H=32/KH=2: two groups
    # of 8 rows), drawn from a generator of its own
    cases = {
        "tiny_split_f32": decode_case(rng_dec, 6, 4, 2, 16, 8, 130, 40, torch.float32,
                                      SPLIT_LENS),
        "tiny_G2": decode_case(rng_dec, 6, 4, 2, 16, 8, 130, 40, torch.bfloat16, SPLIT_LENS),
        "G4": decode_case(rng_dec, 8, 32, 8, 128, 64, 128, 2049, torch.bfloat16,
                          rng_dec.integers(1, 2049, size=8)),
        "G8": decode_case(rng_dec, 8, 64, 8, 128, 64, 128, 2049, torch.bfloat16,
                          rng_dec.integers(1, 2049, size=8)),
        "G16": g16_case(rng_g16),
    }
    checks = {fmt: {} for fmt in FORMATS}
    for fmt in FORMATS:
        for case, (qq, k_, v_, tb, ln) in cases.items():
            kk, vv = pool_in(k_, v_, fmt)
            views = [("", kk, vv)] + ([("_rows8", rows8(kk), rows8(vv))] if fmt != "none" else [])
            for tag, ka, va in views:
                out = pa.paged_attention_decode(qq, ka, va, tb, ln)
                ref = pa.paged_attention_decode_plain(qq, ka, va, tb, ln)
                if qq.dtype == torch.float32:
                    torch.cuda.synchronize()
                    err = max_err(out, ref)
                    assert err <= TOL_F32_TINY, f"paged_decode[{fmt}] {case}{tag}: {err}"
                    checks[fmt][case + tag] = err
                else:
                    checks[fmt][case + tag] = check_full("paged_decode", fmt, out, ref, case + tag)
                checks[fmt][case + tag + "_splits"] = hopper_paged_attention.last_splits
            if case in ("G4", "G8", "G16"):  # timed: G=4 runs the 8-row instantiation
                checks[fmt][case + "_ms"] = time_ms(
                    lambda: pa.paged_attention_decode(qq, kk, vv, tb, ln))
                checks[fmt][case + "_bound_ms"] = decode_bound(
                    ln.cpu().numpy(), k_.shape[2], 128, 64, fmt, qq, qq.shape[1])[0]
    del cases
    # full width bf16: the engine's decode shape (64 lanes, 128-entry tables)
    B, H, KH, D, ps, P = 64, 24, 8, 128, 64, 128
    lens = rng.integers(1, 2049, size=B)
    lens[:4] = [0, 1, 64, 65]
    q, k, v, tab, lens_t = decode_case(rng, B, H, KH, D, ps, P, 2049, torch.bfloat16, lens)
    ctx = np.maximum(lens, 1).astype(np.float64)
    S = P * ps
    mask = (torch.arange(S, device=DEV)[None, :] < lens_t.clamp(min=1)[:, None])[:, None, None, :]
    # the extra timed shapes (same widths, same pool)
    extra = {name: (i32(ln), torch.from_numpy(
        rng_dec.standard_normal((len(ln), H, D)).astype(np.float32)).to(DEV, torch.bfloat16),
        rand_tables(rng_dec, len(ln), P, 2049)) for name, ln in shapes.items()}
    for fmt in FORMATS:
        kk, vv = pool_in(k, v, fmt)
        out = pa.paged_attention_decode(q, kk, vv, tab, lens_t)
        ref = pa.paged_attention_decode_plain(q, kk, vv, tab, lens_t)
        err_full, rel_full = check_full("paged_decode", fmt, out, ref)
        splits = hopper_paged_attention.last_splits
        b_ms, b_by = decode_bound(lens, KH, D, ps, fmt, q, H)
        # library yardstick: SDPA over the dense gathered (dequantized) context
        kd, vd = dense_ctx(kk, tab, q.dtype), dense_ctx(vv, tab, q.dtype)
        lib = sdpa_ms(q[:, :, None, :], kd, vd, mask)
        del kd, vd
        times = time_kernel(lambda: pa.paged_attention_decode(q, kk, vv, tab, lens_t))
        at = {}
        for name, (ln_t, qx, tb) in extra.items():
            o = pa.paged_attention_decode(qx, kk, vv, tb, ln_t)
            r = pa.paged_attention_decode_plain(qx, kk, vv, tb, ln_t)
            e, rel = check_full("paged_decode", fmt, o, r, name)
            n_split = hopper_paged_attention.last_splits
            x_ms, _ = decode_bound(shapes[name], KH, D, ps, fmt, qx, H)
            at[name] = {**time_kernel(lambda: pa.paged_attention_decode(qx, kk, vv, tb, ln_t)),
                        "bound_ms": x_ms, "splits": n_split, "max_abs_err": e,
                        "max_row_rel_err": rel,
                        "live_keys": int(np.maximum(shapes[name], 1).sum())}
        assert at["B4_long"]["splits"] > 1, f"paged_decode[{fmt}]: the long shape ran unsplit"
        measured[("paged_decode", fmt)] = {
            "max_abs_err": max([err_full] + [a["max_abs_err"] for a in at.values()]),
            "max_row_rel_err": max([rel_full] + [a["max_row_rel_err"] for a in at.values()]),
            "max_abs_err_f32_tiny": tiny[fmt], "bf16_checks": checks[fmt],
            **times, "tflops": tflops(4.0 * H * D * ctx.sum(), times["ms"]),
            "splits": splits,
            "plain_ms": time_ms(
                lambda: pa.paged_attention_decode_plain(q, kk, vv, tab, lens_t), 1, 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "shapes": at,
            "shape": f"B={B} H={H} KH={KH} D={D} ps={ps} tables=[{B},{P}] mean_len={ctx.mean():.0f}",
        }


def local_rows(rng, B, K, KH, D, dtype, step):
    """Block-local K/V [B, K, KH, D]; rows past `step` hold 1e4, which would
    swamp any score they reached."""
    out = []
    for _ in range(2):
        x = rng.standard_normal((B, K, KH, D)).astype(np.float32)
        x[:, step + 1:] = 1e4
        out.append(torch.from_numpy(x).to(DEV, dtype))
    return out


def check_decode_local(rng, measured, rng_dec, shapes, rng_loc):
    # tiny f32: GQA 2, page-straddling pool lengths, two empty pools, K=4
    # with entries past step_idx holding garbage that must not be read
    B, H, KH, D = 5, 4, 2, 16
    q, k, v, tab, pool = decode_case(rng, B, H, KH, D, 8, 6, 40, torch.float32,
                                     [0, 7, 8, 36, 0])
    loc_k = torch.randn((B, 4, KH, D), device=DEV)
    loc_v = torch.randn((B, 4, KH, D), device=DEV)
    loc_k[:, 3], loc_v[:, 3] = 1e4, 1e4
    step = i32([2])
    tiny = {}
    for fmt in FORMATS:
        kk, vv = pool_in(k, v, fmt)
        args = (q, kk, vv, tab, pool, loc_k, loc_v, step)
        tiny[fmt] = max_err(pa.paged_attention_decode_mixed(*args),
                            pa.paged_attention_decode_mixed_plain(*args))
        torch.cuda.synchronize()
        assert tiny[fmt] <= TOL_F32_TINY, f"paged_decode_local[{fmt}] f32 tiny: {tiny[fmt]}"
    # where the split-KV body's local tile can break, from a generator of
    # its own: the split edges of check_decode (D=16, page 8, G=2, 3
    # splits) plus a full table (1040 keys), in f32 (2e-3), in bf16 and with
    # quantized rows only 8-byte aligned; then full width at G=16. Each at
    # K=8 (first and last step), K=1 and K=64 (its last step: 64 rows of
    # T are 1-4 ring stages)
    lens = SPLIT_LENS + [1040]
    cases = {
        "tiny_split_f32": decode_case(rng_loc, len(lens), 4, 2, 16, 8, 130, 40,
                                      torch.float32, lens),
        "tiny_G2": decode_case(rng_loc, len(lens), 4, 2, 16, 8, 130, 40, torch.bfloat16, lens),
        "G16": g16_case(rng_loc),
    }
    steps = [(8, 0), (8, 7), (1, 0), (64, 63)]
    checks = {fmt: {} for fmt in FORMATS}
    for case, (qq, k_, v_, tb, ln) in cases.items():
        rows = {(K_, st): local_rows(rng_loc, qq.shape[0], K_, k_.shape[2], qq.shape[2],
                                     qq.dtype, st) for K_, st in steps}
        for fmt in FORMATS:
            kk, vv = pool_in(k_, v_, fmt)
            views = [("", kk, vv)]
            if fmt != "none" and case != "G16":
                views.append(("_rows8", rows8(kk), rows8(vv)))
            for tag, ka, va in views:
                for (K_, st), (lk, lv) in rows.items():
                    name = f"{case}{tag}_K{K_}_s{st}"
                    args = (qq, ka, va, tb, ln, lk, lv, i32([st]))
                    out = pa.paged_attention_decode_mixed(*args)
                    ref = pa.paged_attention_decode_mixed_plain(*args)
                    if qq.dtype == torch.float32:
                        torch.cuda.synchronize()
                        err = max_err(out, ref)
                        assert err <= TOL_F32_TINY, f"paged_decode_local[{fmt}] {name}: {err}"
                        checks[fmt][name] = err
                    else:
                        checks[fmt][name] = check_full("paged_decode_local", fmt, out, ref, name)
                    checks[fmt][name + "_splits"] = hopper_paged_attention_local.last_splits
    del cases
    # full width bf16: the decode shape, K=8 local rows, the block's last step
    B, H, KH, D, ps, P, K = 64, 24, 8, 128, 64, 128, LOCAL_K
    lens = rng.integers(1, 2049, size=B)
    lens[:4] = [1, 2, 64, 65]
    pool_lens = np.maximum(lens - 1, 0)
    q, k, v, tab, pool_t = decode_case(rng, B, H, KH, D, ps, P, 2049, torch.bfloat16,
                                       pool_lens)
    loc_k = torch.randn((B, K, KH, D), device=DEV).to(torch.bfloat16)
    loc_v = torch.randn((B, K, KH, D), device=DEV).to(torch.bfloat16)
    step = i32([LOCAL_STEP])
    n_loc = LOCAL_STEP + 1
    pages_read = np.ceil(pool_lens / ps).sum()
    S = P * ps
    extra = {name: (i32(np.maximum(ln - 1, 0)), torch.from_numpy(
        rng_dec.standard_normal((len(ln), H, D)).astype(np.float32)).to(DEV, torch.bfloat16),
        rand_tables(rng_dec, len(ln), P, 2049)) for name, ln in shapes.items()}
    mask = torch.cat([
        torch.arange(S, device=DEV)[None, :] < pool_t[:, None],
        torch.ones((B, K), dtype=torch.bool, device=DEV),
    ], dim=1)[:, None, None, :]
    for fmt in FORMATS:
        kk, vv = pool_in(k, v, fmt)
        args = (q, kk, vv, tab, pool_t, loc_k, loc_v, step)
        out = pa.paged_attention_decode_mixed(*args)
        ref = pa.paged_attention_decode_mixed_plain(*args)
        err_full, rel_full = check_full("paged_decode_local", fmt, out, ref)
        splits = hopper_paged_attention_local.last_splits
        keys = pool_lens.sum() + B * n_loc
        bytes_moved = (pool_lens.sum() * kv_bytes_per_token(KH, D, fmt)
                       + scale_bytes(pages_read, KH, fmt)
                       + B * n_loc * kv_bytes_per_token(KH, D, "none")
                       + 2 * q.numel() * 2)
        b_ms, b_by = bound(bytes_moved, 4.0 * H * D * keys)
        kd = torch.cat([dense_ctx(kk, tab, q.dtype), loc_k.transpose(1, 2)], dim=2).contiguous()
        vd = torch.cat([dense_ctx(vv, tab, q.dtype), loc_v.transpose(1, 2)], dim=2).contiguous()
        lib = sdpa_ms(q[:, :, None, :], kd, vd, mask)
        del kd, vd
        times = time_kernel(lambda: pa.paged_attention_decode_mixed(*args))
        # paged_decode's extra timed shapes: pool lengths len - 1, the same
        # K rows
        at = {}
        for name, (ln_t, qx, tb) in extra.items():
            xargs = (qx, kk, vv, tb, ln_t, loc_k[:len(qx)], loc_v[:len(qx)], step)
            e, rel = check_full("paged_decode_local", fmt, pa.paged_attention_decode_mixed(*xargs),
                                pa.paged_attention_decode_mixed_plain(*xargs), name)
            n_split = hopper_paged_attention_local.last_splits
            pl = np.maximum(shapes[name] - 1, 0)
            x_bytes = (pl.sum() * kv_bytes_per_token(KH, D, fmt)
                       + scale_bytes(np.ceil(pl / ps).sum(), KH, fmt)
                       + len(pl) * n_loc * kv_bytes_per_token(KH, D, "none")
                       + 2 * qx.numel() * 2)
            at[name] = {**time_kernel(lambda: pa.paged_attention_decode_mixed(*xargs)),
                        "bound_ms": bound(x_bytes, 4.0 * H * D * (pl.sum() + len(pl) * n_loc))[0],
                        "splits": n_split, "max_abs_err": e, "max_row_rel_err": rel}
        assert at["B4_long"]["splits"] > 1, \
            f"paged_decode_local[{fmt}]: the long shape ran unsplit"
        measured[("paged_decode_local", fmt)] = {
            "max_abs_err": max([err_full] + [a["max_abs_err"] for a in at.values()]),
            "max_row_rel_err": max([rel_full] + [a["max_row_rel_err"] for a in at.values()]),
            "max_abs_err_f32_tiny": tiny[fmt], "bf16_checks": checks[fmt],
            **times, "tflops": tflops(4.0 * H * D * keys, times["ms"]), "splits": splits,
            "plain_ms": time_ms(lambda: pa.paged_attention_decode_mixed_plain(*args), 1, 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "shapes": at,
            "shape": (f"B={B} H={H} KH={KH} D={D} ps={ps} tables=[{B},{P}] "
                      f"mean_pool_len={pool_lens.mean():.0f} K={K} step={LOCAL_STEP}"),
        }


def prefill_case(rng, B, T, H, KH, D, ps, P, pages, dtype, starts, reals):
    k, v = make_pool(rng, pages, ps, KH, D, dtype)
    q = torch.from_numpy(rng.standard_normal((B, T, H, D)).astype(np.float32)).to(DEV, dtype)
    starts = np.asarray(starts)
    totals = starts + np.asarray(reals)
    pos = i32(starts[:, None] + np.arange(T)[None, :])
    return q, k, v, pos, rand_tables(rng, B, P, pages), i32(totals), i32(starts)


def check_prefill(rng, measured, rng_bf16):
    # tiny f32 (the FMA body): history + chunk, page-straddling, a padded
    # tail, a dummy lane
    q, k, v, *rest = prefill_case(rng, 3, 24, 4, 2, 16, 8, 9, 40, torch.float32,
                                  starts=[0, 13, 0], reals=[24, 17, 1])
    tiny = {}
    for fmt in FORMATS:
        kk, vv = pool_in(k, v, fmt)
        tiny[fmt] = max_err(pa.prefill_attention_batched(q, kk, vv, *rest),
                            pa.prefill_attention_batched_plain(q, kk, vv, *rest))
        torch.cuda.synchronize()
        assert tiny[fmt] <= TOL_F32_TINY, f"prefill_attention[{fmt}] f32 tiny: {tiny[fmt]}"
    # bf16 (the tensor-core body) where its packing can break: tiny D=16 at
    # page 8 (an 8-key tile padded to the 16-key MMA depth) with G=2 (32
    # tokens a block, so T=40 is two tiles), history + chunk,
    # page-straddling, a padded tail, a dummy lane; then short full-width
    # cases at G=4 (16 tokens a block) and G=8 (8 tokens)
    bf16_cases = {
        "tiny_G2": prefill_case(rng_bf16, 3, 40, 4, 2, 16, 8, 9, 40, torch.bfloat16,
                                starts=[0, 13, 0], reals=[40, 27, 1]),
        "G4": prefill_case(rng_bf16, 2, 100, 32, 8, 128, 64, 5, 64, torch.bfloat16,
                           starts=[0, 130], reals=[100, 77]),
        "G8": prefill_case(rng_bf16, 2, 100, 64, 8, 128, 64, 5, 64, torch.bfloat16,
                           starts=[0, 130], reals=[100, 77]),
    }
    checks = {fmt: {} for fmt in FORMATS}
    for fmt in FORMATS:
        for case, (qq, k_, v_, *rest) in bf16_cases.items():
            kk, vv = pool_in(k_, v_, fmt)
            checks[fmt][case] = check_full(
                "prefill_attention", fmt, pa.prefill_attention_batched(qq, kk, vv, *rest),
                pa.prefill_attention_batched_plain(qq, kk, vv, *rest), case)
    del bf16_cases
    H, KH, D, ps = 24, 8, 128, 64
    # the engine's batch shape: 8 lanes x bucket 128, varied history
    a8 = prefill_case(rng, 8, 128, H, KH, D, ps, 17, 2049, torch.bfloat16,
                      starts=[0, 64, 100, 256, 512, 777, 900, 0],
                      reals=[128, 128, 90, 128, 128, 33, 128, 1])
    # the lone-arrival shape: 1 lane x bucket 1024, second chunk of a prompt
    B, T, P, start = 1, 1024, 33, 1024
    a1 = prefill_case(rng, B, T, H, KH, D, ps, P, 2049, torch.bfloat16,
                      starts=[start], reals=[T])
    q, k, v, pos, tab, totals, starts = a1
    visible = float(sum(min(start + i + 1, start + T) for i in range(T)))
    S = P * ps
    key = torch.arange(S, device=DEV)
    mask = ((key[None, None, :] <= pos[:, :, None]) &
            (key[None, None, :] < totals[:, None, None]))[:, None]
    for fmt in FORMATS:
        errs, rels = {}, {}
        for shape, (qq, k_, v_, *rest) in (("B8_T128", a8), ("B1_T1024", a1)):
            kk, vv = pool_in(k_, v_, fmt)
            out = pa.prefill_attention_batched(qq, kk, vv, *rest)
            ref = pa.prefill_attention_batched_plain(qq, kk, vv, *rest)
            errs[shape], rels[shape] = check_full("prefill_attention", fmt, out, ref)
            del out, ref
        kk, vv = pool_in(k, v, fmt)
        args = (q, kk, vv, pos, tab, totals, starts)
        bytes_moved = ((start + T) * kv_bytes_per_token(KH, D, fmt)
                       + scale_bytes((start + T) / ps, KH, fmt) + 2 * q.numel() * 2)
        b_ms, b_by = bound(bytes_moved, 4.0 * H * D * visible)
        kd, vd = dense_ctx(kk, tab, q.dtype), dense_ctx(vv, tab, q.dtype)
        lib = sdpa_ms(q.transpose(1, 2), kd, vd, mask)
        del kd, vd
        times = time_kernel(lambda: pa.prefill_attention_batched(*args))
        measured[("prefill_attention", fmt)] = {
            "max_abs_err": max(errs.values()), "max_row_rel_err": max(rels.values()),
            "max_abs_err_f32_tiny": tiny[fmt], "errs": errs, "row_rel_errs": rels,
            "bf16_checks": checks[fmt],
            **times, "tflops": tflops(4.0 * H * D * visible, times["ms"]),
            "plain_ms": time_ms(lambda: pa.prefill_attention_batched_plain(*args), 1, 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "shape": f"B={B} T={T} H={H} KH={KH} D={D} ps={ps} start={start} total={start + T}",
        }
        torch.cuda.empty_cache()


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


def check_ragged(rng, measured, rng_bf16):
    # tiny f32 (the FMA body): decode rows + prefill rows, page-straddling,
    # a padding row, a decode row with no history, tail padding tokens
    rows = [(1, 12), (11, 0), (1, 0), (20, 7), (1, 8), (5, 16)]
    (q, k, v, *rest), real = ragged_case(rng, 64, 8, 4, 2, 16, 8, 6, 40, torch.float32, rows)
    tiny = {}
    for fmt in FORMATS:
        kk, vv = pool_in(k, v, fmt)
        out = pa.ragged_attention(q, kk, vv, *rest)
        ref = pa.ragged_attention_plain(q, kk, vv, *rest)
        torch.cuda.synchronize()
        tiny[fmt] = max_err(out[real], ref[real])
        assert tiny[fmt] <= TOL_F32_TINY, f"ragged_attention[{fmt}] f32 tiny: {tiny[fmt]}"
        assert torch.isfinite(out.float()).all(), "ragged padding tokens are not finite"
    # bf16 (the tensor-core body): the same mix at D=16, page 8, G=2, plus a
    # 40-token row (two tiles of 32 tokens); then short full-width mixes at
    # G=4 and G=8 (chunk rows over several tiles, decode rows, one with no
    # history)
    bf16_cases = {
        "tiny_G2": ragged_case(rng_bf16, 96, 8, 4, 2, 16, 8, 6, 40, torch.bfloat16,
                               rows + [(40, 3)]),
        "G4": ragged_case(rng_bf16, 128, 6, 32, 8, 128, 64, 5, 64, torch.bfloat16,
                          [(70, 33), (1, 200), (1, 0), (45, 0)]),
        "G8": ragged_case(rng_bf16, 128, 6, 64, 8, 128, 64, 5, 64, torch.bfloat16,
                          [(70, 33), (1, 200), (1, 0), (45, 0)]),
    }
    checks = {fmt: {} for fmt in FORMATS}
    for fmt in FORMATS:
        for case, ((qq, k_, v_, *rest), real_c) in bf16_cases.items():
            kk, vv = pool_in(k_, v_, fmt)
            out = pa.ragged_attention(qq, kk, vv, *rest)
            ref = pa.ragged_attention_plain(qq, kk, vv, *rest)
            checks[fmt][case] = check_full("ragged_attention", fmt, out[real_c], ref[real_c],
                                           case)
            assert not out[~real_c].any(), "ragged padding tokens are not zeros"
    del bf16_cases
    # full width bf16: one 1024-token chunk with history beside 48 decode lanes
    H, KH, D, ps, P, N, R = 24, 8, 128, 64, 33, 2048, 128
    rows = [(1024, 512), (200, 0)] + [(1, int(c)) for c in rng.integers(0, 2048, size=48)]
    (q, k, v, tab, row_starts, row_lens, ctx_lens), real = ragged_case(
        rng, N, R, H, KH, D, ps, P, 2049, torch.bfloat16, rows)
    visible = sum(sum(min(c + j + 1, c + ln) for j in range(ln)) for ln, c in rows)
    ctx_tokens = sum(c + ln for ln, c in rows)
    pages_read = sum(-(-(c + ln) // ps) for ln, c in rows)
    n_real = sum(ln for ln, _ in rows)
    # library yardstick: the rows scattered into a padded batch [rows, Tmax]
    # against each row's densely gathered context, one masked SDPA call
    Rr, Tmax, S = len(rows), max(ln for ln, _ in rows), P * ps
    qp = torch.zeros((Rr, Tmax, H, D), dtype=q.dtype, device=DEV)
    off = 0
    for r, (ln, _) in enumerate(rows):
        qp[r, :ln] = q[off:off + ln]
        off += ln
    qp = qp.transpose(1, 2).contiguous()
    keyp = torch.arange(S, device=DEV)[None, None, :]
    pos = ctx_lens[:Rr, None] + torch.arange(Tmax, device=DEV)[None, :]
    mask = ((keyp <= pos[:, :, None]) &
            (keyp < (ctx_lens + row_lens)[:Rr, None, None]))[:, None]
    for fmt in FORMATS:
        kk, vv = pool_in(k, v, fmt)
        args = (q, kk, vv, tab, row_starts, row_lens, ctx_lens)
        out, ref = pa.ragged_attention(*args), pa.ragged_attention_plain(*args)
        err_full, rel_full = check_full("ragged_attention", fmt, out[real], ref[real])
        del out, ref
        bytes_moved = (ctx_tokens * kv_bytes_per_token(KH, D, fmt)
                       + scale_bytes(pages_read, KH, fmt) + 2 * n_real * H * D * 2)
        b_ms, b_by = bound(bytes_moved, 4.0 * H * D * visible)
        kd, vd = dense_ctx(kk, tab[:Rr], q.dtype), dense_ctx(vv, tab[:Rr], q.dtype)
        lib = sdpa_ms(qp, kd, vd, mask)
        del kd, vd
        times = time_kernel(lambda: pa.ragged_attention(*args))
        measured[("ragged_attention", fmt)] = {
            "max_abs_err": err_full, "max_row_rel_err": rel_full,
            "max_abs_err_f32_tiny": tiny[fmt], "bf16_checks": checks[fmt],
            **times, "tflops": tflops(4.0 * H * D * visible, times["ms"]),
            "plain_ms": time_ms(lambda: pa.ragged_attention_plain(*args), 1, 3),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
            "shape": f"N={N} R={R} H={H} KH={KH} D={D} ps={ps} rows=1024@512+200@0+48 decode",
        }
        torch.cuda.empty_cache()


# the speculative verify's shapes (spec_guided phase): the split verify runs
# the prefill kernel at B = lanes, T = 1 + d; the fused verify packs 1 + d
# one-token rows a lane on the ragged kernel, row j at ctx L-1+j over the
# lane's table (a staircase: row j sees its siblings 0..j-1)
SPEC_LANES, SPEC_T = 64, 5


def check_spec_shapes(rng, measured) -> None:
    H, KH, D, ps, P, pages = 24, 8, 128, 64, 33, 2049
    lens = rng.integers(200, 2000, size=SPEC_LANES)  # L: tokens in the lane's KV + 1
    # prefill at the verify shape: chunk positions L-1 .. L-1+d per lane
    q, k, v, pos, tab, totals, starts = prefill_case(
        rng, SPEC_LANES, SPEC_T, H, KH, D, ps, P, pages, torch.bfloat16,
        starts=lens - 1, reals=[SPEC_T] * SPEC_LANES)
    visible = float(sum(SPEC_T * (L - 1) + SPEC_T * (SPEC_T + 1) // 2 for L in lens))
    ctx_tokens = float(sum(L - 1 + SPEC_T for L in lens))
    key = torch.arange(P * ps, device=DEV)
    mask = ((key[None, None, :] <= pos[:, :, None]) &
            (key[None, None, :] < totals[:, None, None]))[:, None]
    # the same lanes as a staircase pack on the ragged kernel (its tables
    # are the lanes' tables, one row each)
    R = SPEC_LANES * SPEC_T
    rq = q.reshape(R, H, D).contiguous()
    r_tab = tab.repeat_interleave(SPEC_T, dim=0).contiguous()
    j = np.tile(np.arange(SPEC_T), SPEC_LANES)
    r_ctx = i32(np.repeat(lens - 1, SPEC_T) + j)
    r_starts, r_lens = i32(np.arange(R)), i32(np.ones(R, np.int32))
    for fmt in FORMATS:
        kk, vv = pool_in(k, v, fmt)
        bytes_moved = (ctx_tokens * kv_bytes_per_token(KH, D, fmt)
                       + scale_bytes(ctx_tokens / ps, KH, fmt) + 2 * q.numel() * 2)
        b_ms, b_by = bound(bytes_moved, 4.0 * H * D * visible)
        kd, vd = dense_ctx(kk, tab, q.dtype), dense_ctx(vv, tab, q.dtype)
        # one library call for both: the staircase is the same function
        lib = sdpa_ms(q.transpose(1, 2), kd, vd, mask)
        del kd, vd
        for name, args, plain_fn, fn, lib_ms, shape in (
            ("prefill_attention@verify", (q, kk, vv, pos, tab, totals, starts),
             pa.prefill_attention_batched_plain, pa.prefill_attention_batched, lib,
             f"B={SPEC_LANES} T={SPEC_T} H={H} KH={KH} D={D} ps={ps} ctx 199-1999"),
            ("ragged_attention@staircase", (rq, kk, vv, r_tab, r_starts, r_lens, r_ctx),
             pa.ragged_attention_plain, pa.ragged_attention, lib,
             f"N=R={R} ({SPEC_LANES} lanes x {SPEC_T} one-token rows) H={H} KH={KH} D={D}"),
        ):
            out, ref = fn(*args), plain_fn(*args)
            err, rel = check_full(name, fmt, out, ref, "spec shape")
            del out, ref
            times = time_kernel(lambda: fn(*args))
            measured[(name, fmt)] = {
                "max_abs_err": err, "max_row_rel_err": rel, **times,
                "tflops": tflops(4.0 * H * D * visible, times["ms"]),
                "plain_ms": time_ms(lambda: plain_fn(*args), 1, 3),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms, "shape": shape,
            }
        torch.cuda.empty_cache()


def phase_kernels(seed: int) -> dict:
    measured: dict = {}
    rng = np.random.default_rng(seed)
    # the bf16 tensor-core checks draw from their own generator, so the timed
    # shapes (drawn from `rng`) are those of runs without them
    rng_bf16 = np.random.default_rng(seed + 3)
    # so do the split-KV decode checks and the extra timed decode shapes,
    # and the G=16 and local split-edge checks
    rng_dec = np.random.default_rng(seed + 5)
    rng_new = np.random.default_rng(seed + 7)
    shapes = decode_timed_shapes(seed)
    for check in (lambda r, m: check_decode(r, m, rng_dec, shapes, rng_new),
                  lambda r, m: check_decode_local(r, m, rng_dec, shapes, rng_new),
                  lambda r, m: check_prefill(r, m, rng_bf16),
                  lambda r, m: check_ragged(r, m, rng_bf16),
                  # the speculative verify's shapes, from their own generator
                  lambda r, m: check_spec_shapes(np.random.default_rng(seed + 11), m)):
        check(rng, measured)
        torch.cuda.empty_cache()
    emit("kernels", tol_f32_tiny=TOL_F32_TINY, tol_bf16_full=TOL_BF16_FULL,
         tol_bf16_row_rel=TOL_BF16_ROW_REL,
         kernels={f"{name}/{fmt}": m for (name, fmt), m in measured.items()})
    return measured


# ---------------------------------------------------------------------- #
# phase: quant_write (the card's quantized page writes vs the CPU's)
# ---------------------------------------------------------------------- #


@torch.no_grad()
def phase_quant_write(seed: int) -> None:
    """A fixed sequence of f32 writes — scale growth, page-start resets,
    duplicate pages (both halves of an int4 byte, one slot twice) and an
    all-layer commit — must leave the same ints and scales on the card as
    on the CPU, bit for bit."""
    L, pages, ps, KH, D = 2, 12, 64, 8, 128
    rng = np.random.default_rng(seed + 2)
    writes = [  # (layer or None = all layers, phys, offs, value scale)
        (1, [3, 3, 3, 4], [0, 1, 2, 0], 0.05),
        (1, [3, 4, 4, 3], [40, 1, 2, 33], 8.0),  # outlier: scales grow
        (0, [5, 5, 5, 5], [7, 39, 7, 40], 1.0),  # one slot twice, both halves
        (1, [3, 3, 6, 6], [0, 1, 0, 32], 0.2),  # page 3 restarts
        (None, [[6, 6, 6, 7], [0, 0, 0, 0]], [[33, 34, 35, 0], [1, 2, 3, 4]], 3.0),
    ]
    done = {}
    for fmt in ("int8", "int4"):
        stores = {dev: [kv_quant.alloc_kv_store(L, pages, ps, KH, D, torch.float32, fmt,
                                                device=dev)] for dev in ("cpu", "cuda")}
        for li, phys, offs, scale in writes:
            ph, of = np.asarray(phys, np.int64), np.asarray(offs, np.int64)
            lead = (L,) if li is None else ()
            vals = (rng.standard_normal((*lead, *ph.shape, KH, D)) * scale).astype(np.float32)
            for dev, (st,) in stores.items():
                args = [torch.from_numpy(a).to(dev) for a in (ph, of, vals)]
                if li is None:
                    kv_quant.kv_write_all_layers(st, *args)
                else:
                    kv_quant.kv_write(st, li, *args)
        torch.cuda.synchronize()
        cpu, gpu = stores["cpu"][0], stores["cuda"][0]
        assert torch.equal(gpu.q.cpu(), cpu.q), f"quant_write[{fmt}]: ints differ"
        assert torch.equal(gpu.s.cpu(), cpu.s), f"quant_write[{fmt}]: scales differ"
        done[fmt] = {"pages_touched": int((cpu.s > 0).any(dim=-1).sum()),
                     "max_scale": float(cpu.s.max())}
    emit("quant_write", writes=len(writes), bit_equal=True, formats=done)


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
    phase_forward_local_int8(params, cfg, rng)


def phase_forward_local_int8(params, cfg, rng) -> None:
    """The local decode block over an int8 pool, 2 layers at full width:
    prefill two sequences into the pool, run K local steps, commit the
    block — kernels against plain attention, each arm on its own pool."""
    ps, pages, B, T, P, K = 64, 64, 2, 200, 17, 4
    tables = torch.zeros((B, P), dtype=torch.int32, device=DEV)
    tables[:, :16] = i32(np.arange(1, 1 + B * 16).reshape(B, 16))
    arms = []
    toks = i32(rng.integers(5, cfg.vocab_size, size=(B, T)))
    steps = i32(rng.integers(5, cfg.vocab_size, size=(K, B)))
    step_idx = [i32([j]) for j in range(K)]
    for plain in (False, True):
        kv = [kv_quant.alloc_kv_store(2, pages, ps, cfg.num_kv_heads, cfg.head_dim,
                                      cfg.dtype, "int8", device=DEV) for _ in range(2)]
        pos = i32(np.arange(T)[None, :].repeat(B, 0))
        pre, _, _ = llama.prefill_forward_batched(
            params, cfg, toks, pos, kv[0], kv[1], tables, i32([0, 0]), i32([T - 1, T - 1]),
            plain_attention=plain)
        loc = torch.zeros((2, 2, B, K, cfg.num_kv_heads, cfg.head_dim), dtype=cfg.dtype,
                          device=DEV)
        pool_lens = i32([T - 1, T - 1])  # the last prompt token is the block's first
        logits = []
        for j in range(K):
            lg, _, _ = llama.decode_forward_local(
                params, cfg, steps[j], pool_lens + j, loc[0], loc[1], step_idx[j],
                kv[0], kv[1], tables, pool_lens, plain_attention=plain)
            logits.append(lg)
        start = T - 1
        blk = start + torch.arange(K, device=DEV)[None, :].expand(B, K)
        phys = torch.gather(tables.long(), 1, (blk // ps).long())
        kv_quant.kv_write_all_layers(kv[0], phys, blk % ps, loc[0])
        kv_quant.kv_write_all_layers(kv[1], phys, blk % ps, loc[1])
        torch.cuda.synchronize()
        arms.append((pre, torch.stack(logits), loc, kv))
    (pre_a, lg_a, loc_a, kv_a), (pre_b, lg_b, loc_b, kv_b) = arms
    worst = {
        "prefill_logits": row_rel_err(pre_a, pre_b),
        "local_logits": row_rel_err(lg_a, lg_b),
        "local_k1": row_rel_err(loc_a[0, 1], loc_b[0, 1]),
        "local_v1": row_rel_err(loc_a[1, 1], loc_b[1, 1]),
    }
    for t in (lg_a, loc_a):
        max_err(t, t)  # finite
    # layer 0 never depends on attention: its local rows and committed
    # int8 pages (ints and scales) agree bit for bit
    assert torch.equal(loc_a[:, 0], loc_b[:, 0]), "forward_local_int8: layer-0 local rows differ"
    for name, a, b in (("k", kv_a[0], kv_b[0]), ("v", kv_a[1], kv_b[1])):
        assert torch.equal(a.q[0], b.q[0]) and torch.equal(a.s[0], b.s[0]), \
            f"forward_local_int8: layer-0 {name} pages differ"
    bad = {k: v for k, v in worst.items() if not v <= TOL_FORWARD_REL}
    emit("forward_local_int8", layers=2, dtype="bfloat16", kv_quant="int8", K=K,
         tol_rel=TOL_FORWARD_REL, layer0_equal=True, max_row_rel_err=worst)
    assert not bad, f"forward_local_int8: kernels vs plain attention disagree: {bad}"


# ---------------------------------------------------------------------- #
# phase: serve
# ---------------------------------------------------------------------- #


def pct(xs, p):
    return float(np.percentile(np.asarray(xs, dtype=np.float64), p)) if xs else None


async def run_request(engine, req: dict, record: dict, after=None) -> None:
    """Stream one request into `record`; `after` (an asyncio.Event) delays
    the submission until another request has produced its first token."""
    async def open_stream(r):
        return engine.generate(r, Context())

    await run_stream(open_stream, req, record, after)


async def run_stream(open_stream, req: dict, record: dict, after=None) -> None:
    """As run_request, with the stream opened by `await open_stream(req)`
    (in process: the engine's generate; over the wire: a PushRouter's)."""
    if after is not None:
        await after.wait()
    t0 = time.perf_counter()
    last = t0
    async for item in await open_stream(req):
        if item.get("event") == "error":
            raise RuntimeError(f"engine error: {item}")
        if item.get("event") == "remote_prefill":
            record["remote"] = item["comment"] == ["true"]
            continue
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


def reset_counts() -> None:
    for k in KERNELS.values():
        k["module"].launch_count = 0
        for fmt in k["module"].launches_by_format:
            k["module"].launches_by_format[fmt] = 0
    for name in pa.plain_calls:
        pa.plain_calls[name] = 0


def check_path_launches(phase: str, launches: dict, plain: dict, mode: str, kvq: str) -> None:
    """Every attention kernel of the (decode pool mode, KV format) path
    launched, no other, and no plain attention call."""
    decode_kernel = "paged_decode_local" if mode == "local" else "paged_decode"
    used = [(name, kvq) for name in (decode_kernel, "prefill_attention", "ragged_attention")]
    assert all(launches.get(u, 0) > 0 for u in used), f"{phase}: a path kernel never launched: {launches}"
    assert sum(launches.values()) == sum(launches[u] for u in used), \
        f"{phase}: a kernel outside the path launched: {launches}"
    assert not any(plain.values()), f"{phase}: plain attention ran on the card's main path: {plain}"


def kernel_launches() -> dict:
    return {(name, fmt): n for name, k in KERNELS.items()
            for fmt, n in k["module"].launches_by_format.items()}


WORDS = ["paged", "attention", "kernel", "hopper", "decode", "prefill",
         "ragged", "token", "cache", "block", "stream", "engine"]


def make_requests(seed: int, vocab: int, lengths, shared_idx, seeded_idx, tag: str):
    """Byte-tokenized prompts of the given lengths; the requests at
    `shared_idx` start with the same four pages, those at `seeded_idx`
    sample at temperature 0.7 with their own seed. Returns the request
    dicts and the prompt maker (for further prompts from the same stream)."""
    tok = ByteTokenizer(vocab)
    rng = np.random.default_rng(seed)

    def text(n_tokens: int, salt: int) -> list:
        out = f"request {salt}: "
        while len(out) < n_tokens:
            out += WORDS[int(rng.integers(len(WORDS)))] + " "
        return tok.encode(out[:n_tokens])

    shared = text(256, 99)  # four full pages of common prefix
    reqs = []
    for i, n in enumerate(lengths):
        ids = text(n, i)
        sampling = {}
        if i in shared_idx:
            ids = shared + ids[256:] if n > 256 else shared + ids
        if i in seeded_idx:
            sampling = {"temperature": 0.7, "seed": 1000 + i}
        reqs.append(PreprocessedRequest(
            token_ids=ids, request_id=f"{tag}-{i}",
            stop_conditions={"max_tokens": MAX_TOKENS},
            sampling_options=sampling,
        ).to_dict())
    return reqs, text


SERVE_LENGTHS = [40, 300, 1500, 120, 700, 64, 1100, 40, 500, 900, 220, 1300]


async def serve(seed: int, phase: str, mode: str, kvq: str, layers: int, params,
                model: str = "llama3-3b", quantize=None, lengths=SERVE_LENGTHS,
                seeded_pair: bool = True, before_close=None, **engine_kw) -> dict:
    """The mix of `lengths` (SERVE_LENGTHS: 12 requests, shared prefix at 1
    and 8, seeded at 3 and 10; any 8 of them keep 1 and 3) on an engine of
    `model` at `layers` over `params` (None: the engine's own init from the
    seed, int8 as it is drawn under `quantize`), with the kernel counts set
    to 0 just before and read just after. `before_close(engine)` may return
    more fields for the phase's line; `engine_kw` are more EngineConfig
    fields."""
    model_cfg = dataclasses.replace(_resolve_model(model), num_layers=layers)
    if params is not None and layers != LAYERS:  # a cut depth: the full model's first layers
        params = dict(params, layers={k: v[:layers] for k, v in params["layers"].items()})
    t0 = time.perf_counter()
    engine = TorchEngine(
        EngineConfig(model=model, seed=seed, decode_pool_mode=mode, kv_quant=kvq,
                     quantize=quantize, **engine_kw),
        model_config=model_cfg, params=params, device="cuda",
    )
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_warm = await engine.warmup()
    warm_s = time.perf_counter() - t0
    # two differently seeded sampled streams in the traffic (3, 10)
    shared_idx = (1, 8) if len(lengths) > 8 else (1, 6)
    reqs, text = make_requests(
        seed, model_cfg.vocab_size, lengths,
        shared_idx=shared_idx, seeded_idx=(3, 10), tag=f"{phase}")

    # counts to zero just before the main path is driven
    reset_counts()
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
        after = records[shared_idx[0]]["first"] if i == shared_idx[1] else None
        tasks.append(asyncio.create_task(run_request(engine, req, rec, after)))
        await asyncio.sleep(STAGGER_S)
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t_start
    launches = kernel_launches()
    plain = dict(pa.plain_calls)
    stats = engine.stats()
    peak_gib = round(torch.cuda.max_memory_allocated() / 2**30, 2)

    # seeded reproducibility: the same seeded request twice, each alone on
    # the engine (identical dispatch shapes, so the arithmetic is identical)
    seeded = PreprocessedRequest(
        token_ids=text(40, 777), stop_conditions={"max_tokens": MAX_TOKENS},
        sampling_options={"temperature": 0.7, "seed": 4242},
    )
    pair = []
    for run in range(2 if seeded_pair else 0):
        rec = new_record()
        req = dict(seeded.to_dict(), request_id=f"seeded-{run}")
        await run_request(engine, req, rec)
        pair.append(rec["tokens"])
    extra = {} if before_close is None else before_close(engine)
    await engine.close()

    for i, rec in enumerate(records):
        assert rec["finish"] == "length", f"{phase}: request {i} finished with {rec['finish']}"
        assert len(rec["tokens"]) == MAX_TOKENS, (phase, i, len(rec["tokens"]))
        assert all(0 <= t < model_cfg.vocab_size for t in rec["tokens"]), (phase, i)
    if seeded_pair:
        assert pair[0] == pair[1] and len(pair[0]) == MAX_TOKENS, \
            f"{phase}: the two runs of the seeded request differ"
    check_path_launches(phase, launches, plain, mode, kvq)
    mixed = stats["mixed_steps"] - base["mixed_steps"]
    hits = (stats["kv_prefix_hit_blocks_total"] - base["kv_prefix_hit_blocks_total"]
            + stats["kv_skip_ahead_blocks"] - base["kv_skip_ahead_blocks"])
    assert mixed >= 1, f"{phase}: no mixed step ran"
    assert hits > 0, f"{phase}: the shared prefix never hit the prefix cache"

    dev_time = dev_time_delta(stats, base)
    n_out = sum(len(r["tokens"]) for r in records)
    itl = [x for r in records for x in r["itl_s"]]
    ttft = [r["ttft_s"] for r in records]
    emit(
        phase, model="llama-3.2-3b" if model == "llama3-3b" else model, layers=layers,
        dtype="bfloat16", quantize=quantize or "none", weight_bytes=stats["weight_bytes"],
        decode_pool_mode=mode, kv_quant=kvq, kv_pool_bytes=stats["kv_pool_bytes"],
        num_pages=stats["kv_total_blocks"],
        requests=len(reqs), prompt_tokens=[len(r["token_ids"]) for r in reqs],
        max_tokens=MAX_TOKENS, init_s=round(init_s, 3), warmup_dispatches=n_warm,
        warmup_s=round(warm_s, 3), wall_s=round(wall, 3),
        output_tok_s=round(n_out / wall, 1),
        ttft_ms={"p50": round(1e3 * pct(ttft, 50), 2), "p99": round(1e3 * pct(ttft, 99), 2)},
        itl_ms={"p50": round(1e3 * pct(itl, 50), 3), "p99": round(1e3 * pct(itl, 99), 3)},
        mixed_steps=mixed, split_steps=stats["split_steps"] - base["split_steps"],
        prefix_hit_blocks=hits, num_preemptions=stats["num_preemptions"],
        launches={f"{n}/{f}": c for (n, f), c in launches.items() if c},
        plain_calls=plain, dev_time=dev_time, seeded_pair_equal=True if seeded_pair else None,
        peak_memory_gib=peak_gib, **extra,
    )
    del engine
    torch.cuda.empty_cache()
    return launches


def dev_time_delta(stats: dict, base: dict) -> dict:
    """Device time per dispatch kind between two stats() of one engine."""
    out = {}
    for tag, cur in stats["dev_time"].items():
        prev = base["dev_time"].get(tag, {"count": 0, "seconds": 0.0})
        n = cur["count"] - prev["count"]
        s = cur["seconds"] - prev["seconds"]
        if n:
            out[tag] = {"count": n, "seconds": round(s, 4), "ms_per_dispatch": round(1e3 * s / n, 3)}
    return out


def model_params(seed: int) -> dict:
    """Llama-3.2-3B's random weights from `seed`, on the card."""
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed)
    return llama.init_params(llama.LlamaConfig.llama3_2_3b(), gen, device=DEV)


async def serve_all(seed: int, params) -> dict:
    """Every served path, one engine at a time, on one set of weights."""
    total: dict = {}
    for phase, mode, kvq, layers in SERVE_PHASES:
        for key, n in (await serve(seed, phase, mode, kvq, layers, params)).items():
            total[key] = total.get(key, 0) + n
    return total


# ---------------------------------------------------------------------- #
# phase: worker (the same engine served over the request plane)
# ---------------------------------------------------------------------- #

# (phase, decode_pool_mode, kv_quant, layers): both at a cut depth, which
# pays for the durable and the MoE phases' time
# the (scatter, bf16) worker, disagg and disagg_subprocess phases: full
# width, a cut depth; disagg_subprocess's CLI workers serve the weights_load
# checkpoint of as many layers, so the worker phase's streams are its reference
WORKER_LAYERS = 4
WORKER_PHASES = [("worker", "scatter", "none", WORKER_LAYERS),
                 ("worker_local_int8", "local", "int8", 4)]
WORKER_LENGTHS = [40, 300, 1500, 120, 700, 64, 1100, 500]


def stream_metrics(records, wall: float) -> dict:
    n_out = sum(len(r["tokens"]) for r in records)
    itl = [x for r in records for x in r["itl_s"]]
    ttft = [r["ttft_s"] for r in records]
    return {
        "wall_s": round(wall, 3), "output_tok_s": round(n_out / wall, 1),
        "ttft_ms": {"p50": round(1e3 * pct(ttft, 50), 2), "p99": round(1e3 * pct(ttft, 99), 2)},
        "itl_ms": {"p50": round(1e3 * pct(itl, 50), 3), "p99": round(1e3 * pct(itl, 99), 3)},
    }


def new_record() -> dict:
    return {"tokens": [], "itl_s": [], "finish": None, "first": asyncio.Event(),
            "remote": None}


async def drive(open_stream, reqs, shared_after: tuple) -> tuple:
    """The requests staggered by STAGGER_S (request shared_after[1] waits
    for request shared_after[0]'s first token): records and wall seconds."""
    records = [new_record() for _ in reqs]
    t0 = time.perf_counter()
    tasks = []
    for i, (req, rec) in enumerate(zip(reqs, records)):
        after = records[shared_after[0]]["first"] if i == shared_after[1] else None
        tasks.append(asyncio.create_task(run_stream(open_stream, req, rec, after)))
        await asyncio.sleep(STAGGER_S)
    await asyncio.gather(*tasks)
    return records, time.perf_counter() - t0


async def alone(open_stream, clear, reqs) -> list:
    """Each request alone on an engine with an empty prefix cache, so its
    dispatch shapes (and so its bf16 arithmetic) do not depend on the
    others: the token streams."""
    out = []
    for req in reqs:
        await clear()
        rec = new_record()
        await run_stream(open_stream, req, rec)
        assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, (req["request_id"], rec)
        out.append(rec["tokens"])
    return out


async def worker_in_process(seed: int, phase: str, mode: str, kvq: str, layers: int,
                            params) -> dict:
    """The engine in process, then the same engine behind a port worker on
    this process's discovery server, reached through a PushRouter."""
    from dynamo_tpu_torch.llm.kv_router.publisher import EVENT_TOPIC_FMT, METRICS_TOPIC_FMT
    from dynamo_tpu_torch.runtime import DiscoveryServer, DistributedRuntime, PushRouter, RuntimeConfig
    from dynamo_tpu_torch.runtime import codec
    from dynamo_tpu_torch.worker.__main__ import parse_args, serve as serve_worker

    model_cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=layers)
    engine = TorchEngine(
        EngineConfig(model="llama3-3b", seed=seed, decode_pool_mode=mode, kv_quant=kvq),
        model_config=model_cfg, params=cut_depth(params, layers), device="cuda",
    )
    await engine.warmup()
    reqs, text = make_requests(seed, model_cfg.vocab_size, WORKER_LENGTHS,
                               shared_idx=(1, 6), seeded_idx=(3,), tag=phase)
    seeded = PreprocessedRequest(
        token_ids=text(40, 777), request_id=f"{phase}-seeded",
        stop_conditions={"max_tokens": MAX_TOKENS},
        sampling_options={"temperature": 0.7, "seed": 4242},
    ).to_dict()

    async def local_stream(r):
        return engine.generate(r, Context())

    async def local_clear():
        engine.clear_kv_blocks()

    local_recs, local_wall = await drive(local_stream, reqs, (1, 6))
    local_alone = await alone(local_stream, local_clear, reqs + [seeded, seeded])
    assert local_alone[-1] == local_alone[-2], f"{phase}: the seeded pair differs in process"

    server = DiscoveryServer(port=0)
    _, port = await server.start()
    disc = f"tcp://127.0.0.1:{port}"
    args = parse_args(["--model", "llama3-3b", "--discovery", disc, "--kv-events",
                       "--decode-pool-mode", mode, "--kv-quant", kvq, "--warmup", "none"])
    started = asyncio.get_running_loop().create_future()
    task = asyncio.create_task(serve_worker(args, engine, started))
    await asyncio.wait({task, started}, timeout=60, return_when=asyncio.FIRST_COMPLETED)
    if task.done():
        task.result()
    worker = started.result()
    cfg = RuntimeConfig.from_settings()
    cfg.discovery_endpoint = disc
    drt = await DistributedRuntime.create(cfg)
    try:
        kv_sub = await drt.discovery.subscribe(
            EVENT_TOPIC_FMT.format(namespace="dynamo", component="backend"))
        met_sub = await drt.discovery.subscribe(
            METRICS_TOPIC_FMT.format(namespace="dynamo", component="backend"))
        client = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(30)
        router = PushRouter(client)

        async def wire_clear():
            items = [it async for it in await router.generate(
                {"token_ids": [1], "annotations": ["clear_kv_blocks"]})]
            assert items and items[0]["event"] == "clear_kv_blocks", items

        await wire_clear()
        # counts to zero just before the main path is driven over the wire
        reset_counts()
        base = engine.stats()
        wire_recs, wire_wall = await drive(router.generate, reqs, (1, 6))
        wire_alone = await alone(router.generate, wire_clear, reqs + [seeded, seeded])
        launches = kernel_launches()
        plain = dict(pa.plain_calls)
        stats = engine.stats()
        ep = worker.served.stats
        kv_msgs = []
        while (m := await kv_sub.get(timeout=0.5)) is not None:
            kv_msgs.append(codec.unpack(m))
        met = codec.unpack(await met_sub.get(timeout=5))
        await client.close()
    finally:
        await drt.close()
        worker.drt.shutdown()
        await asyncio.wait_for(task, 60)
        await engine.close()
        await server.stop()

    for recs in (local_recs, wire_recs):
        for i, rec in enumerate(recs):
            assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, (phase, i)
            assert all(0 <= t < model_cfg.vocab_size for t in rec["tokens"]), (phase, i)
    for i, (a, b) in enumerate(zip(local_alone, wire_alone)):
        assert a == b, f"{phase}: request {i} streams other tokens over the wire than in process"
    check_path_launches(phase, launches, plain, mode, kvq)
    assert stats["mixed_steps"] - base["mixed_steps"] >= 1, f"{phase}: no mixed step ran"
    stored = sum(1 for m in kv_msgs for ev in m["events"] if ev["event_type"] == "stored")
    assert stored > 0, f"{phase}: no stored KV event reached the topic"
    assert met["worker_id"] == worker.drt.instance_id and "num_running_reqs" in met["stats"]
    wire_tokens = sum(len(r["tokens"]) for r in wire_recs) + MAX_TOKENS * len(wire_alone)
    emit(
        phase, model="llama-3.2-3b", layers=layers, dtype="bfloat16", decode_pool_mode=mode,
        kv_quant=kvq, requests=len(reqs), prompt_tokens=[len(r["token_ids"]) for r in reqs],
        max_tokens=MAX_TOKENS, in_process=stream_metrics(local_recs, local_wall),
        over_the_wire=stream_metrics(wire_recs, wire_wall),
        streams_equal=len(wire_alone), seeded_pair_equal=True,
        frames={"total": ep.frames_total, "binary": ep.frames_binary, "items": ep.items_total,
                "tokens": wire_tokens,
                "frames_per_token": round(ep.frames_total / wire_tokens, 4),
                "binary_frames_per_token": round(ep.frames_binary / wire_tokens, 4)},
        kv_event_messages=len(kv_msgs), kv_stored_events=stored,
        launches={f"{n}/{f}": c for (n, f), c in launches.items() if c}, plain_calls=plain,
    )
    del worker, engine
    torch.cuda.empty_cache()
    reference = {"reqs": reqs, "alone": local_alone[:len(reqs)],
                 "metrics": stream_metrics(local_recs, local_wall)}
    return launches, reference


async def worker_subprocess(seed: int) -> None:
    """`python -m dynamo_tpu_torch.worker --model llama3-3b` as a user runs
    it (device cuda, pool auto-sized), with two `--lora` adapters (a rank-8
    PEFT export written here and a `random:SEED` one): it must register with
    a card that lists both, answer a request and a `lora_name` request over
    the wire, and drain on SIGTERM."""
    import os
    import shutil
    import signal
    import tempfile
    from pathlib import Path

    from dynamo_tpu_torch.llm.kv_router.publisher import METRICS_TOPIC_FMT
    from dynamo_tpu_torch.runtime import DiscoveryServer, DistributedRuntime, PushRouter, RuntimeConfig
    from dynamo_tpu_torch.runtime import codec

    server = DiscoveryServer(port=0)
    _, port = await server.start()
    disc = f"tcp://127.0.0.1:{port}"
    cfg = RuntimeConfig.from_settings()
    cfg.discovery_endpoint = disc
    drt = await DistributedRuntime.create(cfg)
    root = Path(__file__).resolve().parent
    log = tempfile.NamedTemporaryFile(prefix="torch_worker_", suffix=".log", delete=False)
    env = dict(os.environ, PYTHONPATH=str(root))
    peft = write_peft(tempfile.mkdtemp(prefix="smoke_peft_"), llama.LlamaConfig.llama3_2_3b(),
                      8, 82)
    proc = None
    try:
        cards = await drt.discovery.watch_prefix("v1/mdc/dynamo/backend/generate/")
        met_sub = await drt.discovery.subscribe(
            METRICS_TOPIC_FMT.format(namespace="dynamo", component="backend"))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.worker", "--model", "llama3-3b",
             "--num-pages", "0", "--seed", str(seed), "--discovery", disc,
             "--lora", f"sub8={peft}", "--lora", f"rnd=random:{LORA_RANDOM_SEED}"],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        while True:
            ev = await cards.get(timeout=1.0)
            if ev is not None and ev.type == "put":
                break
            if proc.poll() is not None or time.perf_counter() - t0 > 600:
                raise RuntimeError(f"the worker never registered (rc {proc.poll()}): "
                                   f"{Path(log.name).read_text()[-3000:]}")
        t_reg = time.perf_counter() - t0
        card_loras = json.loads(ev.value)["lora_adapters"]
        assert card_loras == ["sub8", "rnd"], card_loras
        stats = codec.unpack(await met_sub.get(timeout=10))["stats"]
        client = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(30)
        streams = {}
        for name in (None, "rnd"):
            req = {"token_ids": list(range(100, 140)), "stop_conditions": {"max_tokens": 16},
                   **({"lora_name": name} if name else {})}
            items = [it async for it in await PushRouter(client).generate(req)]
            toks = [t for it in items for t in (it.get("data") or {}).get("token_ids", [])]
            finish = [it["data"].get("finish_reason") for it in items if it.get("data")][-1]
            assert len(toks) == 16 and finish == "length", items
            streams[name] = toks
        assert streams["rnd"] != streams[None], "the worker's adapter did not change the stream"
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = await asyncio.get_running_loop().run_in_executor(None, proc.wait, 120)
        t_drain = time.perf_counter() - t1
        assert rc == 0, f"the worker exited {rc} on SIGTERM: {Path(log.name).read_text()[-3000:]}"
        for _ in range(100):  # the lease's keys go with the drain
            if not client.instance_ids():
                break
            await asyncio.sleep(0.05)
        assert not client.instance_ids(), "the drained worker is still registered"
        await client.close()
        emit("worker_subprocess", model="llama-3.2-3b", layers=LAYERS,
             seconds_to_registration=round(t_reg, 2), num_pages=stats["kv_total_blocks"],
             kv_pool_bytes=stats["kv_pool_bytes"], kv_pool_gib=round(stats["kv_pool_bytes"] / 2**30, 2),
             request_tokens=len(toks), lora_adapters=card_loras, lora_request_tokens=len(toks),
             seconds_to_exit_after_sigterm=round(t_drain, 2),
             exit_code=rc, weight_bytes=stats["weight_bytes"],
             smoke_process_gib=round(torch.cuda.memory_reserved() / 2**30, 2))
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        os.unlink(log.name)
        shutil.rmtree(peft, ignore_errors=True)
        await drt.close()
        await server.stop()


async def worker_all(seed: int, params) -> tuple:
    """Launches of both worker phases, and the (scatter, bf16) phase's
    in-process streams and metrics: the aggregated reference of `disagg`."""
    total: dict = {}
    reference = None
    for phase, mode, kvq, layers in WORKER_PHASES:
        launches, ref = await worker_in_process(seed, phase, mode, kvq, layers, params)
        for key, n in launches.items():
            total[key] = total.get(key, 0) + n
        if (mode, kvq) == ("scatter", "none"):
            reference = ref
    return total, reference


# ---------------------------------------------------------------------- #
# phase: disagg (a prefill engine hands each prompt's KV to a decode engine)
# ---------------------------------------------------------------------- #

DISAGG_PAGES = 1024  # each side's pool (~7 GiB bf16): two of them share the card
DISAGG_THRESHOLD = 16  # uncached tokens above which a prompt goes to the prefill side
PROBE_REQ = 2  # the mix's 1500-token request: the serial handoff probe


class EngineClient:
    """A prefill pool of one in-process engine, as the decode side's handler
    (`worker/disagg_handler.py`) sees an endpoint client."""

    def __init__(self, engine):
        self.engine = engine
        self.endpoint = types.SimpleNamespace(subject="dynamo/prefill/generate")

    def instance_ids(self):
        return [1]

    ready_instance_ids = instance_ids

    async def direct(self, request, instance_id, context=None):
        return self.engine.generate(request, Context())


def remote(req: dict) -> dict:
    return dict(req, annotations=["remote_prefill"])


def stat_delta(after: dict, before: dict, key: str):
    return after.get(key, 0) - before.get(key, 0)


def dev_delta(after: dict, before: dict, tag: str) -> tuple:
    """(count, seconds) of one dev_time tag between two stats()."""
    a = after["dev_time"].get(tag, {"count": 0, "seconds": 0.0})
    b = before["dev_time"].get(tag, {"count": 0, "seconds": 0.0})
    return a["count"] - b["count"], a["seconds"] - b["seconds"]


def calls_delta(after: dict, before: dict) -> dict:
    """Attention calls (kernel launches by "kernel/format", plain calls by
    op) between two stats() of one process."""
    out = {}
    for kind in ("kernels", "plain"):
        a, b = after["attention_calls"][kind], before["attention_calls"][kind]
        for k in set(a) | set(b):
            if a.get(k, 0) - b.get(k, 0):
                out[f"{kind}:{k}"] = a.get(k, 0) - b.get(k, 0)
    return out


def handoff_costs(pre_a: dict, pre_b: dict, dec_a: dict, dec_b: dict,
                  serial: bool = True) -> dict:
    """Per-page handoff costs between two stats() pairs: extract (the
    prefill side's gather, pack and, over TCP, pinned host copy), inject
    (the decode side's copy in and scatter) and, for a serial pull (staged
    after the prefill), its wall time, what that holds beyond extract and
    inject, and its bytes per second. A streamed pull's wall includes
    waiting for the producer's prefill, so only the first two are given."""
    n_ex, s_ex = dev_delta(pre_a, pre_b, "kv_extract")
    n_in, s_in = dev_delta(dec_a, dec_b, "kv_inject")
    pages_ex = stat_delta(pre_a, pre_b, "kv_pages_extracted")
    pages_in = stat_delta(dec_a, dec_b, "kv_pages_injected")
    pages = stat_delta(dec_a, dec_b, "kv_pages_pulled")
    wall = stat_delta(dec_a, dec_b, "kv_pull_s")
    nbytes = stat_delta(pre_a, pre_b, "kv_bytes_served")
    out = {"pages": pages, "bytes": nbytes, "extract_calls": n_ex, "inject_calls": n_in}
    if pages_ex and pages_in:
        out.update(extract_ms_per_page=round(1e3 * s_ex / pages_ex, 4),
                   inject_ms_per_page=round(1e3 * s_in / pages_in, 4))
    if serial and pages_ex and pages_in and pages:
        ex, inj, w = 1e3 * s_ex / pages_ex, 1e3 * s_in / pages_in, 1e3 * wall / pages
        out.update(pull_wall_ms_per_page=round(w, 4),
                   # what the pull's wall holds beyond extract and inject:
                   # the socket (or, in process, the hand-over) and the loop
                   socket_ms_per_page=round(w - ex - inj, 4),
                   gb_per_s=round(nbytes / wall / 1e9, 3) if nbytes else None)
    return out


async def aggregated_reference(seed: int, mode: str, kvq: str, layers: int, params,
                               reqs) -> dict:
    """One aggregated engine on the mix: the staggered run's metrics and
    each request's stream alone (the disagg pair must equal them)."""
    model_cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=layers)
    if layers != LAYERS:
        params = dict(params, layers={k: v[:layers] for k, v in params["layers"].items()})
    engine = TorchEngine(
        EngineConfig(model="llama3-3b", seed=seed, decode_pool_mode=mode, kv_quant=kvq,
                     num_pages=DISAGG_PAGES),
        model_config=model_cfg, params=params, device="cuda",
    )
    await engine.warmup()

    async def stream(r):
        return engine.generate(r, Context())

    async def clear():
        engine.clear_kv_blocks()

    recs, wall = await drive(stream, reqs, (1, 6))
    streams = await alone(stream, clear, reqs)
    await engine.close()
    del engine
    torch.cuda.empty_cache()
    return {"reqs": reqs, "alone": streams, "metrics": stream_metrics(recs, wall)}


async def disagg_in_process(seed: int, phase: str, mode: str, kvq: str, layers: int,
                            params, reference: dict) -> dict:
    """A prefill engine and a decode engine on one card, the handoff through
    the data plane's in-process registry (device tensors, no host copy),
    driven through the decode side's disagg handler with the streamed
    handoff; then the serial handoff of the longest prompt over TCP on
    localhost and in process, for its per-page costs."""
    from dynamo_tpu_torch.llm import kv_transfer
    from dynamo_tpu_torch.llm.disagg import DisaggConfig, DisaggregatedRouter
    from dynamo_tpu_torch.worker.disagg_handler import maybe_remote_prefill

    model_cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=layers)
    if layers != LAYERS:
        params = dict(params, layers={k: v[:layers] for k, v in params["layers"].items()})
    cfg = EngineConfig(model="llama3-3b", seed=seed, decode_pool_mode=mode, kv_quant=kvq,
                       num_pages=DISAGG_PAGES)
    pre = TorchEngine(dataclasses.replace(cfg, role="prefill"), model_config=model_cfg,
                      params=params, device="cuda")
    dec = TorchEngine(cfg, model_config=model_cfg, params=params, device="cuda")
    plane = kv_transfer.KvDataPlaneServer(host="127.0.0.1")
    await plane.start()
    pre.data_plane = plane
    try:
        await pre.warmup()
        await dec.warmup()
        client = EngineClient(pre)
        router = DisaggregatedRouter(DisaggConfig(remote_prefill_threshold_tokens=DISAGG_THRESHOLD))

        async def stream(r):
            return maybe_remote_prefill(dec, client, router, remote(r), Context())

        async def clear():
            pre.clear_kv_blocks()
            dec.clear_kv_blocks()

        reqs = reference["reqs"]
        await clear()
        # counts to zero just before the main path is driven
        reset_counts()
        pre_b, dec_b = pre.stats(), dec.stats()
        recs, wall = await drive(stream, reqs, (1, 6))
        streams = await alone(stream, clear, reqs)
        launches = {(name, fmt): n for name, k in KERNELS.items()
                    for fmt, n in k["module"].launches_by_format.items()}
        plain = dict(pa.plain_calls)
        pre_a, dec_a = pre.stats(), dec.stats()

        # the serial handoff of one prompt, over TCP and in process
        probe = {}
        req = reqs[PROBE_REQ]
        for path in ("tcp", "in_process"):
            await clear()
            p_b, d_b = pre.stats(), dec.stats()
            pre_req = dict(req, stop_conditions={"max_tokens": 1},
                           disagg_params={"return_kv": True, "kv_pull": True})
            first, kvp = [], None
            async for item in pre.generate(pre_req, Context()):
                data = item.get("data") or {}
                first += data.get("token_ids") or []
                kvp = data.get("kv_transfer_params") or kvp
            if path == "tcp":
                kv_transfer._LOCAL.pop((plane.addr, kvp["pull"]["transfer_id"]))
            toks = list(first)
            async for item in dec.generate_decode_from_pull(req, Context(), first[0], kvp["pull"]):
                toks += (item.get("data") or {}).get("token_ids") or []
            assert toks == reference["alone"][PROBE_REQ], f"{phase}: the {path} probe's stream differs"
            probe[path] = handoff_costs(pre.stats(), p_b, dec.stats(), d_b)
    finally:
        for x in (pre, dec, plane):
            await x.close()

    for i, rec in enumerate(recs):
        assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, (phase, i)
        assert rec["remote"] is True, f"{phase}: request {i} was not prefilled remotely"
    for i, (a, b) in enumerate(zip(reference["alone"], streams)):
        assert a == b, f"{phase}: request {i} streams other tokens disaggregated than aggregated"
    n = 2 * len(reqs)
    assert stat_delta(dec_a, dec_b, "kv_pull_fallbacks") == 0, f"{phase}: a pull fell back"
    assert stat_delta(dec_a, dec_b, "kv_pulls_completed") == n, phase
    assert stat_delta(dec_a, dec_b, "disagg_streamed_handoffs") == n, phase
    decode_kernel = "paged_decode_local" if mode == "local" else "paged_decode"
    used = [(decode_kernel, kvq), ("prefill_attention", kvq)]
    assert all(launches[u] > 0 for u in used), f"{phase}: a path kernel never launched: {launches}"
    assert sum(launches.values()) == sum(launches[u] for u in used), \
        f"{phase}: a kernel outside the path launched: {launches}"
    assert not any(plain.values()), f"{phase}: plain attention ran on the card's main path: {plain}"
    # per side: the prefill engine decoded nothing, the decode engine prefilled nothing
    pre_dispatch = {t: dev_delta(pre_a, pre_b, t)[0] for t in ("prefill", "mixed", "block")}
    dec_dispatch = {t: dev_delta(dec_a, dec_b, t)[0] for t in ("prefill", "mixed", "block")}
    assert pre_dispatch["prefill"] > 0 and pre_dispatch["mixed"] == pre_dispatch["block"] == 0, \
        (phase, pre_dispatch)
    assert dec_dispatch["block"] > 0 and dec_dispatch["prefill"] == dec_dispatch["mixed"] == 0, \
        (phase, dec_dispatch)
    emit(
        phase, model="llama-3.2-3b", layers=layers, dtype="bfloat16", decode_pool_mode=mode,
        kv_quant=kvq, num_pages_each=DISAGG_PAGES, requests=len(reqs),
        prompt_tokens=[len(r["token_ids"]) for r in reqs], max_tokens=MAX_TOKENS,
        aggregated=reference["metrics"], disaggregated=stream_metrics(recs, wall),
        streams_equal=len(streams), remote_prefills=sum(r["remote"] is True for r in recs),
        kv_pulls_completed=stat_delta(dec_a, dec_b, "kv_pulls_completed"),
        streamed_handoffs=stat_delta(dec_a, dec_b, "disagg_streamed_handoffs"),
        first_token_before_last_chunk=stat_delta(dec_a, dec_b, "disagg_first_token_before_last_chunk"),
        fallbacks=stat_delta(dec_a, dec_b, "kv_pull_fallbacks"),
        handoff_in_run=handoff_costs(pre_a, pre_b, dec_a, dec_b, serial=False),
        serial_probe={"prompt_tokens": len(reqs[PROBE_REQ]["token_ids"]), **probe},
        dispatches={"prefill_side": pre_dispatch, "decode_side": dec_dispatch},
        launches={f"{n}/{f}": c for (n, f), c in launches.items() if c}, plain_calls=plain,
    )
    del pre, dec
    torch.cuda.empty_cache()
    return launches


async def latest_stats(sub) -> dict:
    """The stats of the next message on a metrics topic (drains the queue
    first, so the message was published after this call)."""
    from dynamo_tpu_torch.runtime import codec

    while await sub.get(timeout=0.01) is not None:
        pass
    return codec.unpack(await sub.get(timeout=10))["stats"]


async def disagg_subprocess(seed: int, reference: dict, ckpt: str) -> None:
    """One aggregated `python -m dynamo_tpu_torch.worker --model-path <the
    weights_load checkpoint>` (`--num-pages` as each of the pair; WORKER_LAYERS
    layers, as the worker phase's reference streams), then `--role prefill`
    and `--role decode` on one card,
    the handoff over TCP on localhost; each deployment driven with the same
    mix through the port's PushRouter. The aggregated worker's run is the
    baseline of the pair: both pay the wire, only the pair the handoff.
    Kernel launches are read per worker from the stats each publishes."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    from dynamo_tpu_torch.llm import kv_transfer
    from dynamo_tpu_torch.llm.kv_router.publisher import METRICS_TOPIC_FMT
    from dynamo_tpu_torch.runtime import (DiscoveryServer, DistributedRuntime, PushRouter,
                                          RouterMode, RuntimeConfig)

    server = DiscoveryServer(port=0)
    _, port = await server.start()
    disc = f"tcp://127.0.0.1:{port}"
    cfg = RuntimeConfig.from_settings()
    cfg.discovery_endpoint = disc
    drt = await DistributedRuntime.create(cfg)
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    procs, logs, rcs = {}, {}, {}
    try:
        cards = await drt.discovery.watch_prefix("v1/mdc/dynamo/backend/generate/")
        subs = {role: await drt.discovery.subscribe(METRICS_TOPIC_FMT.format(
            namespace="dynamo", component=comp)) for role, comp in (("prefill", "prefill"),
                                                                   ("decode", "backend"))}

        def spawn(name, *extra):
            logs[name] = tempfile.NamedTemporaryFile(prefix=f"torch_{name}_", suffix=".log",
                                                     delete=False)
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "dynamo_tpu_torch.worker", "--model", "llama3-3b",
                 "--model-path", ckpt, "--num-pages", str(DISAGG_PAGES), "--seed", str(seed),
                 "--discovery", disc, *extra],
                cwd=root, env=env, stdout=logs[name], stderr=subprocess.STDOUT,
            )

        def tail(name):
            return Path(logs[name].name).read_text()[-3000:]

        def check_alive():
            for name, proc in procs.items():
                if proc.poll() is not None:
                    raise RuntimeError(f"the {name} worker exited {proc.poll()}: {tail(name)}")

        async def registered(t0):
            while True:
                ev = await cards.get(timeout=1.0)
                if ev is not None and ev.type == "put":
                    return
                check_alive()
                if time.perf_counter() - t0 > 600:
                    raise RuntimeError("the worker never registered")

        async def reap(name):  # after its SIGTERM: it must drain and exit 0
            proc = procs.pop(name)
            rcs[name] = await asyncio.get_running_loop().run_in_executor(None, proc.wait, 120)
            assert rcs[name] == 0, f"the {name} worker exited {rcs[name]} on SIGTERM: {tail(name)}"

        async def clear_on(router):
            items = [it async for it in await router.generate(
                {"token_ids": [1], "annotations": ["clear_kv_blocks"]})]
            assert items and items[0]["event"] == "clear_kv_blocks", items

        reqs = reference["reqs"]
        # the aggregated deployment of the same shape: one worker, the same
        # pool, the same mix over the same wire
        spawn("aggregated")
        await registered(time.perf_counter())
        agg_client = await drt.namespace("dynamo").component("backend").endpoint(
            "generate").client()
        await agg_client.wait_for_instances(30)
        agg = PushRouter(agg_client)

        async def agg_clear():
            await clear_on(agg)

        await agg_clear()
        agg_recs, agg_wall = await drive(agg.generate, reqs, (1, 6))
        agg_streams = await alone(agg.generate, agg_clear, reqs)
        procs["aggregated"].send_signal(signal.SIGTERM)
        await reap("aggregated")
        for _ in range(100):  # the lease's keys go with the drain
            if not agg_client.instance_ids():
                break
            await asyncio.sleep(0.05)
        assert not agg_client.instance_ids(), "the drained aggregated worker is still registered"
        await agg_client.close()

        t0 = time.perf_counter()
        spawn("prefill", "--role", "prefill", "--kv-data-plane-host", "127.0.0.1")
        spawn("decode", "--role", "decode", "--disagg-threshold", str(DISAGG_THRESHOLD))
        # ready: the decode card is up and the decode worker has heard the
        # prefill worker's metrics (so it sees the prefill pool)
        await registered(t0)
        while "prefill queue watcher active" not in Path(logs["decode"].name).read_text():
            check_alive()
            if time.perf_counter() - t0 > 600:
                raise RuntimeError(f"the decode worker never saw the prefill pool: {tail('decode')}")
            await asyncio.sleep(0.2)
        t_ready = time.perf_counter() - t0
        clients = {role: await drt.namespace("dynamo").component(comp).endpoint("generate").client()
                   for role, comp in (("prefill", "prefill"), ("decode", "backend"))}
        for c in clients.values():
            await c.wait_for_instances(30)
        routers = {role: PushRouter(c) for role, c in clients.items()}

        async def stream(r):
            return await routers["decode"].generate(remote(r))

        async def clear():
            for r in routers.values():
                await clear_on(r)

        await clear()
        before = {role: await latest_stats(sub) for role, sub in subs.items()}
        recs, wall = await drive(stream, reqs, (1, 6))
        streams = await alone(stream, clear, reqs)
        after = {role: await latest_stats(sub) for role, sub in subs.items()}

        # one serial pull across processes: the prefill worker stages the
        # longest prompt (no streaming) and this process pulls it over TCP
        # into host memory, for the socket's own rate
        await clear()
        p_b = await latest_stats(subs["prefill"])
        pre_req = dict(reqs[PROBE_REQ], stop_conditions={"max_tokens": 1},
                       disagg_params={"return_kv": True, "kv_pull": True})
        kvp = None
        async for item in await routers["prefill"].generate(pre_req):
            kvp = (item.get("data") or {}).get("kv_transfer_params") or kvp
        desc = kv_transfer.KvTransferDescriptor.from_dict(kvp["pull"])
        got = 0

        async def sink(off, n, k, v):
            nonlocal got
            got += k.nbytes + v.nbytes

        t1 = time.perf_counter()
        await kv_transfer.pull_kv(desc, sink)
        pull_s = time.perf_counter() - t1
        p_a = await latest_stats(subs["prefill"])
        _, s_ex = dev_delta(p_a, p_b, "kv_extract")
        cross = {"pages": desc.n_pages, "bytes": got,
                 "extract_ms_per_page": round(1e3 * s_ex / desc.n_pages, 4),
                 "pull_wall_ms_per_page": round(1e3 * pull_s / desc.n_pages, 4),
                 "gb_per_s": round(got / pull_s / 1e9, 3)}
        assert got == stat_delta(p_a, p_b, "kv_bytes_served") > 0, (got, p_a.get("kv_bytes_served"))

        # a morph over the wire: the prefill worker turns into a decode
        # worker (its lanes move to the decode component), serves a stream
        # as one, and turns back; then the pair serves one more
        # disaggregated request
        pre_id = clients["prefill"].instance_ids()[0]
        morph_clients = {comp: await drt.namespace("dynamo").component(comp).endpoint(
            "morph").client() for comp in ("prefill", "backend")}

        async def morph(comp, role):
            c = morph_clients[comp]
            for _ in range(600):
                if pre_id in c.ready_instance_ids():
                    break
                await asyncio.sleep(0.05)
            router = PushRouter(c, RouterMode.DIRECT, direct_instance=pre_id)
            reply = [r async for r in await router.generate({"target_role": role})]
            assert reply and reply[0].get("ok"), f"disagg_subprocess: morph to {role}: {reply}"
            return reply[0]

        async def lanes_moved(on: str, off: str):
            for _ in range(600):
                if pre_id in clients[on].ready_instance_ids() and \
                        pre_id not in clients[off].instance_ids():
                    return
                await asyncio.sleep(0.05)
            raise RuntimeError(f"disagg_subprocess: the morphed lanes never moved to {on}")

        to_decode = await morph("prefill", "decode")
        await lanes_moved("decode", "prefill")
        as_decode = PushRouter(clients["decode"], RouterMode.DIRECT, direct_instance=pre_id)
        await clear_on(as_decode)
        morphed = new_record()
        await run_stream(as_decode.generate, remote(reqs[0]), morphed)
        to_prefill = await morph("backend", "prefill")
        await lanes_moved("prefill", "decode")
        await asyncio.sleep(1.0)  # the decode worker hears the prefill pool again
        await clear()
        back = new_record()
        await run_stream(stream, reqs[1], back)
        for c in morph_clients.values():
            await c.close()
        for c in clients.values():
            await c.close()
        for proc in procs.values():
            proc.send_signal(signal.SIGTERM)
        for role in list(procs):
            await reap(role)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
            os.unlink(f.name)
        await drt.close()
        await server.stop()

    for i, (rec, agg_rec) in enumerate(zip(recs, agg_recs)):
        assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, i
        assert agg_rec["finish"] == "length" and len(agg_rec["tokens"]) == MAX_TOKENS, i
        assert rec["remote"] is True, f"disagg_subprocess: request {i} was not prefilled remotely"
    for i, (a, b, c) in enumerate(zip(reference["alone"], streams, agg_streams)):
        assert a == b, f"disagg_subprocess: request {i} streams other tokens than aggregated"
        assert a == c, f"disagg_subprocess: request {i} streams other tokens from one worker"
    pre_calls = calls_delta(after["prefill"], before["prefill"])
    dec_calls = calls_delta(after["decode"], before["decode"])
    assert pre_calls.get("kernels:prefill_attention/none", 0) > 0 and set(pre_calls) == {
        "kernels:prefill_attention/none"}, f"prefill worker: {pre_calls}"
    assert dec_calls.get("kernels:paged_decode/none", 0) > 0 and set(dec_calls) == {
        "kernels:paged_decode/none"}, f"decode worker: {dec_calls}"
    d, p = after["decode"], before["decode"]
    n = 2 * len(reqs)
    assert stat_delta(d, p, "kv_pulls_completed") == n and stat_delta(d, p, "kv_pull_fallbacks") == 0
    assert morphed["remote"] is False and morphed["tokens"] == reference["alone"][0], \
        "disagg_subprocess: the morphed worker's stream differs from the reference"
    assert back["remote"] is True and back["tokens"] == reference["alone"][1], \
        "disagg_subprocess: the pair's stream after the morph back differs"
    emit(
        "disagg_subprocess", model="llama-3.2-3b", layers=WORKER_LAYERS, dtype="bfloat16",
        decode_pool_mode="scatter", kv_quant="none", num_pages_each=DISAGG_PAGES,
        requests=len(reqs), seconds_to_ready=round(t_ready, 2),
        aggregated_in_process=reference["metrics"],
        aggregated_one_worker=stream_metrics(agg_recs, agg_wall),
        disaggregated=stream_metrics(recs, wall),
        streams_equal=len(streams), remote_prefills=sum(r["remote"] is True for r in recs),
        kv_pulls_completed=stat_delta(d, p, "kv_pulls_completed"),
        streamed_handoffs=stat_delta(d, p, "disagg_streamed_handoffs"),
        first_token_before_last_chunk=stat_delta(d, p, "disagg_first_token_before_last_chunk"),
        fallbacks=stat_delta(d, p, "kv_pull_fallbacks"),
        handoff_in_run=handoff_costs(after["prefill"], before["prefill"], d, p, serial=False),
        serial_probe_cross_process={"prompt_tokens": len(reqs[PROBE_REQ]["token_ids"]), **cross},
        launches={"prefill_worker": pre_calls, "decode_worker": dec_calls},
        morph={"to_decode_s": round(to_decode["duration_s"], 3),
               "to_prefill_s": round(to_prefill["duration_s"], 3),
               "drained": [to_decode["drained"], to_prefill["drained"]],
               "stream_as_decode_equal": True, "disagg_after_morph_back_equal": True},
        exit_codes=rcs,
    )


async def disagg_all(seed: int, params, reference: dict) -> dict:
    """(scatter, bf16) at WORKER_LAYERS against the worker phase's in-process
    streams, then (local, int8) at 4 layers against its own aggregated run."""
    launches = await disagg_in_process(seed, "disagg", "scatter", "none", WORKER_LAYERS, params,
                                       reference)
    ref8 = await aggregated_reference(seed, "local", "int8", 4, params, reference["reqs"])
    for key, n in (await disagg_in_process(seed, "disagg_local_int8", "local", "int8", 4,
                                           params, ref8)).items():
        launches[key] = launches.get(key, 0) + n
    return launches


# ---------------------------------------------------------------------- #
# phases: weights_int8, weights_load, weights_gguf (int8 weight-only
# quantization and checkpoint loading)
# ---------------------------------------------------------------------- #

# (decode_pool_mode, kv_quant, layers) of the weights_int8 serve runs
# (both at 4 layers, to pay for the spec_guided and the MoE phases)
WEIGHTS_PATHS = [("scatter", "none", 4), ("local", "int8", 4)]
# int8 projections against the same products over the dequantized weights,
# per row |a - b|_2 / |b|_2. One bf16 product: the int8 path scales the f32
# accumulator and rounds once, the dequantized path rounds q * s to bf16
# first; both round the output (2^-9 relative each).
TOL_INT8_QDOT_REL = 1e-2
# The 28-layer prefill logits in f32 (the int8 forward of an f32 model
# against the same forward over dequantize_leaf(..., float32) weights):
# only the f32 rounding order of (x @ q) * s against x @ (q * s) differs.
TOL_INT8_F32_LOGITS_REL = 1e-3
GGUF_LAYERS = 2  # full width, a cut depth: the .gguf phase
GGUF_REQUESTS = 2
LOAD_SHARD_BYTES = 5 * 10**9  # Llama-3.2-3B's published BF16 files: two shards
# the checkpoint phases' depth: full width, the model's first 4 layers (the
# checkpoint's config.json says so, and the CLI worker reads it)
LOAD_LAYERS = WORKER_LAYERS
PROFILE_LAYERS = 4  # weights_int8_decode_step: full width, a cut depth


def cut_depth(params: dict, layers: int) -> dict:
    """The first `layers` layers of a tree (views)."""
    def cut(v):
        return {k: x[:layers] for k, x in v.items()} if is_quant(v) else v[:layers]

    return dict(params, layers={k: cut(v) for k, v in params["layers"].items()})


def tree_leaves(params: dict):
    """(name, tensor) of every leaf, a quantized leaf's ints and scales apart."""
    items = [("embed", params["embed"]), ("final_norm", params["final_norm"]),
             ("lm_head", params.get("lm_head")), *params["layers"].items()]
    for name, leaf in items:
        if leaf is None:
            continue
        if is_quant(leaf):
            yield f"{name}.q", leaf["q"]
            yield f"{name}.s", leaf["s"]
        else:
            yield name, leaf


def dequantized(qparams: dict, dtype) -> dict:
    """A tree with every quantized leaf replaced by q * s in `dtype`."""
    return {"embed": dequantize_leaf(qparams["embed"], dtype),
            "final_norm": qparams["final_norm"].to(dtype), "lm_head": None,
            "layers": {k: dequantize_leaf(v, dtype) if is_quant(v) else v.to(dtype)
                       for k, v in qparams["layers"].items()}}


def prefill_logits(params: dict, cfg, seed: int) -> torch.Tensor:
    """Last-token logits of a 2 x 256-token prefill (the kernels' path)."""
    B, T, ps = 2, 256, 64
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 21)
    toks = torch.randint(3, 259, (B, T), generator=gen, device=DEV, dtype=torch.int32)
    pos = torch.arange(T, device=DEV, dtype=torch.int32)[None].expand(B, T).contiguous()
    per = T // ps
    tables = (1 + torch.arange(B * per, device=DEV, dtype=torch.int32)).reshape(B, per)
    kv = [torch.zeros((cfg.num_layers, B * per + 1, ps, cfg.num_kv_heads, cfg.head_dim),
                      dtype=cfg.dtype, device=DEV) for _ in range(2)]
    logits, _, _ = llama.prefill_forward_batched(
        params, cfg, toks, pos, *kv, tables, torch.zeros(B, dtype=torch.int32, device=DEV),
        torch.full((B,), T - 1, dtype=torch.int32, device=DEV))
    return logits


def int8_forward_check(params: dict, qparams: dict, seed: int) -> dict:
    """The int8 products and forward against the same over the weights
    dequantize_leaf gives: each projection of layer 0 and the tied head in
    bf16, and the 28-layer prefill logits in f32 (gated); the bf16 logits
    against the dequantized and the original bf16 weights (printed)."""
    cfg = llama.LlamaConfig.llama3_2_3b()
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 13)
    qdot_err = {}
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "head"):
        leaf = head_leaf(qparams) if name == "head" else {
            k: v[0] for k, v in qparams["layers"][name].items()}
        x = torch.randn((256, leaf["q"].shape[0]), generator=gen, device=DEV).to(torch.bfloat16)
        got = qdot(x, leaf, out_dtype=torch.float32 if name == "head" else None)
        ref = x.float() @ dequantize_leaf(leaf, torch.float32)
        qdot_err[name] = round(row_rel_err(got, ref), 6)
    assert max(qdot_err.values()) <= TOL_INT8_QDOT_REL, f"int8 qdot off the dequantized product: {qdot_err}"

    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    q32 = dict(qparams, final_norm=qparams["final_norm"].float(),
               layers={k: v if is_quant(v) else v.float() for k, v in qparams["layers"].items()})
    a = prefill_logits(q32, cfg32, seed)
    deq = dequantized(qparams, torch.float32)
    b = prefill_logits(deq, cfg32, seed)
    del deq
    f32_err = row_rel_err(a, b)
    assert torch.isfinite(a).all() and f32_err <= TOL_INT8_F32_LOGITS_REL, \
        f"int8 f32 logits off the dequantized forward: {f32_err}"
    qb = prefill_logits(qparams, cfg, seed)
    deq = dequantized(qparams, torch.bfloat16)
    db = prefill_logits(deq, cfg, seed)
    del deq
    fb = prefill_logits(params, cfg, seed)
    torch.cuda.empty_cache()
    return {
        "qdot_row_rel_err_bf16": qdot_err, "tol_qdot": TOL_INT8_QDOT_REL,
        "logits_f32_row_rel_err": round(f32_err, 8), "tol_logits_f32": TOL_INT8_F32_LOGITS_REL,
        "logits_bf16_vs_dequantized_row_rel_err": round(row_rel_err(qb, db), 5),
        "logits_bf16_vs_bf16_weights_row_rel_err": round(row_rel_err(qb, fb), 5),
        "argmax_equal_vs_bf16_weights": int((qb.argmax(-1) == fb.argmax(-1)).sum()),
        "argmax_rows": int(qb.shape[0]),
    }


async def serve_mix(seed: int, phase: str, params: dict, cfg, mode: str, kvq: str,
                    quantize, reqs: list, after: tuple = (1, 6)) -> dict:
    """The mix staggered on one in-process engine (request after[1] waits
    for request after[0]'s first token): stream metrics, device time per
    dispatch kind, the first tokens, the path's launches."""
    engine = TorchEngine(
        EngineConfig(model="llama3-3b", seed=seed, decode_pool_mode=mode, kv_quant=kvq,
                     quantize=quantize),
        model_config=cfg, params=params, device="cuda",
    )
    await engine.warmup()

    async def local_stream(r):
        return engine.generate(r, Context())

    # counts to zero just before the main path is driven
    reset_counts()
    base = engine.stats()
    recs, wall = await drive(local_stream, reqs, after)
    launches, plain, stats = kernel_launches(), dict(pa.plain_calls), engine.stats()
    await engine.close()
    del engine
    for i, rec in enumerate(recs):
        assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, (phase, i)
        assert all(0 <= t < cfg.vocab_size for t in rec["tokens"]), (phase, i)
    check_path_launches(phase, launches, plain, mode, kvq)
    return {"metrics": stream_metrics(recs, wall), "weight_bytes": stats["weight_bytes"],
            "dev_time": dev_time_delta(stats, base), "first_tokens": [r["tokens"][0] for r in recs],
            "launches": launches}


def add_launches(total: dict, launches: dict) -> None:
    for key, n in launches.items():
        total[key] = total.get(key, 0) + n


async def weights_int8(seed: int, params: dict) -> dict:
    """quantize_tree(consume=True) of the smoke's weights on the card, the
    int8 forward against the dequantized one, then the worker phase's mix
    on int8 and on bf16 weights in (scatter, bf16 KV) and (local, int8 KV),
    and one decode step's profile on each."""
    cfg = llama.LlamaConfig.llama3_2_3b()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # a shallow copy is consumed: the smoke's bf16 tree stays for later phases
    qparams = quantize_tree(dict(params, layers=dict(params["layers"])), consume=True)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    check = int8_forward_check(params, qparams, seed)
    reqs, _ = make_requests(seed, cfg.vocab_size, WORKER_LENGTHS, shared_idx=(1, 6),
                            seeded_idx=(3,), tag="weights")
    greedy = [i for i in range(len(reqs)) if i != 3]
    total: dict = {}
    for mode, kvq, layers in WEIGHTS_PATHS:
        runs = {}
        lcfg = dataclasses.replace(cfg, num_layers=layers)
        for label, p, qz in (("bf16", params, None), ("int8", qparams, "int8")):
            runs[label] = await serve_mix(seed, f"weights_int8/{label}", cut_depth(p, layers),
                                          lcfg, mode, kvq, qz, reqs)
            add_launches(total, runs[label].pop("launches"))
        first = {label: r.pop("first_tokens") for label, r in runs.items()}
        emit(
            "weights_int8" if (mode, kvq) == ("scatter", "none") else f"weights_int8_{mode}_{kvq}",
            model="llama-3.2-3b", layers=layers, decode_pool_mode=mode, kv_quant=kvq,
            requests=len(reqs), max_tokens=MAX_TOKENS, quantize_s=round(quantize_s, 3),
            **({"forward_check": check} if (mode, kvq, layers) == WEIGHTS_PATHS[0] else {}),
            int8=runs["int8"], bf16=runs["bf16"],
            weight_bytes_ratio=round(runs["int8"]["weight_bytes"] / runs["bf16"]["weight_bytes"], 4),
            greedy_first_token_agreement=f"{sum(first['bf16'][i] == first['int8'][i] for i in greedy)}"
                                         f" of {len(greedy)}",
        )
    pcfg = dataclasses.replace(cfg, num_layers=PROFILE_LAYERS)
    prof = {label: decode_profile.profile(cut_depth(p, PROFILE_LAYERS), pcfg)
            for label, p in (("bf16", params), ("int8", qparams))}
    emit("weights_int8_decode_step", model="llama-3.2-3b", layers=PROFILE_LAYERS, lanes=64, ctx=512,
         **{label: {k: v for k, v in pr.items() if k not in ("card", "layers", "lanes", "ctx")}
            for label, pr in prof.items()})
    del qparams
    torch.cuda.empty_cache()
    return total


def rss_gib():
    """This process's resident set in GiB (VmRSS of /proc/self/status)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        return None
    return None


class RssPeak:
    """The largest resident set sampled every 5 ms while the block runs."""

    def __enter__(self):
        import threading

        self.peak = rss_gib() or 0.0
        self._stop = threading.Event()

        def sample():
            while not self._stop.wait(0.005):
                self.peak = max(self.peak, rss_gib() or 0.0)

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


async def weights_load(seed: int, params: dict) -> dict:
    """The smoke's bf16 weights written as a BF16 index-sharded safetensors
    checkpoint, loaded back with load_llama_params on the card (bit for bit
    equal, timed, host memory read), and each request of the mix alone on
    an int8 engine of the loaded weights: the streams the CLI worker must
    reproduce (weights_load_subprocess)."""
    import os
    import resource
    import shutil
    import tempfile

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=LOAD_LAYERS)
    params = cut_depth(params, LOAD_LAYERS)
    free = shutil.disk_usage(tempfile.gettempdir()).free
    d = tempfile.mkdtemp(prefix="smoke_ckpt_")
    t0 = time.perf_counter()
    files = loader.save_llama_as_hf(params, cfg, d, dtype=torch.bfloat16,
                                    max_shard_bytes=LOAD_SHARD_BYTES)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "llama", "num_hidden_layers": cfg.num_layers,
                   "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                   "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
                   "vocab_size": cfg.vocab_size, "tie_word_embeddings": cfg.tie_embeddings}, f)
    for fn in files:  # on disk, out of the page cache: a cold start's read
        fd = os.open(os.path.join(d, fn), os.O_RDONLY)
        os.fsync(fd)
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        os.close(fd)
    write_s = time.perf_counter() - t0
    on_disk = sum(os.path.getsize(os.path.join(d, fn)) for fn in files)
    gc.collect()
    rss_before = rss_gib()
    torch.cuda.synchronize()
    with RssPeak() as rss:
        t0 = time.perf_counter()
        loaded = loader.load_llama_params(d, cfg, device=DEV)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    ru_maxrss = round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 3)
    want = dict(tree_leaves(params))
    got = dict(tree_leaves(loaded))
    assert set(got) == set(want), (sorted(got), sorted(want))
    differ = [k for k in want if got[k].dtype != want[k].dtype or not torch.equal(got[k], want[k])]
    assert not differ, f"the reloaded checkpoint differs from the weights written: {differ}"

    qparams = quantize_tree(loaded, consume=True)
    del loaded
    reqs, _ = make_requests(seed, cfg.vocab_size, WORKER_LENGTHS, shared_idx=(1, 6),
                            seeded_idx=(3,), tag="weights_load")
    engine = TorchEngine(EngineConfig(model="llama3-3b", seed=seed, quantize="int8"),
                         model_config=cfg, params=qparams, device="cuda")
    del qparams
    await engine.warmup()

    async def local_stream(r):
        return engine.generate(r, Context())

    async def local_clear():
        engine.clear_kv_blocks()

    streams = await alone(local_stream, local_clear, reqs)
    weight_bytes = engine.stats()["weight_bytes"]
    await engine.close()
    del engine
    torch.cuda.empty_cache()
    weights = param_bytes(params)
    emit("weights_load", model="llama-3.2-3b", layers=LOAD_LAYERS, checkpoint_dtype="BF16",
         files=files, checkpoint_bytes=on_disk, disk_free_gb=round(free / 1e9, 1),
         write_s=round(write_s, 3), load_s=round(load_s, 3),
         load_gb_per_s=round(weights / load_s / 1e9, 3), bit_exact_tensors=len(want),
         host_rss_before_gib=round(rss_before, 3),
         host_rss_peak_during_load_gib=round(rss.peak, 3),
         host_ru_maxrss_gib=ru_maxrss, int8_weight_bytes=weight_bytes, bf16_weight_bytes=weights)
    return {"dir": d, "reqs": reqs, "streams": streams, "model": "llama3-3b", "shared": (1, 6),
            "phase": "weights_load_subprocess", "label": "llama-3.2-3b", "layers": LOAD_LAYERS}


async def weights_load_subprocess(seed: int, load: dict) -> dict:
    """`python -m dynamo_tpu_torch.worker --model <load["model"]> --model-path
    <the checkpoint> --quantize int8` (pool auto-sized after the int8
    weights are resident): it must register, stream each request of the mix
    alone as the in-process int8 engine did, and drain on SIGTERM. Returns
    the kernel launches of its traffic (from the stats it publishes). The
    `moe_worker` phase runs it on a Mixtral checkpoint. The caller removes
    the checkpoint (disagg_subprocess serves the Llama one too)."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    from dynamo_tpu_torch.llm.kv_router.publisher import METRICS_TOPIC_FMT
    from dynamo_tpu_torch.runtime import DiscoveryServer, DistributedRuntime, PushRouter, RuntimeConfig

    server = DiscoveryServer(port=0)
    _, port = await server.start()
    disc = f"tcp://127.0.0.1:{port}"
    cfg = RuntimeConfig.from_settings()
    cfg.discovery_endpoint = disc
    drt = await DistributedRuntime.create(cfg)
    root = Path(__file__).resolve().parent
    log = tempfile.NamedTemporaryFile(prefix="torch_worker_ckpt_", suffix=".log", delete=False)
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = None
    try:
        cards = await drt.discovery.watch_prefix("v1/mdc/dynamo/backend/generate/")
        met_sub = await drt.discovery.subscribe(
            METRICS_TOPIC_FMT.format(namespace="dynamo", component="backend"))
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "dynamo_tpu_torch.worker", "--model", load["model"],
             "--model-path", load["dir"], "--quantize", "int8", "--num-pages", "0",
             "--seed", str(seed), "--discovery", disc],
            cwd=root, env=env, stdout=log, stderr=subprocess.STDOUT,
        )
        while True:
            ev = await cards.get(timeout=1.0)
            if ev is not None and ev.type == "put":
                break
            if proc.poll() is not None or time.perf_counter() - t0 > 600:
                raise RuntimeError(f"the worker never registered (rc {proc.poll()}): "
                                   f"{Path(log.name).read_text()[-3000:]}")
        t_reg = time.perf_counter() - t0
        client = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(30)
        router = PushRouter(client)

        async def clear():
            items = [it async for it in await router.generate(
                {"token_ids": [1], "annotations": ["clear_kv_blocks"]})]
            assert items and items[0]["event"] == "clear_kv_blocks", items

        await clear()
        before = await latest_stats(met_sub)
        recs, wall = await drive(router.generate, load["reqs"], load["shared"])
        streams = await alone(router.generate, clear, load["reqs"])
        after = await latest_stats(met_sub)
        for i, (a, b) in enumerate(zip(load["streams"], streams)):
            assert a == b, f"request {i}: the CLI worker streams other tokens than the in-process engine"
        calls = calls_delta(after, before)
        launches = {tuple(k.split(":", 1)[1].split("/")): n for k, n in calls.items()
                    if k.startswith("kernels:")}
        plain = {k: n for k, n in calls.items() if k.startswith("plain:")}
        check_path_launches(load["phase"], launches, plain, "scatter", "none")
        loaded_line = next((ln for ln in Path(log.name).read_text().splitlines()
                            if "loaded " in ln), "")
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = await asyncio.get_running_loop().run_in_executor(None, proc.wait, 120)
        t_drain = time.perf_counter() - t1
        assert rc == 0, f"the worker exited {rc} on SIGTERM: {Path(log.name).read_text()[-3000:]}"
        for _ in range(100):
            if not client.instance_ids():
                break
            await asyncio.sleep(0.05)
        assert not client.instance_ids(), "the drained worker is still registered"
        await client.close()
        for i, rec in enumerate(recs):
            assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, i
        emit(load["phase"], model=load["label"], layers=load["layers"], quantize="int8",
             seconds_to_registration=round(t_reg, 2), worker_load_log=loaded_line[-160:],
             over_the_wire=stream_metrics(recs, wall),
             weight_bytes=after["weight_bytes"], num_pages=after["kv_total_blocks"],
             kv_pool_bytes=after["kv_pool_bytes"],
             kv_pool_gib=round(after["kv_pool_bytes"] / 2**30, 2),
             streams_equal=len(streams), launches={"/".join(k): n for k, n in launches.items()},
             seconds_to_exit_after_sigterm=round(t_drain, 2), exit_code=rc)
        return launches
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
        os.unlink(log.name)
        await drt.close()
        await server.stop()


def gguf_vocab(n: int) -> list:
    """An embedded vocabulary of n tokens: specials, the llama.cpp space
    mark, letters and a few words, then placeholders."""
    words = ["<unk>", "<s>", "</s>", "▁"] + [chr(c) for c in range(33, 127)]
    words += ["▁" + w for w in WORDS]
    return words + [f"<t{i}>" for i in range(n - len(words))]


def q8_0_decode(g, name: str) -> np.ndarray:
    """numpy's own decode of one q8_0 tensor of a GGUF file: f16 scale times
    32 int8 values per block, read from the file's bytes."""
    from dynamo_tpu_torch.llm.gguf import GGML_Q8_0

    info = g.tensors[name]
    assert info.ggml_type == GGML_Q8_0, (name, info.ggml_type)
    n = int(np.prod(info.shape))
    raw = np.fromfile(g.path, dtype=np.uint8, count=n // 32 * 34, offset=g.data_start + info.offset)
    blocks = raw.reshape(-1, 34)
    d = blocks[:, :2].copy().view("<f2").astype(np.float32)
    qs = blocks[:, 2:].copy().view(np.int8).astype(np.float32)
    return (d * qs).reshape(info.shape)


async def weights_gguf(seed: int, params: dict) -> dict:
    """The smoke's weights at full width and GGUF_LAYERS layers written as a
    q8_0 .gguf with an embedded vocabulary, loaded with and without
    quantize="int8" on the card, checked against numpy's decode of the
    file, and two requests served from each."""
    import os
    import shutil
    import tempfile

    from dynamo_tpu_torch.llm.gguf import mdc_from_gguf, read_gguf
    from dynamo_tpu_torch.llm.tokenizers import load_tokenizer

    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=GGUF_LAYERS)
    d = tempfile.mkdtemp(prefix="smoke_gguf_")
    path = os.path.join(d, "llama-3.2-3b-q8_0.gguf")
    try:
        t0 = time.perf_counter()
        loader.save_llama_as_gguf(cut_depth(params, GGUF_LAYERS), cfg, path,
                                  tokens=gguf_vocab(cfg.vocab_size), name="llama-3.2-3b")
        write_s = time.perf_counter() - t0
        got_cfg = loader.config_from_gguf(path)
        assert got_cfg == cfg, (got_cfg, cfg)
        card = mdc_from_gguf(path)
        tok = load_tokenizer(f"gguf:{path}")
        assert tok.vocab_size == cfg.vocab_size and card.tokenizer == f"gguf:{path}"
        g = read_gguf(path, with_tensors=True)
        loads, load_s = {}, {}
        for qz in (None, "int8"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loads[qz] = loader.load_llama_params(path, got_cfg, quantize=qz, device=DEV)
            torch.cuda.synchronize()
            load_s[qz or "bf16"] = round(time.perf_counter() - t0, 3)
        checked = 0
        names = [("token_embd.weight", "embed", False, -1)]
        names += [(f"blk.{li}.{sfx}", key, tr, -2) for li in range(GGUF_LAYERS)
                  for sfx, (key, tr) in loader._GGUF_LAYER_MAP.items() if tr]
        for gname, key, transpose, axis in names:
            x = q8_0_decode(g, gname)
            x = np.ascontiguousarray(x.T) if transpose else x
            li = int(gname.split(".")[1]) if gname.startswith("blk.") else None
            bf = loads[None]["embed"] if li is None else loads[None]["layers"][key][li]
            assert torch.equal(bf, torch.from_numpy(x).to(DEV, torch.bfloat16)), gname
            ql = loads["int8"]["embed"] if li is None else {
                k: v[li] for k, v in loads["int8"]["layers"][key].items()}
            # per-channel int8 of numpy's decode (quantize_array's bits
            # against the reference's: tests/test_torch_quant.py)
            want = quantize_array(torch.from_numpy(x).to(DEV), contract_axis=axis)
            assert torch.equal(ql["q"], want["q"]) and torch.equal(ql["s"], want["s"]), gname
            checked += 1
        reqs, _ = make_requests(seed, cfg.vocab_size, WORKER_LENGTHS[:GGUF_REQUESTS],
                                shared_idx=(), seeded_idx=(), tag="gguf")
        total, served = {}, {}
        for qz in (None, "int8"):
            # the second request arrives once the first decodes: a mixed step
            run = await serve_mix(seed, f"weights_gguf/{qz or 'bf16'}", loads.pop(qz), cfg,
                                  "scatter", "none", qz, reqs, after=(0, 1))
            add_launches(total, run.pop("launches"))
            run.pop("first_tokens")
            served[qz or "bf16"] = run
        emit("weights_gguf", model="llama-3.2-3b", layers=GGUF_LAYERS, tensor_type="q8_0",
             file_bytes=os.path.getsize(path), vocab=len(g.tokens), write_s=round(write_s, 3),
             load_s=load_s, tensors_checked_against_numpy_decode=checked,
             tokenizer=card.tokenizer.split(":")[0], served=served)
        return total
    finally:
        shutil.rmtree(d, ignore_errors=True)
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------- #


# ---------------------------------------------------------------------- #
# phases: kvbm (KVBM tiers in process) and kvbm_peer (two CLI workers)
# ---------------------------------------------------------------------- #

KVBM_PAGES = 200  # device pool: wave B (8 x 25 pages) pushes wave A out of it
KVBM_HOST_BLOCKS = 256  # G2: B's 192 blocks and A's newest 64
KVBM_DISK_BLOCKS = 512  # G3: the rest of A, then what falls off the host
KVBM_SESSIONS = 8
KVBM_PROMPT, KVBM_B_PROMPT, KVBM_TURN, KVBM_OUT = 2048, 1536, 256, 32
KVBM_SLA_TTFT_MS = 50.0  # the sla run's TTFT target: host spans fit, disk spans do not
# (phase, decode_pool_mode, kv_quant, with the sla run and the warm restart,
# layers): the int8 path at a cut depth pays for the durable phases' time
# `kvbm` at 4 layers (a block is then 1.05 MB, not 7.34), to pay
# for the spec_guided and the MoE phases' time
KVBM_PHASES = [("kvbm", "scatter", "none", True, 4),
               ("kvbm_local_int8", "local", "int8", False, 4)]
PEER_PAGES, PEER_TAIL = 1024, 40  # peer prompts: 32 pages + a 40-token tail
# each peer's host tier holds its own wave (264 blocks) and the other's
# checkpoints of it
PEER_HOST_BLOCKS = 544


def kvbm_waves(seed: int, vocab: int) -> dict:
    """Wave A: 8 sessions of 2,048 tokens, each request alone; wave B: 8
    other prompts of 1,536 tokens, staggered; wave A2: each A session
    extended by a 256-token turn, alone, newest session first. Alone, a
    request's prefill chunks have the shapes a recompute has, so an
    onboarded stream must equal the recomputed one bit for bit."""
    _, text = make_requests(seed, vocab, [], (), (), "kvbm")

    def req(ids, tag):
        return PreprocessedRequest(token_ids=ids, request_id=tag,
                                   stop_conditions={"max_tokens": KVBM_OUT}).to_dict()

    a = [text(KVBM_PROMPT, 1000 + i) for i in range(KVBM_SESSIONS)]
    b = [text(KVBM_B_PROMPT, 2000 + i) for i in range(KVBM_SESSIONS)]
    turns = [text(KVBM_TURN, 3000 + i) for i in range(KVBM_SESSIONS)]
    return {"A": [req(p, f"kvbm-a{i}") for i, p in enumerate(a)],
            "B": [req(p, f"kvbm-b{i}") for i, p in enumerate(b)],
            "A2": [req(a[i] + turns[i], f"kvbm-a2-{i}") for i in reversed(range(KVBM_SESSIONS))]}


def kvbm_config(seed: int, mode: str, kvq: str, disk_path=None, sla=False) -> EngineConfig:
    tiers = {} if disk_path is None else dict(
        kvbm_host_blocks=KVBM_HOST_BLOCKS, kvbm_disk_blocks=KVBM_DISK_BLOCKS,
        kvbm_disk_path=disk_path)
    policy = dict(sched_policy="sla", ttft_target_ms=KVBM_SLA_TTFT_MS) if sla else {}
    return EngineConfig(model="llama3-3b", seed=seed, decode_pool_mode=mode, kv_quant=kvq,
                        num_pages=KVBM_PAGES, **tiers, **policy)


async def settle(engine) -> None:
    """The offload pipeline drained: every committed block is in a tier."""
    if engine.kvbm is None:
        return
    fut = engine.kvbm.flush_step()
    if fut is not None:
        await asyncio.wrap_future(fut)
    for _ in range(3000):
        if engine.kvbm.pending_offloads() == 0:
            return
        await asyncio.sleep(0.01)
    raise RuntimeError("kvbm: the offload pipeline never drained")


async def alone_records(engine, reqs) -> list:
    out = []
    for req in reqs:
        rec = new_record()
        await run_request(engine, req, rec)
        assert rec["finish"] == "length" and len(rec["tokens"]) == KVBM_OUT, (req["request_id"], rec)
        out.append(rec)
    return out


def stat_diff(after: dict, before: dict, keys) -> dict:
    return {k: after.get(k, 0) - before.get(k, 0) for k in keys}


def tier_bytes_equal(engine, hashes_of) -> dict:
    """The tier copy of blocks still in the device pool against a device
    extract of their pages: bit for bit."""
    alloc = engine.allocator
    checked = 0
    for hashes in hashes_of:
        pages = alloc.cached_prefix(hashes)
        if not pages:
            continue
        hs, ids = hashes[:len(pages)], np.array([p + 1 for p in pages], np.int32)
        present, tk, tv = engine.kvbm.manager.read_blocks(hs)
        assert present == list(hs), "kvbm: a committed block is missing from the tiers"
        dk, dv = engine._dev_extract(ids)
        for t, d in ((tk, dk), (tv, dv)):
            a = t.transpose(0, 1).contiguous().view(torch.uint8)
            b = d.contiguous().view(torch.uint8)
            assert torch.equal(a, b), "kvbm: tier bytes differ from the device pages"
        checked += len(hs)
    assert checked > 0, "kvbm: no block of wave A was left in the device pool to check"
    return {"blocks": checked, "bit_equal": True}


async def kvbm_run(seed: int, params, mode: str, kvq: str, waves: dict, disk_path=None,
                   sla: bool = False, restart: bool = False, layers: int = LAYERS) -> dict:
    """Waves A (alone), B (staggered) and A2 (alone) on one engine of a
    200-page pool; KVBM on when `disk_path` is given. `restart`: only wave
    A2, on a fresh engine that opens `disk_path` warm."""
    from dynamo_tpu_torch.llm.tokens import TokenBlockSequence

    rss0 = rss_gib()
    engine = TorchEngine(kvbm_config(seed, mode, kvq, disk_path, sla),
                         model_config=dataclasses.replace(llama.LlamaConfig.llama3_2_3b(),
                                                          num_layers=layers),
                         params=cut_depth(params, layers), device="cuda")
    out = {"pinned_alloc_s": None if engine.kvbm is None
           else round(engine.kvbm.manager.host_alloc_s, 3)}
    await engine.warmup()
    decisions = []
    if sla:
        mgr, real = engine.kvbm.manager, engine.kvbm.budget_onboard

        def spy(hashes, headroom_ms, recompute_ms, hint_instance=None):
            kept, decision = real(hashes, headroom_ms, recompute_ms, hint_instance=hint_instance)
            tiers = ["host" if mgr.host.has(h) else "disk" for h in hashes]
            decisions.append({"host_blocks": tiers.count("host"),
                              "disk_blocks": tiers.count("disk"), "decision": decision,
                              "kept": len(kept), "headroom_ms": round(headroom_ms or 0.0, 2),
                              "recompute_ms_per_block": None if recompute_ms is None
                              else round(recompute_ms, 3)})
            return kept, decision

    if not restart:
        await alone_records(engine, waves["A"])
        await settle(engine)
        if engine.kvbm is not None:
            out["tier_bytes"] = await engine._run_on_device(partial(
                tier_bytes_equal, engine,
                [TokenBlockSequence(r["token_ids"], 64, salt=0).block_hashes()
                 for r in waves["A"]]))
        base = engine.stats()
        recs, wall = await drive(lambda r: _open(engine, r), waves["B"], (0, -1))
        await settle(engine)
        after = engine.stats()
        out["wave_b"] = stream_metrics(recs, wall)
        out["wave_b_dev_time"] = dev_time_delta(after, base)
        assert all(r["finish"] == "length" for r in recs), "kvbm: a wave B request did not finish"
    if sla:
        engine.kvbm.budget_onboard = spy
    reset_counts()
    base = engine.stats()
    recs = await alone_records(engine, waves["A2"])
    await settle(engine)
    launches, plain = kernel_launches(), dict(pa.plain_calls)
    stats = engine.stats()
    await engine.close()
    out["rss_gib"] = {"before": round(rss0 or 0.0, 3), "after": round(rss_gib() or 0.0, 3)}
    ttft = [r["ttft_s"] for r in recs]
    out["wave_a2"] = {"ttft_ms": {"p50": round(1e3 * pct(ttft, 50), 2),
                                  "p99": round(1e3 * pct(ttft, 99), 2),
                                  "each": [round(1e3 * t, 2) for t in ttft]}}
    out["tokens"] = [r["tokens"] for r in recs]
    out["launches"], out["plain"] = launches, plain
    if engine.kvbm is not None:
        keys = ("kvbm_host_hits", "kvbm_disk_hits", "kvbm_onboarded_blocks",
                "kvbm_onboard_count", "kvbm_onboard_ms_sum", "kvbm_offloaded_blocks",
                "kvbm_g1_hit_blocks", "kvbm_onboard_src_local_blocks",
                "kvbm_onboard_src_recompute_blocks", "kvbm_onboard_recompute_fallbacks",
                "kv_onboard_fallbacks")
        out["wave_a2"]["kvbm"] = stat_diff(stats, base, keys)
        out["wave_a2"]["onboard_hist"] = {
            k: v - base["kvbm_onboard_hist"][k] for k, v in stats["kvbm_onboard_hist"].items()}
        out["wave_a2"]["dev_time"] = dev_time_delta(stats, base)
        out["load_ms_per_block"] = {t: stats.get(f"kvbm_{t}_load_ms_per_block")
                                    for t in ("host", "disk")}
        out["offload"] = {k: stats[k] for k in (
            "kvbm_offload_gathers", "kvbm_offload_commit_calls", "kvbm_offloaded_blocks",
            "kvbm_offload_batches_dropped", "kvbm_offload_blocks_dropped",
            "kvbm_offload_failures", "kvbm_dropped_blocks")}
        off = stats["dev_time"].get("kvbm_offload", {"count": 0, "seconds": 0.0})
        out["offload"]["gather_device_ms"] = {
            "count": off["count"], "total": round(1e3 * off["seconds"], 3),
            "per_gather": round(1e3 * off["seconds"] / max(off["count"], 1), 4)}
    if sla:
        out["sla_decisions"] = decisions
    del engine
    torch.cuda.empty_cache()
    return out


async def _open(engine, req):
    return engine.generate(req, Context())


def check_onboard_launches(phase: str, launches: dict, plain: dict, mode: str, kvq: str) -> None:
    """Wave A2 (each request alone: prefill then decode, no mixed step):
    the prefill kernel over the onboarded pages and the path's decode
    kernel launched, no other kernel, no plain attention call."""
    decode_kernel = "paged_decode_local" if mode == "local" else "paged_decode"
    used = [(decode_kernel, kvq), ("prefill_attention", kvq)]
    assert all(launches.get(u, 0) > 0 for u in used), f"{phase}: {launches}"
    assert sum(launches.values()) == sum(launches[u] for u in used), f"{phase}: {launches}"
    assert not any(plain.values()), f"{phase}: plain attention ran: {plain}"


async def kvbm_phase(seed: int, params, phase: str, mode: str, kvq: str, extras: bool,
                     layers: int) -> dict:
    """KVBM off (recompute), then on (host 256 + disk 512 blocks), on the
    same waves; with `extras` an sla run of wave A2 and a warm restart."""
    import shutil
    import tempfile

    waves = kvbm_waves(seed, llama.LlamaConfig.llama3_2_3b().vocab_size)
    tmp = tempfile.mkdtemp(prefix="kvbm_")
    free_gb = shutil.disk_usage(tmp).free / 1e9
    launches: dict = {}
    try:
        off = await kvbm_run(seed, params, mode, kvq, waves, layers=layers)
        on = await kvbm_run(seed, params, mode, kvq, waves, disk_path=f"{tmp}/g3", layers=layers)
        for run in (off, on):
            check_onboard_launches(phase, run["launches"], run["plain"], mode, kvq)
        add_launches(launches, on["launches"])
        for i, (a, b) in enumerate(zip(off["tokens"], on["tokens"])):
            assert a == b, f"{phase}: A2 request {i} onboarded streams other tokens than recompute"
        kv = on["wave_a2"]["kvbm"]
        assert kv["kvbm_host_hits"] > 0 and kv["kvbm_disk_hits"] > 0, f"{phase}: {kv}"
        assert kv["kvbm_onboarded_blocks"] > 0 and kv["kv_onboard_fallbacks"] == 0, f"{phase}: {kv}"
        result = {"off": off, "on": on}
        if extras:
            sla = await kvbm_run(seed, params, mode, kvq, waves, disk_path=f"{tmp}/sla", sla=True,
                                 layers=layers)
            add_launches(launches, sla["launches"])
            result["sla"] = {"decisions": sla["sla_decisions"], "wave_a2": sla["wave_a2"],
                             "streams_equal_recompute": sum(
                                 a == b for a, b in zip(off["tokens"], sla["tokens"]))}
            warm = await kvbm_run(seed, params, mode, kvq, waves, disk_path=f"{tmp}/g3",
                                  restart=True, layers=layers)
            add_launches(launches, warm["launches"])
            for i, (a, b) in enumerate(zip(off["tokens"], warm["tokens"])):
                assert a == b, f"{phase}: A2 request {i} after a warm restart differs"
            assert warm["wave_a2"]["kvbm"]["kvbm_disk_hits"] > 0, warm["wave_a2"]
            result["warm_restart"] = {"wave_a2": warm["wave_a2"],
                                      "pinned_alloc_s": warm["pinned_alloc_s"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for run in result.values():
        if isinstance(run, dict):
            run.pop("tokens", None)
            run.pop("launches", None)
    emit(phase, model="llama-3.2-3b", layers=layers, dtype="bfloat16", decode_pool_mode=mode,
         kv_quant=kvq, num_pages=KVBM_PAGES, host_blocks=KVBM_HOST_BLOCKS,
         disk_blocks=KVBM_DISK_BLOCKS, disk_free_gb=round(free_gb, 1),
         sessions=KVBM_SESSIONS, prompt_tokens={"A": KVBM_PROMPT, "B": KVBM_B_PROMPT,
                                                 "A2": KVBM_PROMPT + KVBM_TURN},
         max_tokens=KVBM_OUT, streams_equal_recompute=KVBM_SESSIONS,
         **result,
         launches={f"{n}/{f}": c for (n, f), c in launches.items() if c})
    return launches


async def kvbm_all(seed: int, params) -> dict:
    total: dict = {}
    for phase, mode, kvq, extras, layers in KVBM_PHASES:
        add_launches(total, await kvbm_phase(seed, params, phase, mode, kvq, extras, layers))
    return total


def free_port_pair() -> int:
    """A port P with P and P + 1 free (the second worker's offset)."""
    import socket

    for _ in range(50):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        try:
            with socket.socket() as s:
                s.bind(("0.0.0.0", port + 1))
            return port
        except OSError:
            continue
    raise RuntimeError("no free pair of ports")


def scrape(port: int, path: str):
    """(status, body) of one GET on a worker's system-status server."""
    import urllib.error
    import urllib.request

    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def gauge(metrics: str, name: str) -> float:
    """The value of `dynamo_worker_<name>` in a Prometheus text body."""
    import re

    m = re.search(rf"^dynamo_worker_{name}(?:{{[^}}]*}})? (\S+)$", metrics, re.M)
    assert m, f"no dynamo_worker_{name} in /metrics"
    return float(m.group(1))


async def kvbm_peer(seed: int, ckpt: str) -> None:
    """`python -m dynamo_tpu_torch.frontend --router-mode kv --embed-discovery`
    (its discovery serves the phase) and two `python -m
    dynamo_tpu_torch.worker` processes on the card serving the weights_load
    checkpoint (`--model-path`: LOAD_LAYERS), each with a host tier
    (PEER_HOST_BLOCKS), KV events, the status server, canaries and session checkpoints
    (DYN_KV_CHECKPOINT; mixed dispatch off, so every decode row runs the
    decode kernel). Wave A goes to worker 1 (addressed directly); once
    worker 1's checkpoints have landed, worker 2 drops its tiers and gets
    the same prompts, and must pull worker 1's blocks over the data plane
    (G4) and stream the same tokens. Both /metrics are scraped. Then the
    frontend over HTTP (`frontend_http`). Then durable sessions: four
    streams (two greedy, two seeded) are taken uninterrupted on worker 1,
    all at once, then run again through the port's Migration over a
    PushRouter that prefers worker 1, beside one HTTP stream the frontend
    pins to worker 1; once worker 1 has pushed their prompts to worker 2
    and each stream has DURABLE_CUT tokens out, worker 1 is SIGKILLed. The
    four streams must finish on worker 2 as they did uninterrupted, resumed
    from the checkpoint with under two pages recomputed each, and the HTTP
    stream must finish there through the frontend's migration. Worker 2 and
    the frontend drain on SIGTERM."""
    import os
    import re
    import signal
    import tempfile
    from pathlib import Path

    from dynamo_tpu_torch.llm.kv_router.publisher import METRICS_TOPIC_FMT
    from dynamo_tpu_torch.runtime import (DistributedRuntime, PushRouter, RouterMode,
                                          RuntimeConfig, codec)

    root = Path(__file__).resolve().parent
    http_port, disc_port, sys_port = free_port_pair(), free_port_pair(), free_port_pair()
    disc = f"tcp://127.0.0.1:{disc_port}"
    procs, logs, rcs = {}, {}, {}
    vocab = llama.LlamaConfig.llama3_2_3b().vocab_size
    _, text = make_requests(seed, vocab, [], (), (), "peer")
    reqs = [PreprocessedRequest(token_ids=text(KVBM_PROMPT + PEER_TAIL, 5000 + i),
                                request_id=f"peer-{i}",
                                stop_conditions={"max_tokens": KVBM_OUT}).to_dict()
            for i in range(KVBM_SESSIONS)]

    def start(name, args, extra_env=None):
        logs[name] = tempfile.NamedTemporaryFile(prefix=f"peer_{name}_", suffix=".log",
                                                 delete=False)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", *args], cwd=root,
            env=dict(os.environ, PYTHONPATH=str(root), **(extra_env or {})),
            stdout=logs[name], stderr=subprocess.STDOUT)

    def tail(name):
        return Path(logs[name].name).read_text()[-3000:]

    def alive():
        for name, proc in procs.items():
            if proc.poll() is not None:
                raise RuntimeError(f"kvbm_peer: {name} exited {proc.poll()}: {tail(name)}")

    drt = None
    t_fe = time.perf_counter()
    start("frontend", ["dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1",
                       "--http-port", str(http_port), "--embed-discovery", "--discovery", disc,
                       "--router-mode", "kv"])
    try:
        while True:  # the frontend's HTTP port and its embedded discovery
            alive()
            try:
                if (await http_call(http_port, "GET", "/live"))[0] == 200:
                    break
            except OSError:
                await asyncio.sleep(0.1)
        fe_live_s = time.perf_counter() - t_fe
        cfg = RuntimeConfig.from_settings()
        cfg.discovery_endpoint = disc
        drt = await DistributedRuntime.create(cfg)
        cards = await drt.discovery.watch_prefix("v1/mdc/dynamo/backend/generate/")
        met_sub = await drt.discovery.subscribe(
            METRICS_TOPIC_FMT.format(namespace="dynamo", component="backend"))
        t0 = time.perf_counter()
        for index in (0, 1):
            start(f"w{index + 1}",
                  ["dynamo_tpu_torch.worker", "--model", FE_MODEL, "--model-path", ckpt,
                   "--num-pages", str(PEER_PAGES), "--kvbm-host-blocks", str(PEER_HOST_BLOCKS),
                   "--kv-events", "--seed", str(seed), "--discovery", disc,
                   "--kv-data-plane-host", "127.0.0.1"],
                  {"DYN_SYSTEM_PORT": str(sys_port), "DYN_WORKER_INDEX": str(index),
                   "DYN_HEALTH_CHECK_ENABLED": "1", "DYN_HEALTH_CHECK_IDLE_TIMEOUT": "5",
                   "DYN_KV_CHECKPOINT": DURABLE_CKPT, "DYN_MIXED_DISPATCH": "0"})

        seen = 0
        while seen < 2:
            ev = await cards.get(timeout=1.0)
            seen += ev is not None and ev.type == "put"
            alive()
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("kvbm_peer: the workers never registered")
        t_ready = time.perf_counter() - t0
        ids = {}
        for name in ("w1", "w2"):
            for _ in range(200):  # the line follows the card's registration
                m = re.search(r"instance=([0-9a-f]+)", Path(logs[name].name).read_text())
                if m:
                    break
                await asyncio.sleep(0.05)
            ids[name] = int(m.group(1), 16)
        client = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
        for _ in range(200):
            if set(ids.values()) <= set(client.instance_ids()):
                break
            await asyncio.sleep(0.05)
        routers = {name: PushRouter(client, RouterMode.DIRECT, direct_instance=i)
                   for name, i in ids.items()}

        async def serve_wave(name):
            out = []
            for req in reqs:
                rec = new_record()
                await run_stream(routers[name].generate, req, rec)
                assert rec["finish"] == "length" and len(rec["tokens"]) == KVBM_OUT, (name, rec)
                out.append(rec)
            return out

        async def stats_of(name) -> dict:
            """The stats worker `name` publishes next (queued ones dropped)."""
            while await met_sub.get(timeout=0.01) is not None:
                pass
            while True:
                msg = codec.unpack(await met_sub.get(timeout=10))
                if msg["worker_id"] == ids[name]:
                    return msg["stats"]

        async def clear(name):
            items = [it async for it in await routers[name].generate(
                {"token_ids": [1], "annotations": ["clear_kv_blocks"]})]
            assert items and items[0]["event"] == "clear_kv_blocks", items

        async def checkpoints_landed(name):
            """The worker's offloads stored and its checkpoints pushed."""
            for _ in range(600):
                st = await stats_of(name)
                if (st["kvbm_pending_offloads"] == 0 and st["kvbm_ckpt_queue_depth"] == 0
                        and st["kvbm_ckpt_blocks_staged"] == st["kvbm_ckpt_blocks_pushed"]
                        + st["kvbm_ckpt_blocks_dropped"]):
                    return st
            raise RuntimeError(f"kvbm_peer: {name}'s checkpoints never settled")

        w1 = await serve_wave("w1")
        # worker 1's blocks are stored, announced and checkpointed before
        # worker 2 drops its copies and asks
        await checkpoints_landed("w1")
        await clear("w2")
        await asyncio.sleep(1.0)
        w2 = await serve_wave("w2")
        # each worker's stats as published after the wave
        while await met_sub.get(timeout=0.01) is not None:
            pass
        stats = {}
        while len(stats) < 2:
            msg = codec.unpack(await met_sub.get(timeout=10))
            stats[msg["worker_id"]] = msg["stats"]
        # a canary must have run on each before /health is read
        deadline = time.perf_counter() + 30
        metrics = {}
        while time.perf_counter() < deadline:
            metrics = {name: scrape(sys_port + i, "/metrics")[1]
                       for i, name in enumerate(("w1", "w2"))}
            if all(gauge(m, "health_canaries") >= 1 for m in metrics.values()):
                break
            await asyncio.sleep(0.5)
        health = {name: scrape(sys_port + i, "/health") for i, name in enumerate(("w1", "w2"))}
        live = {name: scrape(sys_port + i, "/live")[0] for i, name in enumerate(("w1", "w2"))}

        # the same two workers behind the frontend, over HTTP
        t_http = time.perf_counter()
        fe = await frontend_http(seed, http_port, sys_port, ids, routers, stats_of,
                                 checkpoints_landed, alive, procs)
        fe["http_s"] = round(time.perf_counter() - t_http, 2)

        # durable sessions: the uninterrupted streams, then the same requests
        # migrated off a worker SIGKILLed mid-decode, beside an HTTP stream
        # on that worker
        dreqs = durable_requests(seed, vocab, "peer-durable")
        whole = await together(routers["w1"].generate, dreqs)
        await checkpoints_landed("w1")
        for name in ("w1", "w2"):
            await clear(name)
        await asyncio.sleep(1.0)  # each mesh hears the other's `cleared`
        w1_base = await stats_of("w1")
        w2_base = await stats_of("w2")
        reset_counts()
        by_instance = {f"{i:x}": name for name, i in ids.items()}
        fe_mig = {"events": 0}
        fe_first = asyncio.Event()

        async def on_mig_frame(frame):
            if frame.startswith(": worker_instance_id "):
                # the retry's worker announces itself too: keep the first
                name = by_instance[json.loads(frame.split(" ", 2)[2])[0]]
                fe_mig.setdefault("first", name)
                fe_mig["last"] = name
            elif frame.startswith("data: {"):
                fe_mig["events"] += 1
                fe_first.set()

        # its prefill is done before the durable prompts arrive
        fe_task = asyncio.create_task(http_call(http_port, "POST", "/v1/completions", {
            "model": FE_MODEL, "prompt": text(FE_MIGRATE_PROMPT, 9001),
            "max_tokens": FE_MIGRATE_OUT, "temperature": 0.0, "stream": True,
            "stream_options": {"include_usage": True},
            "nvext": {"annotations": ["worker_instance_id"], "ignore_eos": True,
                      "router_config_override": {"backend_instance_id": ids["w1"]}}},
            on_mig_frame))
        await asyncio.wait_for(fe_first.wait(), 60)
        mig = RetryClock(PushRouter(
            client, RouterMode.ROUND_ROBIN,
            prefer=lambda ready: [ids["w1"]] if ids["w1"] in ready else ready))
        records = [{"tokens": [], "times": []} for _ in dreqs]
        tasks = [asyncio.create_task(migrate_stream(mig, r, rec))
                 for r, rec in zip(dreqs, records)]
        want = full_pages(dreqs) + FE_MIGRATE_PROMPT // 64
        deadline = time.perf_counter() + 120
        while True:
            st = await stats_of("w1")
            pushed = stat_delta(st, w1_base, "kvbm_ckpt_blocks_pushed")
            if (pushed >= want and min(len(r["tokens"]) for r in records) >= DURABLE_CUT
                    and fe_mig["events"] >= FE_MIGRATE_CUT
                    and st["kvbm_ckpt_queue_depth"] == 0 and st["kvbm_pending_offloads"] == 0):
                break
            assert time.perf_counter() < deadline and not any(
                t.done() for t in tasks + [fe_task]), \
                "kvbm_peer: the streams never reached the cut with their prompts checkpointed"
        w1_at_kill = st
        t_kill = time.perf_counter()
        procs["w1"].kill()
        at_kill = [len(r["tokens"]) for r in records]
        fe_at_kill = fe_mig["events"]
        await asyncio.wait_for(asyncio.gather(*tasks), 180)
        fe_st, _h, _b, fe_ev = await asyncio.wait_for(fe_task, 180)
        w2_after = await stats_of("w2")
        fe_metrics = (await http_call(http_port, "GET", "/metrics"))[2].decode()
        fe_cpu_s = proc_cpu_s(procs["frontend"].pid)
        proc = procs.pop("w1")
        rcs["w1"] = await asyncio.get_running_loop().run_in_executor(None, proc.wait, 30)
        assert rcs["w1"] == -signal.SIGKILL, rcs
        await client.close()
        for name in ("w2", "frontend"):
            procs[name].send_signal(signal.SIGTERM)
            proc = procs.pop(name)
            rcs[name] = await asyncio.get_running_loop().run_in_executor(None, proc.wait, 120)
            assert rcs[name] == 0, f"kvbm_peer: {name} exited {rcs[name]} on SIGTERM: {tail(name)}"
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
            os.unlink(f.name)
        if drt is not None:
            await drt.close()

    for i, (a, b) in enumerate(zip(w1, w2)):
        assert a["tokens"] == b["tokens"], f"kvbm_peer: request {i} differs on the pulling worker"
    m1, m2 = metrics["w1"], metrics["w2"]
    assert gauge(m1, "kvbm_offloaded_blocks") > 0, "kvbm_peer: worker 1 offloaded nothing"
    assert gauge(m2, "kvbm_onboard_src_peer_blocks") > 0, "kvbm_peer: worker 2 pulled nothing"
    assert stats[ids["w2"]]["kvbm_remote_blocks_pulled"] > 0, "kvbm_peer: no pull completed"
    assert stats[ids["w1"]]["kv_transfers_served"] > 0, "kvbm_peer: worker 1 served no pull"
    for name, m in metrics.items():
        assert gauge(m, "health_canaries") >= 1, f"kvbm_peer: no canary ran on {name}"
        assert health[name][0] == 200 and json.loads(health[name][1])["status"] == "healthy", health
        assert live[name] == 200
    s1, s2 = stats[ids["w1"]], stats[ids["w2"]]
    pull_ms = list(s2.get("kvbm_peer_ms_per_block", {}).values())
    calls = s2["attention_calls"]
    assert calls["kernels"].get("prefill_attention/none", 0) > 0, calls
    assert not any(calls["plain"].values()), calls
    ttft = {name: [r["ttft_s"] for r in recs] for name, recs in (("w1", w1), ("w2", w2))}
    emit("kvbm_peer", model="llama-3.2-3b", layers=LOAD_LAYERS, num_pages_each=PEER_PAGES,
         host_blocks=PEER_HOST_BLOCKS, sessions=KVBM_SESSIONS,
         prompt_tokens=KVBM_PROMPT + PEER_TAIL, max_tokens=KVBM_OUT,
         seconds_to_ready=round(t_ready, 2), streams_equal=len(w2),
         ttft_ms={name: {"p50": round(1e3 * pct(t, 50), 2), "p99": round(1e3 * pct(t, 99), 2)}
                  for name, t in ttft.items()},
         worker1={k: s1.get(k) for k in ("kvbm_offloaded_blocks", "kvbm_host_hits",
                                         "kvbm_host_load_ms_per_block", "kv_transfers_served",
                                         "kv_bytes_served", "kvbm_dropped_blocks")},
         worker2={k: s2.get(k) for k in ("kvbm_onboard_src_peer_blocks", "kvbm_remote_onboards",
                                         "kvbm_remote_blocks_pulled", "kvbm_peer_bytes_pulled",
                                         "kvbm_peer_pull_ms_sum", "kvbm_peer_pull_hist",
                                         "kvbm_onboard_count", "kvbm_onboard_ms_sum",
                                         "kv_onboard_fallbacks")},
         peer_ms_per_block=pull_ms,
         metrics_scraped={name: {k: gauge(m, k) for k in (
             "kvbm_offloaded_blocks", "kvbm_onboard_src_peer_blocks", "kvbm_host_hits",
             "kvbm_onboard_count", "health_canaries", "health_canary_failures")}
             for name, m in metrics.items()},
         health={name: h[0] for name, h in health.items()}, live=live,
         system_ports=[sys_port, sys_port + 1], exit_codes=rcs)

    # the frontend's stream on the killed worker: finished on the other
    data = sse_data(fe_ev)
    usage = [d for _t, d in data if d.get("usage")][-1]["usage"]
    finish = [d["choices"][0]["finish_reason"] for _t, d in data
              if d["choices"] and d["choices"][0].get("finish_reason")]
    assert fe_st == 200 and usage["completion_tokens"] == FE_MIGRATE_OUT and finish == ["length"], \
        (fe_st, usage, finish)
    assert fe_mig.get("first") == "w1" and fe_mig.get("last") == "w2", \
        f"frontend: the stream did not move from w1 to w2: {fe_mig}"
    migrations = float(re.search(r"^dynamo_frontend_migrations_total (\S+)$", fe_metrics,
                                 re.M).group(1))
    assert migrations >= 1, migrations
    gaps = [t for t, d in data if d["choices"] and d["choices"][0].get("text")]
    resume_gap = max(b - a for a, b in zip(gaps, gaps[1:]))
    emit("frontend", model="llama-3.2-3b", layers=LOAD_LAYERS, workers=2,
         num_pages_each=PEER_PAGES, router_mode="kv", seconds_to_live=round(fe_live_s, 2),
         **fe, frontend_cpu_s=round(fe_cpu_s, 2),
         migration={"killed": "w1", "resumed_on": fe_mig["last"],
                    "events_at_kill": fe_at_kill, "tokens": usage["completion_tokens"],
                    "resume_gap_ms": round(1e3 * resume_gap, 2), "migrations": migrations},
         exit_codes=rcs)

    # the durable streams, and the HTTP stream's resume beside them
    resumed_streams = DURABLE_STREAMS + 1
    for i, (w, r) in enumerate(zip(whole, records)):
        assert r["tokens"] == w["tokens"], \
            f"kvbm_peer: stream {i} resumed on worker 2 differs from its uninterrupted stream"
    resumed = stat_delta(w2_after, w2_base, "migrations_resumed")
    replayed = stat_delta(w2_after, w2_base, "migration_replayed_tokens")
    assert resumed == resumed_streams, f"kvbm_peer: {resumed} resumes on worker 2"
    assert stat_delta(w2_after, w2_base, "resume_source_checkpoint") >= 1, w2_after
    assert replayed < 2 * 64 * resumed_streams, f"kvbm_peer: {replayed} tokens recomputed"
    dcalls = calls_delta(w2_after, w2_base)
    assert dcalls.get("kernels:paged_decode/none", 0) > 0 and set(dcalls) <= {
        "kernels:paged_decode/none", "kernels:prefill_attention/none"}, dcalls
    blocks = stat_delta(w1_at_kill, w1_base, "kvbm_ckpt_blocks_pushed")
    push_s = stat_delta(w1_at_kill, w1_base, "kvbm_ckpt_push_s")
    itl = [x for w in whole for x in w["itl_s"]]
    emit("kvbm_peer_durable", model="llama-3.2-3b", layers=LOAD_LAYERS, streams=DURABLE_STREAMS,
         prompt_tokens=[len(r["token_ids"]) for r in dreqs], max_tokens=DURABLE_OUT,
         tokens_at_kill=at_kill, streams_equal=len(records),
         **mig.resume(dreqs, records, t_kill),
         http_streams_beside=1, migrations_resumed=resumed, replayed_tokens=replayed,
         replayed_tokens_per_stream=round(replayed / resumed_streams, 1),
         resume_source={k: stat_delta(w2_after, w2_base, f"resume_source_{k}")
                        for k in ("checkpoint", "peer", "local", "recompute")},
         tail_recompute=dev_delta(w2_after, w2_base, "replay"),
         onboard={k: stat_delta(w2_after, w2_base, k) for k in (
             "kvbm_onboard_src_local_blocks", "kvbm_onboard_src_peer_blocks",
             "kvbm_onboard_count", "kvbm_onboard_ms_sum", "kv_onboard_fallbacks")},
         checkpoint={"blocks_pushed": blocks,
                     "push_ms_per_block": round(1e3 * push_s / blocks, 3) if blocks else None,
                     "blocks_dropped": stat_delta(w1_at_kill, w1_base, "kvbm_ckpt_blocks_dropped"),
                     "received_by_w2": stat_delta(w2_after, w2_base, "kv_checkpoint_blocks_received")},
         uninterrupted_itl_ms={"p50": round(1e3 * pct(itl, 50), 3),
                               "p99": round(1e3 * pct(itl, 99), 3)},
         worker2_calls=dcalls, exit_codes=rcs)


# ---------------------------------------------------------------------- #
# phase: durable (session checkpoints, migration and a live morph, in process)
# ---------------------------------------------------------------------- #

DURABLE_STREAMS = 4  # two greedy, two seeded
DURABLE_PROMPT, DURABLE_OUT, DURABLE_CUT = 1000, 256, 128  # cut: tokens out at the sever
DURABLE_PAGES = 1024  # each engine's pool
DURABLE_CKPT = "1024"  # DYN_KV_CHECKPOINT: blocks the stage holds at most


def durable_requests(seed: int, vocab: int, tag: str) -> list:
    _, text = make_requests(seed, vocab, [], (), (), tag)
    return [PreprocessedRequest(
        token_ids=text(DURABLE_PROMPT + 13 * i, 7000 + i), request_id=f"{tag}-{i}",
        stop_conditions={"max_tokens": DURABLE_OUT},
        sampling_options={} if i < 2 else {"temperature": 0.7, "seed": 3000 + i},
    ).to_dict() for i in range(DURABLE_STREAMS)]


def full_pages(reqs) -> int:
    return sum(len(r["token_ids"]) // 64 for r in reqs)


class EnginePair:
    """Two in-process engines as a router sees them: a stream goes to the
    first engine its request does not exclude (`router.exclude_instances`),
    and a StreamSevered the engine raises surfaces as StreamLost with the
    instance on the context, as the request plane codes a morph's drain."""

    def __init__(self, engines: dict):
        self.engines = engines  # instance id -> engine

    async def generate(self, request, context):
        from dynamo_tpu_torch.runtime.push_router import request_excluded_instances

        req = request.to_dict() if hasattr(request, "to_dict") else request
        excluded = set(request_excluded_instances(req))
        inst = next(i for i in self.engines if i not in excluded)
        context.routed_instance = inst
        return self._stream(self.engines[inst], req)

    @staticmethod
    async def _stream(engine, req):
        from dynamo_tpu_torch.runtime.request_plane import StreamLost, StreamSevered

        try:
            async for item in engine.generate(req, Context()):
                yield item
        except StreamSevered as e:
            raise StreamLost(str(e)) from e


async def migrate_stream(router, req: dict, record: dict) -> None:
    """One request through the port's Migration; `record` gets the tokens
    and the arrival time of each."""
    from dynamo_tpu_torch.llm.migration import Migration

    async for ann in Migration(router, migration_limit=2).generate(
            PreprocessedRequest.from_dict(req), Context()):
        if ann.is_error():
            raise RuntimeError(f"migrated stream failed: {ann.comment}")
        toks = (ann.data or {}).get("token_ids") or []
        now = time.perf_counter()
        record["tokens"].extend(toks)
        record["times"].extend([now] * len(toks))


class RetryClock:
    """A router that notes when each migrated retry is issued through it."""

    def __init__(self, inner):
        self.inner = inner
        self.issued: dict = {}  # request id -> perf_counter at the retry

    def generate(self, request, context=None):
        if request.get("migration"):
            self.issued[request["request_id"]] = time.perf_counter()
        return self.inner.generate(request, context)

    def resume(self, reqs, records, t_cut: float) -> dict:
        """Per stream, ms from the cut (the kill, or the morph's start) to
        the retry's issue and to the first token the retry streamed."""
        issued, gap = [], []
        for req, rec in zip(reqs, records):
            t = self.issued[req["request_id"]]
            issued.append(round(1e3 * (t - t_cut), 2))
            gap.append(round(1e3 * (next(x for x in rec["times"] if x > t) - t_cut), 2))
        return {"resume_gap_ms": gap, "retry_issued_ms": issued}


# `durable` at 4 layers (a block is then 1.05 MB), to pay for the
# spec_guided and the MoE phases' time
DURABLE_LAYERS = 4


async def durable(seed: int, params) -> dict:
    """Two engines (DURABLE_LAYERS layers, bf16, scatter), each with a 256-block host tier
    and a data plane, on one discovery service with DYN_KV_CHECKPOINT: A
    checkpoints its committed blocks into B's tier. Four streams (two greedy,
    two seeded) are taken uninterrupted on A, all at once, then run again through the
    port's Migration; once B holds their prompts and each has DURABLE_CUT
    tokens out, `A.morph("prefill")` severs them and they resume on B, which
    must classify the resumes `checkpoint`, recompute under two pages each
    and stream what the uninterrupted streams streamed. Mixed dispatch is
    off on both, so every decode row runs the decode kernel, as the
    decode-shaped tail recompute does. Then an injected `worker.morph:error`
    must roll A back to a routable role."""
    import os

    from dynamo_tpu_torch.kvbm import KvbmDistributed
    from dynamo_tpu_torch.llm import kv_transfer
    from dynamo_tpu_torch.runtime import DiscoveryServer, DistributedRuntime, RuntimeConfig, faults

    server = DiscoveryServer(port=0)
    _, port = await server.start()
    cfg = EngineConfig(model="llama3-3b", seed=seed, num_pages=DURABLE_PAGES,
                       kvbm_host_blocks=KVBM_HOST_BLOCKS, mixed_dispatch=False)
    members = []  # (drt, engine, plane, dist)
    os.environ["DYN_KV_CHECKPOINT"] = DURABLE_CKPT
    try:
        for _ in range(2):
            rc = RuntimeConfig.from_settings()
            rc.discovery_endpoint = f"tcp://127.0.0.1:{port}"
            drt = await DistributedRuntime.create(rc)
            engine = TorchEngine(
                cfg, model_config=dataclasses.replace(llama.LlamaConfig.llama3_2_3b(),
                                                      num_layers=DURABLE_LAYERS),
                params=cut_depth(params, DURABLE_LAYERS), device="cuda")
            plane = kv_transfer.KvDataPlaneServer(host="127.0.0.1")
            await plane.start()
            await plane.register(drt)
            engine.data_plane = plane
            dist = KvbmDistributed(drt, engine.kvbm, plane, "dynamo", "kvbm", drt.instance_id)
            await dist.start()
            members.append((drt, engine, plane, dist))
    finally:
        os.environ.pop("DYN_KV_CHECKPOINT", None)
    (a_drt, a, a_plane, a_dist), (b_drt, b, b_plane, b_dist) = members
    try:
        for e in (a, b):
            await e.warmup()
        for _ in range(500):
            if a_dist.checkpoint_peer() is not None:
                break
            await asyncio.sleep(0.01)
        assert a_dist.checkpoint_peer()[0] == b_drt.instance_id, "durable: A has no checkpoint peer"
        reqs = durable_requests(seed, llama.LlamaConfig.llama3_2_3b().vocab_size, "durable")
        whole = await together(lambda r: _open(a, r), reqs)
        # the migrated run starts from empty caches and tiers on both sides:
        # A checkpoints it afresh, B holds only what A pushes from here on
        await settle(a)
        await checkpoints_settled(a_dist)
        for e in (a, b):
            e.clear_kv_blocks()
        await asyncio.sleep(1.0)  # each mesh hears the other's `cleared`
        pushed0 = b_plane.checkpoint_blocks_received
        a0, b0 = a.stats(), b.stats()
        # counts to zero just before the main path is driven
        reset_counts()
        router = RetryClock(EnginePair({a_drt.instance_id: a, b_drt.instance_id: b}))
        records = [{"tokens": [], "times": []} for _ in reqs]
        tasks = [asyncio.create_task(migrate_stream(router, r, rec))
                 for r, rec in zip(reqs, records)]
        want = full_pages(reqs)
        deadline = time.perf_counter() + 120
        while (b_plane.checkpoint_blocks_received - pushed0 < want
               or min(len(r["tokens"]) for r in records) < DURABLE_CUT):
            assert time.perf_counter() < deadline and not any(t.done() for t in tasks), \
                "durable: the streams never reached the cut with their prompts checkpointed"
            await asyncio.sleep(0.002)
        t_cut = time.perf_counter()
        at_cut = [len(r["tokens"]) for r in records]
        morph = await a.morph("prefill")
        await asyncio.wait_for(asyncio.gather(*tasks), 120)
        launches = kernel_launches()
        plain = dict(pa.plain_calls)
        a1, b1 = a.stats(), b.stats()

        # an injected error mid-morph rolls A back, and A serves again
        faults.configure("worker.morph:error,times=1", seed=seed)
        try:
            await a.morph("decode")
            raise AssertionError("durable: the injected morph error did not raise")
        except faults.FaultError:
            pass
        finally:
            faults.reset()
        a2 = a.stats()
        after = new_record()
        await run_request(a, dict(reqs[0], request_id="durable-after-rollback",
                                  stop_conditions={"max_tokens": 8}), after)
    finally:
        for drt, engine, plane, dist in members:
            kv_transfer._CONN_POOL.evict(plane.addr)
            await dist.close()
            await engine.close()
            await plane.close()
            await drt.close()
        await server.stop()

    for i, (w, r) in enumerate(zip(whole, records)):
        assert len(w["tokens"]) == DURABLE_OUT and r["tokens"] == w["tokens"], \
            f"durable: stream {i} resumed on B differs from its uninterrupted stream"
    assert morph["drained"] == DURABLE_STREAMS and morph["to"] == "prefill", morph
    assert stat_delta(a1, a0, "morph_drained_sessions") == DURABLE_STREAMS, a1
    assert stat_delta(a1, a0, "morphs_completed") == 1 and a1["engine_role"] == "prefill"
    resumed = stat_delta(b1, b0, "migrations_resumed")
    replayed = stat_delta(b1, b0, "migration_replayed_tokens")
    assert resumed == DURABLE_STREAMS, f"durable: {resumed} resumes on B"
    assert stat_delta(b1, b0, "resume_source_checkpoint") >= 1, b1
    assert replayed < 2 * 64 * DURABLE_STREAMS, f"durable: {replayed} tokens recomputed"
    assert a2["morphs_rolled_back"] == 1 and a2["engine_role"] == "prefill"
    assert a2["morph_state"] == "serving" and len(after["tokens"]) == 8, "durable: A not routable"
    used = [("paged_decode", "none"), ("prefill_attention", "none")]
    assert all(launches.get(u, 0) > 0 for u in used), f"durable: a path kernel never launched: {launches}"
    assert sum(launches.values()) == sum(launches[u] for u in used), \
        f"durable: a kernel outside the path launched: {launches}"
    assert not any(plain.values()), f"durable: plain attention ran: {plain}"
    itl = [x for w in whole for x in w["itl_s"]]
    blocks = stat_delta(a1, a0, "kvbm_ckpt_blocks_pushed")
    push_s = stat_delta(a1, a0, "kvbm_ckpt_push_s")
    emit("durable", model="llama-3.2-3b", layers=DURABLE_LAYERS, dtype="bfloat16",
         decode_pool_mode="scatter", kv_quant="none", num_pages_each=DURABLE_PAGES,
         host_blocks=KVBM_HOST_BLOCKS, streams=DURABLE_STREAMS,
         prompt_tokens=[len(r["token_ids"]) for r in reqs], max_tokens=DURABLE_OUT,
         tokens_at_sever=at_cut, streams_equal=len(records),
         **router.resume(reqs, records, t_cut),
         migrations_resumed=resumed, replayed_tokens=replayed,
         replayed_tokens_per_stream=round(replayed / DURABLE_STREAMS, 1),
         resume_source={k: stat_delta(b1, b0, f"resume_source_{k}")
                        for k in ("checkpoint", "peer", "local", "recompute")},
         tail_recompute=dev_delta(b1, b0, "replay"),
         checkpoint={"blocks_pushed": blocks, "bytes_pushed": stat_delta(a1, a0, "kvbm_ckpt_bytes_pushed"),
                     "push_ms_per_block": round(1e3 * push_s / blocks, 3) if blocks else None,
                     "blocks_dropped": stat_delta(a1, a0, "kvbm_ckpt_blocks_dropped"),
                     "received_by_b": stat_delta(b1, b0, "kv_checkpoint_blocks_received")},
         morph={"drained": morph["drained"], "duration_s": round(morph["duration_s"], 3),
                "rolled_back_on_injected_error": a2["morphs_rolled_back"],
                "role_after_rollback": a2["engine_role"]},
         uninterrupted_itl_ms={"p50": round(1e3 * pct(itl, 50), 3),
                               "p99": round(1e3 * pct(itl, 99), 3)},
         launches={f"{n}/{f}": c for (n, f), c in launches.items() if c}, plain_calls=plain)
    return launches


async def checkpoints_settled(dist) -> None:
    """Every block the checkpointer staged is pushed or dropped."""
    for _ in range(3000):
        await asyncio.sleep(0.01)
        st = dist.stats()
        if st["kvbm_ckpt_queue_depth"] == 0 and st["kvbm_ckpt_blocks_staged"] == (
                st["kvbm_ckpt_blocks_pushed"] + st["kvbm_ckpt_blocks_dropped"]):
            return
    raise RuntimeError("durable: the checkpointer never settled")


async def together(open_stream, reqs) -> list:
    """The durable streams uninterrupted, all submitted at once: records
    (tokens, ITL). With mixed dispatch off, a stream's arithmetic does not
    depend on the others (decode rows always fill the 64-lane block, a
    prefill chunk its padded lanes)."""
    records = [new_record() for _ in reqs]
    await asyncio.gather(*(run_stream(open_stream, r, rec) for r, rec in zip(reqs, records)))
    for req, rec in zip(reqs, records):
        assert rec["finish"] == "length" and len(rec["tokens"]) == DURABLE_OUT, \
            (req["request_id"], rec["finish"], len(rec["tokens"]))
    return records


# ---------------------------------------------------------------------- #
# phase: spec_guided (speculative and guided decoding)
# ---------------------------------------------------------------------- #

SPEC_CFG = dict(spec_mode="ngram", spec_draft_len=SPEC_T - 1, spec_ngram=2, spec_rounds=4)
# (phase, kv_quant, layers, dtype): the model's depth in bf16, the quantized
# pools cut; an f32 run at a cut depth, where shapes round alike and the
# streams must be the plain ones
SPEC_LAYERS = 4  # the bf16 spec_guided phase: full width, a cut depth
SPEC_PHASES = [("spec_guided", "none", SPEC_LAYERS, torch.bfloat16),
               ("spec_guided_int8", "int8", 4, torch.bfloat16),
               ("spec_guided_int4", "int4", 4, torch.bfloat16),
               ("spec_guided_f32", "none", 4, torch.float32)]
# where a spec stream parts from the plain one, the plain logits' top-two gap
# at that position must be a near-tie: at most this many ulps of the compute
# type at the top logit (bf16: the verify pass computes each position in
# GEMMs of another shape than plain decode, and bf16 rounds by shape; f32:
# only the summation order differs). In a quantized pool the spec path
# quantizes other writes (a rejected draft can raise a page's scale and
# requantize the committed rows, as in the reference), so each arm's own
# token must lie within that many ulps plus the shift the pool's
# quantization makes to these logits of the recomputed top; a wrong token
# lies some 4 logit std (~140 bf16 ulps at the top logit) below it
SPEC_GAP_ULPS = {torch.bfloat16: 4, torch.float32: 1024}
MANTISSA_BITS = {torch.bfloat16: 7, torch.float32: 23}
SCHEMA = {"type": "object", "properties": {
    "ok": {"type": "boolean"}, "col": {"enum": ["red", "green"]}}}
SPEC_TOKENIZER: dict = {}  # vocab -> the ByteTokenizer every spec engine serves
PHRASES = ["the cache block stores keys. ", "decode the next token now. ",
           "pages hold the stream. ", "verify each draft in one pass. "]


def spec_requests(seed: int, vocab: int, tag: str) -> list:
    """8 greedy byte-tokenized prompts of 60-900 tokens built from a few
    repeated phrases (text a prompt-lookup draft can match)."""
    tok = ByteTokenizer(vocab)
    rng = np.random.default_rng(seed + 17)
    reqs = []
    for i, n in enumerate([60, 240, 900, 120, 480, 300, 700, 90]):
        text = f"{tag} {i}: "
        while len(text) < n:
            text += PHRASES[int(rng.integers(len(PHRASES)))]
        reqs.append(PreprocessedRequest(
            token_ids=tok.encode(text[:n]), request_id=f"{tag}-{i}",
            stop_conditions={"max_tokens": MAX_TOKENS, "ignore_eos": True},
            sampling_options={"temperature": 0.0}).to_dict())
    return reqs


def guided_requests(vocab: int, tag: str) -> list:
    """A greedy guided_choice request and a seeded sampled json_schema one
    (a greedy random-weight model can pick the schema's optional whitespace
    forever)."""
    tok = ByteTokenizer(vocab)
    return [PreprocessedRequest(
        token_ids=tok.encode(f"{tag} {i}: answer in the format asked."), request_id=f"{tag}-g{i}",
        stop_conditions={"max_tokens": 320}, sampling_options=samp,
        eos_token_ids=[ByteTokenizer.EOS], guided=g).to_dict()
        for i, (g, samp) in enumerate([
            ({"kind": "choice", "choices": ["yes", "no", "maybe"]}, {"temperature": 0.0}),
            ({"kind": "json_schema", "schema": SCHEMA}, {"temperature": 1.0, "seed": 7})])]


def check_guided_outputs(phase: str, vocab: int, records: list) -> list:
    tok = ByteTokenizer(vocab)
    texts = [tok.decode(r["tokens"]) for r in records]
    assert texts[0] in ("yes", "no", "maybe"), (phase, texts[0])
    obj = json.loads(texts[1])
    assert set(obj) == {"ok", "col"} and isinstance(obj["ok"], bool) \
        and obj["col"] in ("red", "green"), (phase, texts[1])
    assert all(r["finish"] == "eos" for r in records), (phase, [r["finish"] for r in records])
    return texts


async def staggered(engine, reqs) -> tuple:
    records = [new_record() for _ in reqs]
    t0 = time.perf_counter()
    tasks = []
    for req, rec in zip(reqs, records):
        tasks.append(asyncio.create_task(run_request(engine, req, rec)))
        await asyncio.sleep(STAGGER_S)
    await asyncio.gather(*tasks)
    return records, time.perf_counter() - t0


@torch.no_grad()
def top2_gap(params: dict, cfg, tokens: list, kvq: str, also=(), lora=None) -> dict:
    """The plain logits after `tokens` (one batched-prefill forward on a
    fresh pool of format `kvq`, with the adapter operand `lora` when given):
    the top two, their gap and the gap in ulps of the compute type at the
    top logit; for a quantized pool also the largest shift its quantization
    makes to the logits of the top two and of the tokens `also` (against
    the same forward over a full-precision pool)."""
    from dynamo_tpu_torch.engine.kv_cache import alloc_kv_arrays

    T, ps = len(tokens), 64
    P = -(-T // ps)
    kv_k, kv_v = alloc_kv_arrays(cfg.num_layers, P + 1, ps, cfg.num_kv_heads, cfg.head_dim,
                                 dtype=cfg.dtype, device=DEV, kv_quant=kvq)
    args = (i32([tokens]), i32([list(range(T))]))
    tab = (i32([list(range(1, P + 1))]), i32([0]), i32([T - 1]))
    logits = llama.prefill_forward_batched(params, cfg, *args, kv_k, kv_v, *tab,
                                           lora=lora)[0][0].float()
    top = torch.topk(logits, 2)
    a, b = (float(x) for x in top.values)
    ulp = 2.0 ** (np.floor(np.log2(max(abs(a), 1e-30))) - MANTISSA_BITS[cfg.dtype])
    shift = 0.0
    if kvq != "none":
        kv_k, kv_v = alloc_kv_arrays(cfg.num_layers, P + 1, ps, cfg.num_kv_heads,
                                     cfg.head_dim, dtype=cfg.dtype, device=DEV)
        full = llama.prefill_forward_batched(params, cfg, *args, kv_k, kv_v, *tab,
                                             lora=lora)[0][0].float()
        idx = torch.cat([top.indices, torch.tensor(list(also), dtype=torch.long, device=DEV)])
        shift = float((logits - full).abs()[idx].max())
    lag = [(a - float(logits[t])) / ulp for t in also]
    return {"top": [int(x) for x in top.indices], "logits": [a, b], "gap": a - b,
            "gap_ulps": (a - b) / ulp, "lag_ulps": lag, "quant_shift": shift,
            "quant_shift_ulps": shift / ulp, "logit_std": float(logits.std())}


def divergences(phase: str, arm: str, params, cfg, kvq: str, reqs, plain: list,
                got: list) -> list:
    """Each request whose spec stream parts from the plain one: the first
    divergent position, the plain logits' top-two gap there and each arm's
    token's lag behind the top, which must be a near-tie (SPEC_GAP_ULPS)."""
    out = []
    for req, a, b in zip(reqs, plain, got):
        if a == b:
            continue
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        gap = top2_gap(params, cfg, list(req["token_ids"]) + a[:p], kvq, also=(a[p], b[p]))
        rep = {"request": req["request_id"], "position": p, "plain": a[p], "spec": b[p], **gap}
        out.append(rep)
        worst = gap["gap_ulps"] if kvq == "none" else max(gap["lag_ulps"])
        assert worst <= SPEC_GAP_ULPS[cfg.dtype] + gap["quant_shift_ulps"], \
            f"{phase}/{arm}: streams part at no near-tie: {rep}"
    return out


def arm_metrics(records, wall) -> dict:
    itl = [x for r in records for x in r["itl_s"]]
    ttft = [r["ttft_s"] for r in records]
    return {"output_tok_s": round(sum(len(r["tokens"]) for r in records) / wall, 1),
            "ttft_ms": {"p50": round(1e3 * pct(ttft, 50), 2), "p99": round(1e3 * pct(ttft, 99), 2)},
            "itl_ms": {"p50": round(1e3 * pct(itl, 50), 3), "p99": round(1e3 * pct(itl, 99), 3)}}


async def guided_itl(engine, vocab: int, guided: dict) -> dict:
    """ITL of 4 unguided greedy lanes started together, alone and beside the
    seeded guided request `guided` run again (the same tokens, so its FSM
    states are cached)."""
    tok = ByteTokenizer(vocab)
    out = {}
    for arm in ("alone", "with_guided"):
        reqs = [PreprocessedRequest(
            token_ids=tok.encode(f"itl {arm} {i}: " + PHRASES[i] * 4), request_id=f"itl-{arm}-{i}",
            stop_conditions={"max_tokens": MAX_TOKENS, "ignore_eos": True},
            sampling_options={"temperature": 0.0}).to_dict() for i in range(4)]
        if arm == "with_guided":
            reqs.append(dict(guided, request_id="itl-guided"))
        records = [new_record() for _ in reqs]
        await asyncio.gather(*(run_request(engine, r, rec) for r, rec in zip(reqs, records)))
        itl = [x for rec in records[:4] for x in rec["itl_s"]]
        out[arm] = {"p50": round(1e3 * pct(itl, 50), 3), "p99": round(1e3 * pct(itl, 99), 3)}
    return out


def guided_fsm_cold_s(vocab: int) -> float:
    """Seconds to compile a guided regex ('[ab]*') on a fresh compiler and
    tokenizer and read its start state's mask: the vocabulary decode, the
    token trie and one mask walk that an engine pays for its first guided
    spec."""
    from dynamo_tpu_torch.llm.guided import GuidedCompiler

    t0 = time.perf_counter()
    fsm = GuidedCompiler(ByteTokenizer(vocab)).compile({"kind": "regex", "regex": "[ab]*"})
    fsm.allowed(fsm.start_state)
    return round(time.perf_counter() - t0, 3)


async def spec_guided(seed: int, params, phase: str, kvq: str, layers: int,
                      dtype: torch.dtype) -> dict:
    """Plain, split-spec (mixed dispatch off) and fused-spec engines serve
    the same repetitive traffic; the spec streams must equal the plain ones
    or part only at a near-tie. Guided choice and json_schema requests on
    the plain and the fused-spec engines must fit their constraint. Each
    arm's kernel launches are read over its own traffic."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=layers, dtype=dtype)
    if layers != LAYERS:
        params = cut_depth(params, layers)
    if dtype != torch.bfloat16:
        params = {k: None if v is None else (
            {n: x.to(dtype) for n, x in v.items()} if k == "layers" else v.to(dtype))
            for k, v in params.items()}
    reqs = spec_requests(seed, cfg.vocab_size, phase)
    tokenizer = SPEC_TOKENIZER.setdefault(cfg.vocab_size, ByteTokenizer(cfg.vocab_size))
    arms = {"plain": dict(), "spec_split": dict(SPEC_CFG, mixed_dispatch=False),
            "spec_fused": dict(SPEC_CFG, mixed_dispatch=True)}
    res, streams, launches = {}, {}, {}
    for arm, kw in arms.items():
        engine = TorchEngine(EngineConfig(model="llama3-3b", seed=seed, kv_quant=kvq, **kw),
                             model_config=cfg, params=params, device="cuda")
        engine.tokenizer = tokenizer  # one vocabulary walk for every engine's FSMs
        t0 = time.perf_counter()
        await engine.warmup()
        warm_s = time.perf_counter() - t0
        reset_counts()
        base = engine.stats()
        records, wall = await staggered(engine, reqs)
        stats = engine.stats()
        launches[arm] = kernel_launches()
        plain_calls = dict(pa.plain_calls)
        assert all(len(r["tokens"]) == MAX_TOKENS for r in records), (phase, arm)
        assert not any(plain_calls.values()), f"{phase}/{arm}: plain attention ran: {plain_calls}"
        used = {"plain": ("prefill_attention", "ragged_attention", "paged_decode"),
                "spec_split": ("prefill_attention",),
                "spec_fused": ("prefill_attention", "ragged_attention")}[arm]
        for name in used:
            assert launches[arm].get((name, kvq), 0) > 0, f"{phase}/{arm}: {name} never launched"
        streams[arm] = [r["tokens"] for r in records]
        res[arm] = {**arm_metrics(records, wall),
                    "warmup_s": round(warm_s, 3),
                    "mixed_steps": stats["mixed_steps"] - base["mixed_steps"],
                    "dev_time": dev_time_delta(stats, base),
                    "launches": {f"{n}/{f}": c for (n, f), c in launches[arm].items() if c}}
        if arm != "plain":
            for key in ("spec_num_drafts", "spec_num_draft_tokens", "spec_num_accepted_tokens",
                        "mixed_rows_spec"):
                res[arm][key] = stats[key] - base[key]
            res[arm]["spec_mean_accepted_len"] = round(
                1.0 + res[arm]["spec_num_accepted_tokens"] / max(res[arm]["spec_num_drafts"], 1), 3)
            assert res[arm]["spec_num_drafts"] > 0, (phase, arm)
        if arm == "spec_fused":
            assert res[arm]["mixed_rows_spec"] > 0, f"{phase}: no fused verify rows"
        if arm == "spec_fused" or (arm == "plain" and phase == "spec_guided"):
            # guided requests (refused typed by a split-only spec engine;
            # on the plain engine at full depth, for the ITL reading)
            reset_counts()
            g_reqs = guided_requests(cfg.vocab_size, f"{phase}-{arm}")
            g_recs = [new_record() for _ in g_reqs]
            t0 = time.perf_counter()
            await asyncio.gather(*(run_request(engine, r, rec) for r, rec in zip(g_reqs, g_recs)))
            res[arm]["guided_s"] = round(time.perf_counter() - t0, 3)
            res[arm]["guided_texts"] = check_guided_outputs(phase, cfg.vocab_size, g_recs)
            g_launch = kernel_launches()
            assert g_launch.get(("paged_decode", kvq), 0) > 0, f"{phase}/{arm}: no guided decode"
            assert not any(pa.plain_calls.values()), f"{phase}/{arm}: plain attention ran"
            add_launches(launches[arm], g_launch)
            if arm == "plain" and phase == "spec_guided":
                res[arm]["unguided_itl_ms"] = await guided_itl(engine, cfg.vocab_size, g_reqs[1])
        await engine.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
    div = {arm: divergences(phase, arm, params, cfg, kvq, reqs, streams["plain"], streams[arm])
           for arm in ("spec_split", "spec_fused")}
    emit(phase, model="llama-3.2-3b", layers=layers, dtype=str(dtype).split(".")[-1],
         kv_quant=kvq, spec=SPEC_CFG, requests=len(reqs),
         prompt_tokens=[len(r["token_ids"]) for r in reqs], max_tokens=MAX_TOKENS,
         gap_bound_ulps=SPEC_GAP_ULPS[dtype],
         streams_equal={arm: sum(a == b for a, b in zip(streams["plain"], streams[arm]))
                        for arm in ("spec_split", "spec_fused")},
         split_equal_fused=sum(a == b for a, b in zip(streams["spec_split"],
                                                      streams["spec_fused"])),
         divergences=div, arms=res,
         guided_fsm_cold_s=guided_fsm_cold_s(cfg.vocab_size) if phase == "spec_guided" else None)
    # the verify shapes' launches: the prefill kernel's in the split arm
    # (spec blocks and prompts), the ragged kernel's in the fused arm
    return {("prefill_attention@verify", kvq): launches["spec_split"].get(("prefill_attention", kvq), 0),
            ("ragged_attention@staircase", kvq): launches["spec_fused"].get(("ragged_attention", kvq), 0),
            **{key: sum(launches[a].get(key, 0) for a in arms) for key in
               {k for a in arms for k in launches[a]}}}


async def spec_guided_all(seed: int, params) -> dict:
    total: dict = {}
    for phase, kvq, layers, dtype in SPEC_PHASES:
        add_launches(total, await spec_guided(seed, params, phase, kvq, layers, dtype))
    return total


# ---------------------------------------------------------------------- #
# phase: lora (multi-LoRA serving)
# ---------------------------------------------------------------------- #

LORA_SLOTS = 4  # device adapter slots of the main arm (three adapters resident)
# 12 requests arriving together: 4 base, 8 spread over the three adapters
LORA_LENGTHS = [40, 300, 1500, 120, 700, 64, 1100, 500, 220, 900, 80, 1300]
LORA_OF = [None, "peft8", "peft16", "rnd", None, "peft8", "peft16", "rnd", None, "peft8",
           "rnd", None]
LORA_RANDOM_SEED = 7  # the `random:SEED` adapter
# a LoRA stream beside others against its solo run: where they part, the
# solo stream's logits (with the adapter) must be a near-tie there, at most
# this many bf16 ulps at the top logit — the batched and the solo run
# compute the same rows in GEMMs of other shapes, and bf16 rounds by shape
LORA_GAP_ULPS = 4
LORA_LAYERS = 8  # the lora phase: full width, a cut depth
LORA_SMALL_LAYERS = 4  # the f32 and pool arms: full width, a cut depth
# the f32 arm's forwards with adapters, card against CPU, per logits row
# |a - b|_2 / |b|_2: only f32 summation orders differ
TOL_LORA_F32_REL = 2e-3


def write_peft(d: str, cfg, rank: int, seed: int) -> str:
    """An HF PEFT export (adapter_config.json + adapter_model.safetensors,
    f32) of a random rank-`rank` adapter over q/k/v/o_proj, alpha = 2r."""
    import os

    from dynamo_tpu_torch.models import lora as lora_mod
    from dynamo_tpu_torch.models.safetensors_io import save_file

    gen = torch.Generator().manual_seed(seed)
    dims = lora_mod.target_dims(cfg)
    state = {}
    for li in range(cfg.num_layers):
        for peft_t, t in lora_mod._PEFT_NAMES.items():
            din, dout = dims[t]
            pre = f"base_model.model.model.layers.{li}.self_attn.{peft_t}"
            state[f"{pre}.lora_A.weight"] = torch.randn((rank, din), generator=gen) * 0.03
            state[f"{pre}.lora_B.weight"] = torch.randn((dout, rank), generator=gen) * 0.03
    os.makedirs(d, exist_ok=True)
    save_file(state, os.path.join(d, "adapter_model.safetensors"))
    with open(os.path.join(d, "adapter_config.json"), "w") as f:
        json.dump({"r": rank, "lora_alpha": 2 * rank, "peft_type": "LORA",
                   "target_modules": list(lora_mod._PEFT_NAMES)}, f)
    return d


def lora_adapters(cfg, root: str) -> list:
    """The three adapters of the phase: rank-8 and rank-16 PEFT exports
    written and loaded back, and a `random:SEED` one."""
    from dynamo_tpu_torch.models import lora as lora_mod

    return [
        lora_mod.load_peft_adapter(write_peft(f"{root}/peft8", cfg, 8, 81), cfg, name="peft8"),
        lora_mod.load_peft_adapter(write_peft(f"{root}/peft16", cfg, 16, 161), cfg,
                                   name="peft16"),
        lora_mod.init_adapter(cfg, "rnd", torch.Generator().manual_seed(LORA_RANDOM_SEED),
                              rank=16),
    ]


def cut_adapter(ad, layers: int, dtype):
    from dynamo_tpu_torch.models import lora as lora_mod

    return lora_mod.LoraAdapter(ad.name, ad.rank, ad.scale,
                                {t: v[:layers].to(dtype) for t, v in ad.a.items()},
                                {t: v[:layers].to(dtype) for t, v in ad.b.items()})


async def together_records(engine, reqs) -> tuple:
    """The requests submitted at once: records and wall seconds."""
    records = [new_record() for _ in reqs]
    t0 = time.perf_counter()
    await asyncio.gather(*(run_request(engine, r, rec) for r, rec in zip(reqs, records)))
    wall = time.perf_counter() - t0
    for req, rec in zip(reqs, records):
        assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, \
            (req["request_id"], rec["finish"], len(rec["tokens"]))
    return records, wall


async def solo_streams(engine, reqs) -> list:
    async def open_stream(r):
        return engine.generate(r, Context())

    async def clear():
        engine.clear_kv_blocks()

    return await alone(open_stream, clear, reqs)


def lora_divergences(phase: str, params, cfg, stack, reqs, solo: list, got: list,
                     bound_ulps: float) -> list:
    """Each LoRA request whose stream beside others parts from its solo
    run: the first divergent position and the solo run's top-two gap there
    (forward with the request's adapter), which must be a near-tie."""
    out = []
    for req, a, b in zip(reqs, solo, got):
        if a == b:
            continue
        p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        slot = stack["names"][req["lora_name"]]
        gap = top2_gap(params, cfg, list(req["token_ids"]) + a[:p], "none", also=(a[p], b[p]),
                       lora=dict(stack, idx=i32([slot])))
        rep = {"request": req["request_id"], "lora": req["lora_name"], "position": p,
               "solo": a[p], "batched": b[p], **gap}
        out.append(rep)
        assert gap["gap_ulps"] <= bound_ulps, f"{phase}: a LoRA stream parts at no near-tie: {rep}"
    return out


async def lora_main(seed: int, params, adapters) -> dict:
    """The mix on a plain engine (all base) and on an engine with the three
    adapters (4 base, 8 LoRA requests): base streams equal, every LoRA
    stream changed by its adapter and equal to its solo run or parted at a
    near-tie; the three kernels carry the LoRA traffic."""
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=LORA_LAYERS)
    params = cut_depth(params, LORA_LAYERS)
    adapters = [cut_adapter(a, LORA_LAYERS, cfg.dtype) for a in adapters]
    reqs, _ = make_requests(seed, cfg.vocab_size, LORA_LENGTHS, shared_idx=(), seeded_idx=(),
                            tag="lora")
    lreqs = [dict(r, lora_name=n) if n else r for r, n in zip(reqs, LORA_OF)]
    lora_idx = [i for i, n in enumerate(LORA_OF) if n]
    arms = {}
    for arm in ("base", "lora"):
        engine = TorchEngine(EngineConfig(model="llama3-3b", seed=seed, lora_pool_slots=LORA_SLOTS),
                             model_config=cfg, params=params, device="cuda")
        if arm == "lora":
            engine.register_adapters(adapters)
        t0 = time.perf_counter()
        await engine.warmup()
        warm_s = time.perf_counter() - t0
        reset_counts()
        base = engine.stats()
        records, wall = await together_records(engine, lreqs if arm == "lora" else reqs)
        launches, plain, stats = kernel_launches(), dict(pa.plain_calls), engine.stats()
        res = {**stream_metrics(records, wall), "warmup_s": round(warm_s, 3),
               "dev_time": dev_time_delta(stats, base),
               "mixed_steps": stats["mixed_steps"] - base["mixed_steps"],
               "launches": {f"{n}/{f}": c for (n, f), c in launches.items() if c}}
        res["streams"] = [r["tokens"] for r in records]
        if arm == "lora":
            check_path_launches("lora", launches, plain, "scatter", "none")
            res["mixed_rows_lora"] = stats["mixed_rows_lora"] - base["mixed_rows_lora"]
            res["lora_requests"] = stats["lora_requests"] - base["lora_requests"]
            assert res["mixed_rows_lora"] > 0, "lora: no LoRA row rode a mixed step"
            assert res["dev_time"].get("block_lora", {}).get("count", 0) > 0, "lora: no LoRA block"
            assert res["lora_requests"] == len(lora_idx)
            res["pool"] = {k: v for k, v in stats.items() if k.startswith("lora_pool_")}
            # the registration's onboards landed on the device thread ahead
            # of the warmup's dispatches: host ms to stage them, device ms
            # of their copies
            landed = base["dev_time"]["lora_onboard"]
            res["onboard_ms_per_adapter"] = round(
                base["lora_pool_onboard_ms"] / base["lora_pool_onboard_count"], 3)
            res["onboard_device_ms"] = round(landed["seconds"] * 1000.0, 3)
            res["onboard_landings"] = landed["count"]
            res["solo"] = await solo_streams(engine, [lreqs[i] for i in lora_idx])
            stack = engine._lora_pool.stack
            total_launches = launches
        await engine.close()
        del engine
        gc.collect()
        torch.cuda.empty_cache()
        arms[arm] = res
    b, lr = arms["base"]["streams"], arms["lora"]["streams"]
    for i, n in enumerate(LORA_OF):
        if n is None:
            assert lr[i] == b[i], f"lora: base request {i} differs from the plain engine's stream"
        else:
            assert lr[i] != b[i], f"lora: the adapter {n} did not change request {i}"
    solo = arms["lora"].pop("solo")
    batched = [lr[i] for i in lora_idx]
    div = lora_divergences("lora", params, cfg, stack, [lreqs[i] for i in lora_idx], solo,
                           batched, LORA_GAP_ULPS)
    for arm in arms.values():
        arm.pop("streams")
    emit("lora", model="llama-3.2-3b", layers=LORA_LAYERS, dtype="bfloat16",
         decode_pool_mode="scatter", kv_quant="none", lora_pool_slots=LORA_SLOTS,
         adapters={ad.name: {"rank": ad.rank, "scale": ad.scale} for ad in adapters},
         requests=len(reqs), lora_of=LORA_OF, prompt_tokens=LORA_LENGTHS, max_tokens=MAX_TOKENS,
         base_streams_equal=LORA_OF.count(None), lora_streams_changed=len(lora_idx),
         solo_equal=sum(a == b for a, b in zip(solo, batched)), gap_bound_ulps=LORA_GAP_ULPS,
         divergences=div,
         block_ms_per_dispatch={
             "lora": arms["lora"]["dev_time"].get("block_lora", {}).get("ms_per_dispatch"),
             "plain": arms["base"]["dev_time"].get("block", {}).get("ms_per_dispatch")},
         arms=arms)
    return total_launches


@torch.no_grad()
def lora_f32(seed: int, params, adapters) -> None:
    """At 4 layers in f32: the three LoRA forwards with the adapter stack on
    the card (kernels) against the same on the CPU (plain attention), and
    LoRA streams beside others exactly equal to their solo runs."""
    from dynamo_tpu_torch.models import lora as lora_mod

    L = LORA_SMALL_LAYERS
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=L, dtype=torch.float32)
    p_dev = {k: None if v is None else (
        {n: x[:L].float() for n, x in v.items()} if k == "layers" else v.float())
        for k, v in params.items()}
    p_cpu = {k: None if v is None else (
        {n: x.cpu() for n, x in v.items()} if k == "layers" else v.cpu())
        for k, v in p_dev.items()}
    ads = [cut_adapter(a, L, torch.float32) for a in adapters]
    rng = np.random.default_rng(seed + 31)
    ps, pages = 64, 6
    toks = rng.integers(5, cfg.vocab_size - 1, size=(2, 32))
    pos = np.tile(np.arange(32), (2, 1))
    pos[1, 21:] = 3 * ps - 1  # lane 1's pads: the tables' scratch column
    tables = [[1, 2, 0], [3, 4, 0]]
    # ragged: lane 0's next 8 tokens (ctx 33) and lane 1's next token (ctx
    # 22), padded to 16 flat tokens on a padding row
    flat = np.zeros(16, np.int64)
    flat[:8], flat[8] = toks[0, :8], 11
    rpos = np.full(16, 3 * ps - 1)
    rpos[:8], rpos[8] = 33 + np.arange(8), 22
    row_ids = np.full(16, 2)
    row_ids[:8], row_ids[8] = 0, 1
    out = {}
    for d, prm in ((DEV, p_dev), ("cpu", p_cpu)):
        stack = lora_mod.stack_adapters(cfg, ads, device=d)
        k, v = (torch.zeros((L, pages, ps, cfg.num_kv_heads, cfg.head_dim), device=d)
                for _ in range(2))

        def t(x):
            return torch.as_tensor(np.asarray(x), dtype=torch.int32, device=d)

        def op(idx):
            return dict(stack, idx=t(idx))

        lp, _, _ = llama.prefill_forward_batched(
            prm, cfg, t(toks), t(pos), k, v, t(tables), t([0, 0]), t([31, 20]), lora=op([1, 0]))
        ld, _, _ = llama.decode_forward(prm, cfg, t([7, 9]), t([32, 21]), k, v, t(tables),
                                        t([33, 22]), lora=op([2, 3]))
        lr, _, _ = llama.ragged_forward(
            prm, cfg, t(flat), t(rpos), t(row_ids), k, v, t(tables + [[0, 0, 0]]),
            t([0, 8, 16]), t([8, 1, 0]), t([33, 22, 0]), t([7, 8, 0]), lora=op([3, 1, 0]))
        out[d] = {"prefill": lp, "decode": ld, "ragged": lr[:2]}
    errs = {}
    for name in out["cpu"]:
        errs[name] = row_rel_err(out[DEV][name].cpu(), out["cpu"][name])
        assert errs[name] < TOL_LORA_F32_REL, f"lora_f32: {name} card vs CPU {errs[name]}"

    async def streams():
        """6 requests (4 LoRA) together, then each alone, on one f32 engine."""
        engine = TorchEngine(EngineConfig(model="llama3-3b", seed=seed),
                             model_config=cfg, params=p_dev, device="cuda")
        engine.register_adapters(ads)
        reqs, _ = make_requests(seed + 5, cfg.vocab_size, [60, 700, 200, 1100, 90, 400],
                                shared_idx=(), seeded_idx=(), tag="lora-f32")
        names = ["peft8", None, "peft16", "rnd", None, "peft8"]
        reqs = [dict(r, lora_name=n) if n else r for r, n in zip(reqs, names)]
        recs, _ = await together_records(engine, reqs)
        solo = await solo_streams(engine, reqs)
        await engine.close()
        return [r["tokens"] for r in recs], solo

    got, solo = asyncio.run(streams())
    equal = sum(a == b for a, b in zip(got, solo))
    assert equal == len(solo), f"lora_f32: {len(solo) - equal} streams differ from their solo runs"
    emit("lora_f32", model="llama-3.2-3b", layers=L, dtype="float32",
         forward_row_rel_err={k: float(f"{v:.3g}") for k, v in errs.items()},
         tol_row_rel=TOL_LORA_F32_REL, streams_equal_solo=equal, requests=len(solo))
    del p_dev, p_cpu, out
    gc.collect()
    torch.cuda.empty_cache()


async def lora_pool(seed: int, params, adapters) -> None:
    """One slot, three adapters: a hit, a miss with an eviction, a refusal
    while the slot is pinned, an injected `lora.onboard` error, a clean
    onboard, then a cold onboard admitted beside a live base stream (its
    gaps between tokens are reported), driven through the engine; the
    pool's counters must equal those of the port's pool driven by the same
    script on the CPU."""
    from dynamo_tpu_torch.llm.protocols import Annotated
    from dynamo_tpu_torch.models.lora_pool import LoraPool, LoraPoolError
    from dynamo_tpu_torch.runtime import faults

    L = LORA_SMALL_LAYERS
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=L)
    ads = [cut_adapter(a, L, cfg.dtype) for a in adapters]
    engine = TorchEngine(EngineConfig(model="llama3-3b", seed=seed, lora_pool_slots=1),
                         model_config=cfg, params=cut_depth(params, L), device="cuda")
    engine.register_adapters(ads)
    reqs, _ = make_requests(seed + 9, cfg.vocab_size, [100] * 8, shared_idx=(), seeded_idx=(),
                            tag="lora-pool")
    reqs[6]["stop_conditions"] = {"max_tokens": 8 * MAX_TOKENS, "ignore_eos": True}

    async def ask(i, name, started=None):
        toks, err = [], []
        async for item in engine.generate(dict(reqs[i], lora_name=name), Context()):
            if item.get("event") == "error":
                err.append(item)
            toks += (item.get("data") or {}).get("token_ids") or []
            if started is not None:
                started.set()
        return toks, err

    log = []
    toks, err = await ask(0, "peft8")  # resident since registration: a hit
    log.append(("peft8", len(toks), len(err)))
    toks, err = await ask(1, "peft16")  # a miss: evicts peft8
    log.append(("peft16", len(toks), len(err)))
    started = asyncio.Event()
    hold = asyncio.create_task(ask(2, "peft16", started))  # pins peft16
    await started.wait()
    toks, err = await ask(3, "rnd")  # the slot is pinned: refused
    log.append(("rnd", len(toks), len(err)))
    pinned_err = err[0]
    await hold
    faults.configure("lora.onboard:error,times=1")
    try:
        toks, err = await ask(4, "peft8")  # a miss whose onboard fails
    finally:
        faults.reset()
    log.append(("peft8-fault", len(toks), len(err)))
    toks, err = await ask(5, "peft8")  # onboards
    log.append(("peft8", len(toks), len(err)))

    async def arrivals(i, mid):
        times = []
        async for item in engine.generate(dict(reqs[i]), Context()):
            if (item.get("data") or {}).get("token_ids"):
                times.append(time.perf_counter())
                if len(times) == 16:
                    mid.set()
        return times

    mid = asyncio.Event()
    live = asyncio.create_task(arrivals(6, mid))  # a base stream: holds no pin
    await mid.wait()
    t_cold = time.perf_counter()
    toks, err = await ask(7, "peft16")  # cold: evicts peft8, onboards beside it
    log.append(("peft16-live", len(toks), len(err)))
    times = await live
    gaps = np.diff(np.array(times)) * 1000.0
    across = next(g for t, g in zip(times[1:], gaps) if t > t_cold)
    stats = engine.stats()
    pins = engine._lora_pool.pinned()
    await engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()

    # the same script on the port's pool on the CPU
    cpu = LoraPool(cfg, ads, slots=1, device="cpu")
    want_err = None
    for step in ("peft8", "peft16", "hold", "rnd", "release", "fault", "peft8", "peft16"):
        if step == "hold":
            cpu.acquire("peft16")
        elif step == "release":
            cpu.release("peft16")
        elif step == "rnd":
            try:
                cpu.acquire("rnd")
            except LoraPoolError as e:
                want_err = Annotated.from_error(str(e)).to_dict()
        elif step == "fault":
            faults.configure("lora.onboard:error,times=1")
            try:
                cpu.acquire("peft8")
            except LoraPoolError:
                pass
            finally:
                faults.reset()
        else:
            cpu.acquire(step)
            cpu.release(step)
    got = {k: v for k, v in stats.items() if k.startswith("lora_pool_") and "_ms" not in k}
    want = {k: v for k, v in cpu.stats().items() if "_ms" not in k}
    assert got == want, f"lora_pool: the engine's pool counters {got} differ from the CPU's {want}"
    assert pinned_err == want_err, (pinned_err, want_err)
    assert [x[1:] for x in log] == [(MAX_TOKENS, 0), (MAX_TOKENS, 0), (0, 1), (0, 1),
                                    (MAX_TOKENS, 0), (MAX_TOKENS, 0)], log
    assert pins == 0, f"lora_pool: {pins} pins leaked"
    emit("lora_pool", model="llama-3.2-3b", layers=L, lora_pool_slots=1,
         script=[x[0] for x in log], counters=got, counters_equal_cpu=True, pins_after=pins,
         onboard_ms=stats["lora_pool_onboard_ms"], onboard_count=stats["lora_pool_onboard_count"],
         onboard_device_ms=round(stats["dev_time"]["lora_onboard"]["seconds"] * 1000.0, 3),
         live_gap_p50_ms=round(float(np.median(gaps)), 3),
         live_gap_max_ms=round(float(gaps.max()), 3), live_gap_across_cold_ms=round(across, 3))


def lora_all(seed: int, params) -> dict:
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="smoke_lora_")
    try:
        adapters = lora_adapters(llama.LlamaConfig.llama3_2_3b(), root)
        launches = asyncio.run(lora_main(seed, params, adapters))
        lora_f32(seed, params, adapters)
        asyncio.run(lora_pool(seed, params, adapters))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------- #
# phases: moe_mlp, moe_serve, moe_local_int8, gptoss, moe_worker (the
# sparse-MoE family: models/moe.py, the llama attention over the same four
# kernels with the top-k capacity-bounded expert MLP)
# ---------------------------------------------------------------------- #

MOE_MLP_TOKENS = (64, 2048)  # a decode batch, and a prefill chunk
MOE_LOCAL_LAYERS = 4
GPTOSS_LAYERS = 2
MOE_WORKER_LAYERS = 2
MOE_WORKER_LENGTHS = [40, 300, 700, 120]
MOE_PROFILE_STEPS = 2  # the profiled decode steps (each ~0.17 s at int8 Mixtral width)
GPTOSS_LENGTHS = SERVE_LENGTHS[:8]
# The MoE serve phases run no seeded pair: an idle decode lane's stale token
# takes expert capacity like any token (as in the reference), so a stream's
# tokens may depend on what the engine ran before it.
TOL_MOE_MLP = 2e-3  # f32, card against CPU: the summation order differs
# One decode step at a model's depth, kernels against plain attention, with
# the kernel run's routing replayed in the plain run (so the attention is
# all that differs), per row |a - b|_2 / |b|_2 of the logits: each layer's
# bf16 attention output rounds at other places (TOL_FORWARD_REL at 2
# layers), and the differences add up through the residual stream as a
# random walk: TOL_FORWARD_REL * sqrt(layers / 2).
def tol_moe_forward(layers: int) -> float:
    return TOL_FORWARD_REL * (layers / 2) ** 0.5



def moe_mlp_layer(cfg, gen) -> dict:
    """One layer's MoE MLP leaves in f32 on the card, drawn from `gen` at
    the init's scale (the router and the expert stacks)."""
    E, H, I = cfg.num_experts, cfg.hidden_size, cfg.intermediate_size

    def draw(*shape):
        return torch.randn(shape, generator=gen, device=DEV) * 0.02

    return {"mlp_norm": torch.ones(H, device=DEV), "router": draw(H, E),
            "w_gate": draw(E, H, I), "w_up": draw(E, H, I), "w_down": draw(E, I, H)}


def kept_set(layer, x, cfg) -> set:
    """The (token, expert, slot) triples moe_mlp keeps for tokens x."""
    h = moe.rms_norm(x, layer["mlp_norm"], cfg.rms_norm_eps)
    topi, _, kept, slot = moe.route(h, layer["router"], cfg)
    C = moe.expert_capacity(x.shape[0], cfg)
    t, k = torch.nonzero(kept, as_tuple=True)
    return set(zip(t.tolist(), topi[t, k].tolist(), (slot[t, k] % C).tolist()))


@torch.no_grad()
def phase_moe_mlp(seed: int) -> None:
    """One Mixtral-width MoE MLP layer in f32 on the card against the same
    inputs on the CPU, at a decode batch and a prefill chunk whose tokens
    share a direction, so the two favoured experts overflow their capacity
    (factor 1.25) and tokens drop: equal kept sets, outputs within
    TOL_MOE_MLP."""
    cfg = moe.MoeConfig.mixtral_8x7b(dtype=torch.float32, num_layers=1)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 14)
    layer = moe_mlp_layer(cfg, gen)
    host = {k: v.cpu() for k, v in layer.items()}
    cases = {}
    for T in MOE_MLP_TOKENS:
        base = torch.randn((1, cfg.hidden_size), generator=gen, device=DEV)
        x = base + 0.3 * torch.randn((T, cfg.hidden_size), generator=gen, device=DEV)
        got = moe.moe_mlp(layer, x, cfg)
        t0 = time.perf_counter()
        want = moe.moe_mlp(host, x.cpu(), cfg)
        cpu_s = time.perf_counter() - t0
        kept = kept_set(layer, x, cfg)
        assert kept == kept_set(host, x.cpu(), cfg), f"moe_mlp T={T}: the kept sets differ"
        err = max_err(got.cpu(), want)
        assert err <= TOL_MOE_MLP, f"moe_mlp T={T}: {err} > {TOL_MOE_MLP}"
        cases[f"T{T}"] = {
            "capacity": moe.expert_capacity(T, cfg), "kept": len(kept),
            "dropped": T * cfg.num_experts_per_tok - len(kept), "max_abs_err": err,
            "ms": round(time_ms(lambda: moe.moe_mlp(layer, x, cfg), warm=1, reps=5), 3),
            "cpu_s": round(cpu_s, 2)}
    assert all(c["dropped"] > 0 for c in cases.values()), f"moe_mlp: nothing dropped: {cases}"
    emit("moe_mlp", model="mixtral-8x7b", layers=1, dtype="float32",
         capacity_factor=cfg.capacity_factor, tol=TOL_MOE_MLP, kept_sets_equal=True, cases=cases)


@torch.no_grad()
def moe_kernels_vs_plain(engine, lanes: int = 8) -> dict:
    """One decode step of `engine`'s model on its served pool (pages 1..,
    whatever serving left there), through the kernels and through the
    plain attention, the second replaying the first's routing (moe.route),
    so only the attention differs: the logits' largest row error. Under
    decode_pool_mode="local" the step is decode_forward_local (pool read
    only, block-local rows at slot 0). Also reported: the same pair with
    each run routing by itself (a near-tie in any layer's router may then
    pick another expert), as argmax agreement."""
    cfg, model = engine.model_config, engine._model
    ps = engine.config.page_size
    per = 6  # pages a lane
    lens = torch.tensor([ps * per - 1 - b * (ps * per // (2 * lanes)) for b in range(lanes)],
                        dtype=torch.int32, device=DEV)
    tables = (1 + torch.arange(lanes * per, device=DEV, dtype=torch.int32)).reshape(lanes, per)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(7)
    toks = torch.randint(5, cfg.vocab_size, (lanes,), generator=gen, device=DEV,
                         dtype=torch.int32)
    local = engine.config.decode_pool_mode == "local"

    def step(plain: bool):
        if local:
            loc = torch.zeros((2, cfg.num_layers, lanes, 1, cfg.num_kv_heads, cfg.head_dim),
                              dtype=cfg.dtype, device=DEV)
            return model.decode_forward_local(
                engine.params, cfg, toks, lens - 1, loc[0], loc[1],
                torch.zeros(1, dtype=torch.int32, device=DEV), engine.kv_k, engine.kv_v,
                tables, lens - 1, plain_attention=plain)[0]
        return model.decode_forward(engine.params, cfg, toks, lens - 1, engine.kv_k,
                                    engine.kv_v, tables, lens, plain_attention=plain)[0]

    routes, orig = [], moe.route

    def record(*args):
        routes.append(orig(*args))
        return routes[-1]

    try:
        moe.route = record
        kern = step(False)
        moe.route = lambda *args: routes.pop(0)
        replayed = step(True)
        assert not routes, "the plain step routed another number of times"
        moe.route = orig
        own = step(True)
    finally:
        moe.route = orig
    max_err(kern, replayed)  # finite
    err, tol = row_rel_err(kern, replayed), tol_moe_forward(cfg.num_layers)
    assert err <= tol, f"MoE decode step: kernels vs plain {err} > {tol}"
    return {"lanes": lanes, "ctx": lens.tolist(), "tol_rel": round(tol, 4),
            "max_row_rel_err_same_routing": round(err, 6),
            "argmax_equal_own_routing": int((kern.argmax(-1) == own.argmax(-1)).sum()),
            "max_row_rel_err_own_routing": round(row_rel_err(kern, own), 6)}


async def moe_serve(seed: int) -> dict:
    """Mixtral-8x7B at full width and depth, int8 weights drawn and
    quantized on the card one matrix at a time, a bf16 KV pool auto-sized
    in the room left, scatter pool, mixed on: the serve mix; then the
    kernels against plain attention on one decode step of the served
    pool, and the decode step profiled on the same weights (busy ms,
    launches and wall against the bound of reading the weights once, the
    share spent widening int8 to bf16)."""
    cfg = moe.MoeConfig.mixtral_8x7b()
    held = {}

    def check(engine):
        held["params"] = engine.params
        return {"kernels_vs_plain": moe_kernels_vs_plain(engine)}

    launches = await serve(seed, "moe_serve", "scatter", "none", cfg.num_layers, None,
                           model="mixtral-8x7b", quantize="int8", seeded_pair=False,
                           before_close=check, num_pages=0)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    prof = decode_profile.profile(held.pop("params"), cfg, steps=MOE_PROFILE_STEPS)
    emit("moe_decode_step", model="mixtral-8x7b", profile_s=round(time.perf_counter() - t0, 2),
         **prof)
    gc.collect()
    torch.cuda.empty_cache()
    return launches


async def moe_local_int8(seed: int) -> dict:
    """Mixtral-8x7B at MOE_LOCAL_LAYERS layers, bf16 weights, the local
    pool over int8 KV: the serve mix, and the local step's kernels against
    plain attention on the served pool."""
    return await serve(seed, "moe_local_int8", "local", "int8", MOE_LOCAL_LAYERS, None,
                       model="mixtral-8x7b", seeded_pair=False,
                       before_close=lambda e: {"kernels_vs_plain": moe_kernels_vs_plain(e)})


async def gptoss(seed: int) -> dict:
    """gpt-oss-120b's widths at GPTOSS_LAYERS layers, bf16: top-4 of 128
    experts, and D=64 with 8 query heads a KV head through the kernels: 8
    requests, and a decode step's kernels against plain attention."""
    return await serve(seed, "gptoss", "scatter", "none", GPTOSS_LAYERS, None,
                       model="gptoss-120b", lengths=GPTOSS_LENGTHS, seeded_pair=False,
                       before_close=lambda e: {"kernels_vs_plain": moe_kernels_vs_plain(e)})


async def moe_worker_checkpoint(seed: int) -> dict:
    """Mixtral-8x7B's first MOE_WORKER_LAYERS layers (bf16, random from the
    seed) written as a BF16 Mixtral-named safetensors checkpoint whose
    config.json says that depth, and each request of a 4-request mix alone
    on an in-process int8 engine of the same weights: the streams the CLI
    worker (weights_load_subprocess, phase moe_worker) must reproduce."""
    import os
    import tempfile

    cfg = moe.MoeConfig.mixtral_8x7b(num_layers=MOE_WORKER_LAYERS)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(seed + 21)
    params = moe.init_params(cfg, gen, device=DEV)
    # the checkpoint stores every tensor in BF16, the router too (as
    # Mixtral's published files do): the in-process weights carry its rounding
    params["layers"]["router"] = params["layers"]["router"].to(torch.bfloat16).float()
    d = tempfile.mkdtemp(prefix="smoke_moe_ckpt_")
    t0 = time.perf_counter()
    files = loader.save_moe_as_hf(params, cfg, d, dtype=torch.bfloat16,
                                  max_shard_bytes=LOAD_SHARD_BYTES)
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "mixtral", "num_hidden_layers": cfg.num_layers,
                   "hidden_size": cfg.hidden_size, "intermediate_size": cfg.intermediate_size,
                   "num_attention_heads": cfg.num_heads, "num_key_value_heads": cfg.num_kv_heads,
                   "vocab_size": cfg.vocab_size, "num_local_experts": cfg.num_experts,
                   "num_experts_per_tok": cfg.num_experts_per_tok,
                   "tie_word_embeddings": cfg.tie_embeddings}, f)
    write_s = time.perf_counter() - t0
    on_disk = sum(os.path.getsize(os.path.join(d, fn)) for fn in files)
    qparams = quantize_tree(params, consume=True)
    del params
    reqs, _ = make_requests(seed, cfg.vocab_size, MOE_WORKER_LENGTHS, shared_idx=(1, 3),
                            seeded_idx=(2,), tag="moe_worker")
    engine = TorchEngine(EngineConfig(model="mixtral-8x7b", seed=seed, quantize="int8"),
                         model_config=cfg, params=qparams, device="cuda")
    del qparams
    await engine.warmup()

    async def local_stream(r):
        return engine.generate(r, Context())

    async def local_clear():
        engine.clear_kv_blocks()

    streams = await alone(local_stream, local_clear, reqs)
    await engine.close()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    emit("moe_worker_checkpoint", model="mixtral-8x7b", layers=cfg.num_layers,
         checkpoint_dtype="BF16", files=files, checkpoint_bytes=on_disk,
         write_s=round(write_s, 3))
    return {"dir": d, "reqs": reqs, "streams": streams, "model": "mixtral-8x7b",
            "shared": (1, 3), "phase": "moe_worker", "label": "mixtral-8x7b",
            "layers": cfg.num_layers}


async def moe_all(seed: int) -> dict:
    """The MoE phases in the card's room (the smoke's Llama weights freed),
    each engine closed and freed before the next; the CLI worker's
    checkpoint and reference streams for moe_worker are made here too.
    Returns (launches of the served MoE traffic, the moe_worker load)."""
    total: dict = {}
    phase_moe_mlp(seed)
    gc.collect()
    torch.cuda.empty_cache()
    for fn in (moe_serve, moe_local_int8, gptoss):
        add_launches(total, await fn(seed))
        gc.collect()
        torch.cuda.empty_cache()
    return total, await moe_worker_checkpoint(seed)


# ---------------------------------------------------------------------- #
# phases: vit, mm_serve, mm_worker (multimodal E/P/D)
# ---------------------------------------------------------------------- #

F32_FLOPS = 67e12  # H100 SXM float32 rate outside the tensor cores (data sheet)
TOL_VIT = 2e-3  # f32 ViT-Base + projector, card against CPU (TF32 off)
MM_IMAGE_SIZES = [(224, 224), (320, 240), (640, 480), (96, 128)]  # (width, height)
# the mm_serve mix: (kind, text tokens, images) in arrival order; "repeat"
# sends request `n` again exactly (once it has its first token), "swap"
# sends request `n`'s text with other images
MM_MIX = [("image", 40, [0]), ("text", 300, []), ("image", 120, [1, 2]),
          ("image", 700, [3]), ("text", 64, []), ("repeat", 0, []), ("image", 220, [0, 3]),
          ("text", 500, []), ("swap", 3, [1]), ("repeat", 2, []), ("text", 40, []),
          ("image", 600, [2])]
MM_WORKER_MIX = [(40, [0]), (300, [2]), (120, [1, 3]), (64, [3])]
MM_WORKER_PAGES = 1024


def write_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG written with zlib, its rows cycling through the five
    filter types, so a decode undoes every one."""
    import struct
    import zlib

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    h, w, _ = rgb.shape
    raw = rgb.reshape(h, -1).astype(np.int32)
    out, prior = bytearray(), np.zeros(raw.shape[1], np.int32)
    zero3 = np.zeros(3, np.int32)
    for y in range(h):
        f, row = y % 5, raw[y]
        left = np.concatenate([zero3, row[:-3]])
        upleft = np.concatenate([zero3, prior[:-3]])
        if f == 4:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        else:
            pred = [np.zeros_like(row), left, prior, (left + prior) >> 1][f]
        out.append(f)
        out += ((row - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = row
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(out))) + chunk(b"IEND", b""))


def mm_images(seed: int) -> list:
    """(RGB array, PNG bytes, data URL) of each MM_IMAGE_SIZES image: smooth
    colour fields with noise, from the seed."""
    import base64

    rng = np.random.default_rng(seed + 16)
    out = []
    for w, h in MM_IMAGE_SIZES:
        y, x = np.mgrid[0:h, 0:w]
        ph = rng.uniform(0, 6.3, size=3)
        rgb = np.stack([127 + 90 * np.sin(x / rng.uniform(9, 40) + ph[c])
                        * np.cos(y / rng.uniform(9, 40)) for c in range(3)], -1)
        rgb = np.clip(rgb + rng.normal(0, 12, size=rgb.shape), 0, 255).astype(np.uint8)
        png = write_png(rgb)
        out.append((rgb, png, "data:image/png;base64," + base64.b64encode(png).decode()))
    return out


def vit_flops(cfg) -> float:
    """Products of one image through the ViT and its projector (2 a MAC)."""
    N, T, H, I, O = cfg.n_patches, cfg.n_patches + 1, cfg.hidden_size, cfg.intermediate_size, \
        cfg.out_hidden
    layer = 2 * T * H * H * 4 + 2 * 2 * T * T * H + 2 * 2 * T * H * I
    return (2 * N * cfg.num_channels * cfg.patch_size ** 2 * H + cfg.num_layers * layer
            + 2 * N * H * O + 2 * N * O * O)


def vit_encoder(seed: int, device):
    """ViT-Base/16 at 224 px with its projector to Llama-3.2-3B's width, the
    weights from `seed` (a CPU generator: the same on every device)."""
    from dynamo_tpu_torch.llm.multimodal import ViTEncoder
    from dynamo_tpu_torch.models.vit import ViTConfig

    return ViTEncoder(config=ViTConfig(), llm_hidden=llama.LlamaConfig.llama3_2_3b().hidden_size,
                      device=device, seed=seed)


def vit_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in vit_leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in vit_leaves(v)]
    return [tree]


def phase_vit(seed: int):
    """ViT-Base + projector in f32 on the card against the port's CPU forward
    on the same weights and pixels (TOL_VIT), its forward timed at B=1
    beside its bound, and a 640x480 PNG's decode and resize timed. Returns
    the card's encoder."""
    from dynamo_tpu_torch.llm import image_io
    from dynamo_tpu_torch.llm.multimodal import ViTEncoder
    from dynamo_tpu_torch.models import vit

    assert torch.get_float32_matmul_precision() == "highest"  # TF32 off
    t0 = time.perf_counter()
    cpu = vit_encoder(seed, "cpu")
    init_s = time.perf_counter() - t0
    cfg = cpu.config
    card = ViTEncoder(config=cfg, params=vit.to_device(cpu.params, DEV), device="cuda")
    px = np.random.default_rng(seed).standard_normal(
        (1, cfg.num_channels, cfg.image_size, cfg.image_size), dtype=np.float32)
    t0 = time.perf_counter()
    want = cpu._fwd(torch.from_numpy(px))
    cpu_s = time.perf_counter() - t0
    px_dev = torch.from_numpy(px).to(DEV)
    got = card._fwd(px_dev)
    err = max_err(got, want.to(DEV))
    assert got.shape == (1, cfg.n_patches, cfg.out_hidden) and torch.isfinite(got).all()
    assert err <= TOL_VIT, f"vit: the card's encoder is {err} from the CPU's"
    ms = time_ms(lambda: card._fwd(px_dev))
    flops = vit_flops(cfg)
    n_params = sum(t.numel() for t in vit_leaves(card.params))
    bytes_moved = 4 * (n_params + px.size + cfg.n_patches * cfg.out_hidden)
    bound_ms = max(bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS) * 1e3
    rgb, png, _ = mm_images(seed)[2]  # 640 x 480
    assert np.array_equal(image_io.decode_png(png), rgb)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        image_io.load_rgb(png, cfg.image_size)
        times.append(time.perf_counter() - t0)
    emit("vit", config="vit-base-16-224", layers=cfg.num_layers, hidden=cfg.hidden_size,
         out_hidden=cfg.out_hidden, dtype="float32", tf32=False, params=n_params,
         init_s=round(init_s, 3), max_abs_err=err, tol=TOL_VIT, cpu_forward_s=round(cpu_s, 3),
         forward_ms_b1=round(ms, 4), gflop=round(flops / 1e9, 2),
         bound_ms=round(bound_ms, 4), bound_by="operations" if flops / F32_FLOPS
         > bytes_moved / HBM_BYTES_PER_S else "bytes", tflops=round(tflops(flops, ms), 2),
         png_bytes=len(png), png_size=list(rgb.shape[1::-1]),
         decode_resize_ms=round(1e3 * min(times), 2),
         decode_resize_ms_mean=round(1e3 * sum(times) / len(times), 2))
    return card


class LocalEncodeRouter:
    """The encode endpoint in process: the encode worker's handler on
    `encoder` behind a router's `generate`. Keeps each call's seconds and
    parts."""

    def __init__(self, encoder):
        self.encoder = encoder
        self.calls = []

    async def generate(self, request, context=None):
        from dynamo_tpu_torch.llm.multimodal import encode_parts

        parts = request.get("multimodal") or []
        t0 = time.perf_counter()
        encoded = encode_parts(parts, self.encoder)
        torch.cuda.synchronize()
        self.calls.append((time.perf_counter() - t0, len(parts)))

        async def stream():
            yield {"data": {"multimodal": encoded, "n_tokens": self.encoder.n_tokens}}

        return stream()


def mm_logits(params: dict, cfg, token_ids: list, parts: list, plain: bool = False):
    """The logits after `token_ids` (one batched-prefill forward on a fresh
    pool, the parts' rows spliced over their placeholders), f32 [vocab]."""
    from dynamo_tpu_torch.engine.kv_cache import alloc_kv_arrays

    T, ps = len(token_ids), 64
    P = -(-T // ps)
    kv_k, kv_v = alloc_kv_arrays(cfg.num_layers, P + 1, ps, cfg.num_kv_heads, cfg.head_dim,
                                 dtype=cfg.dtype, device=DEV)
    emb = np.zeros((1, T, cfg.hidden_size), np.float32)
    mask = np.zeros((1, T), bool)
    for p in parts:
        pos, arr = int(p["position"]), np.asarray(p["embedding"], np.float32)
        n = max(0, min(len(arr), T - pos))
        emb[0, pos:pos + n] = arr[:n]
        mask[0, pos:pos + n] = True
    with torch.no_grad():
        out = llama.prefill_forward_batched(
            params, cfg, i32([token_ids]), i32([list(range(T))]), kv_k, kv_v,
            i32([list(range(1, P + 1))]), i32([0]), i32([T - 1]), plain_attention=plain,
            emb_override=torch.from_numpy(emb).to(DEV), emb_mask=torch.from_numpy(mask).to(DEV))
    return out[0][0].float()


def near_tie(phase: str, params, cfg, req: dict, a: list, b: list) -> dict:
    """Where two streams of one request part: the plain logits' top-two gap
    there, which must be within SPEC_GAP_ULPS bf16 ulps of the top."""
    p = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    logits = mm_logits(params, cfg, list(req["token_ids"]) + a[:p], req["multimodal"])
    top = torch.topk(logits, 2)
    hi, lo = (float(x) for x in top.values)
    ulp = 2.0 ** (np.floor(np.log2(max(abs(hi), 1e-30))) - MANTISSA_BITS[cfg.dtype])
    rep = {"request": req["request_id"], "position": p, "tokens": [a[p], b[p]],
           "gap_ulps": (hi - lo) / ulp}
    assert sorted((a[p], b[p])) == sorted(int(x) for x in top.indices) \
        and rep["gap_ulps"] <= SPEC_GAP_ULPS[cfg.dtype], f"{phase}: streams part at no near-tie: {rep}"
    return rep


async def mm_serve(seed: int, params, encoder) -> dict:
    """Llama-3.2-3B at 28 layers (bf16, scatter, mixed on) behind the
    in-process ViT-Base: MM_MIX's 8 image requests, each stamped first by
    EncodeOperator (decode, ViT, splice; timed a part, one at a time), and
    4 text requests, staggered into the engine (TTFT is the engine's: the
    encoder would share this process's host thread and GIL with the
    engine's, which no deployment does); the checks are in the module
    docstring."""
    from dynamo_tpu_torch.llm.multimodal import EncodeOperator
    from dynamo_tpu_torch.runtime import msgpack_lite

    cfg = llama.LlamaConfig.llama3_2_3b()
    engine = TorchEngine(EngineConfig(model="llama3-3b", seed=seed, decode_pool_mode="scatter",
                                      kv_quant="none"),
                         model_config=cfg, params=params, device="cuda")
    t0 = time.perf_counter()
    await engine.warmup()
    warm_s = time.perf_counter() - t0
    images = mm_images(seed)
    _, text = make_requests(seed, cfg.vocab_size, [], (), (), "mm")
    reqs, kinds = [], []
    for i, (kind, n, imgs) in enumerate(MM_MIX):
        if kind == "repeat":
            req = dict(reqs[n], request_id=f"mm-{i}")
        elif kind == "swap":
            req = dict(reqs[n], request_id=f"mm-{i}",
                       multimodal=[{"type": "image_url", "url": images[j][2]} for j in imgs])
        else:
            req = PreprocessedRequest(token_ids=text(n, 300 + i), request_id=f"mm-{i}",
                                      stop_conditions={"max_tokens": MAX_TOKENS}).to_dict()
            if imgs:
                req["multimodal"] = [{"type": "image_url", "url": images[j][2]} for j in imgs]
        reqs.append(req)
        kinds.append("text" if kind == "text" else "image")
    router = LocalEncodeRouter(encoder)
    op = EncodeOperator(router, vocab_size=cfg.vocab_size)
    stamped = [await op.forward(dict(req), None) for req in reqs]

    reset_counts()
    base = engine.stats()
    records = [new_record() for _ in reqs]
    t_start = time.perf_counter()
    tasks = []
    for i, rec in enumerate(records):
        kind, n, _ = MM_MIX[i]
        after = records[n]["first"] if kind == "repeat" else None
        tasks.append(asyncio.create_task(run_request(engine, stamped[i], rec, after)))
        await asyncio.sleep(STAGGER_S)
    await asyncio.gather(*tasks)
    wall = time.perf_counter() - t_start
    launches = kernel_launches()
    plain = dict(pa.plain_calls)
    stats = engine.stats()
    for i, rec in enumerate(records):
        assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, (i, rec["finish"])
    check_path_launches("mm_serve", launches, plain, "scatter", "none")

    # the repeats: the first run's stream (or a part at a near-tie), and,
    # alone again, a prefix hit over every full page of the prompt: into
    # the last image, whose rows are then read from the cache
    repeats, ties = [], []
    for i, (kind, n, _) in enumerate(MM_MIX):
        if kind != "repeat":
            continue
        a, b = records[n]["tokens"], records[i]["tokens"]
        if a != b:
            ties.append(near_tie("mm_serve", params, cfg, stamped[n], a, b))
        hits0 = engine.stats()["kv_prefix_hit_blocks_total"]
        rec = new_record()
        await run_request(engine, dict(stamped[i], request_id=f"mm-{i}-alone"), rec)
        ps = engine.config.page_size
        cached = ps * (engine.stats()["kv_prefix_hit_blocks_total"] - hits0)
        L = len(stamped[i]["token_ids"])
        last = stamped[i]["multimodal"][-1]
        assert cached == L // ps * ps and cached > last["position"], (i, cached, L)
        if rec["tokens"] != a:
            ties.append(near_tie("mm_serve", params, cfg, stamped[n], a, rec["tokens"]))
        repeats.append({"request": i, "of": n, "equal": a == b, "prompt_tokens": L,
                        "cached_tokens": cached,
                        "image_span": [last["position"], last["position"] + last["n_tokens"]]})
    await engine.close()
    del engine

    # the same text with other images: other first-token logits
    swap = next(i for i, (k, _, _) in enumerate(MM_MIX) if k == "swap")
    orig = MM_MIX[swap][1]
    la = mm_logits(params, cfg, stamped[orig]["token_ids"], stamped[orig]["multimodal"])
    lb = mm_logits(params, cfg, stamped[swap]["token_ids"], stamped[swap]["multimodal"])
    logit_diff = float((la - lb).abs().max())
    assert logit_diff > 0, "mm_serve: other images gave the same logits"
    # one spliced prefill: the kernels against plain attention
    two = next(i for i, (k, _, im) in enumerate(MM_MIX) if len(im) == 2)
    kern = mm_logits(params, cfg, stamped[two]["token_ids"], stamped[two]["multimodal"])
    ref = mm_logits(params, cfg, stamped[two]["token_ids"], stamped[two]["multimodal"],
                    plain=True)
    kv_err = row_rel_err(kern[None], ref[None])
    assert kv_err <= tol_moe_forward(LAYERS), f"mm_serve: kernels {kv_err} from plain"

    part = stamped[0]["multimodal"][0]
    wire = msgpack_lite.packb({"data": {"multimodal": [dict(part, embedding=np.asarray(
        part["embedding"], np.float32).tolist())], "n_tokens": encoder.n_tokens}})
    n_parts = sum(p for _, p in router.calls)
    ttft = {k: [r["ttft_s"] for r, kk in zip(records, kinds) if kk == k] for k in ("image", "text")}
    emit("mm_serve", model="llama-3.2-3b", layers=LAYERS, dtype="bfloat16",
         encoder="vit-base-16-224 (f32, in process)", decode_pool_mode="scatter", kv_quant="none",
         requests={"image": kinds.count("image"), "text": kinds.count("text")},
         images=[list(s) for s in MM_IMAGE_SIZES], image_parts=n_parts,
         prompt_tokens=[len(s["token_ids"]) for s in stamped], max_tokens=MAX_TOKENS,
         warmup_s=round(warm_s, 3), wall_s=round(wall, 3),
         output_tok_s=round(sum(len(r["tokens"]) for r in records) / wall, 1),
         ttft_ms_p50={k: round(1e3 * pct(v, 50), 2) for k, v in ttft.items()},
         ttft_ms_p99={k: round(1e3 * pct(v, 99), 2) for k, v in ttft.items()},
         itl_ms_p50=round(1e3 * pct([x for r in records for x in r["itl_s"]], 50), 3),
         encode_ms_per_part=round(1e3 * sum(s for s, _ in router.calls) / n_parts, 2),
         wire_bytes_per_part=len(wire), repeats=repeats, near_ties=ties,
         swapped_image_logit_max_diff=round(logit_diff, 4),
         kernels_vs_plain_row_rel=round(kv_err, 5), tol=round(tol_moe_forward(LAYERS), 4),
         mixed_steps=stats["mixed_steps"] - base["mixed_steps"],
         prefix_hit_blocks=stats["kv_prefix_hit_blocks_total"] - base["kv_prefix_hit_blocks_total"],
         launches={f"{n}/{f}": c for (n, f), c in launches.items() if c}, plain_calls=plain,
         dev_time=dev_time_delta(stats, base))
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def check_alone_launches(phase: str, launches: dict, plain: dict) -> None:
    """Requests served one at a time (no mixed step, so no ragged launch):
    the prefill and decode kernels launched, no other, no plain call."""
    used = [("prefill_attention", "none"), ("paged_decode", "none")]
    assert all(launches.get(u, 0) > 0 for u in used), f"{phase}: a path kernel never launched: {launches}"
    assert sum(launches.values()) == sum(launches[u] for u in used), \
        f"{phase}: a kernel outside the path launched: {launches}"
    assert not any(plain.values()), f"{phase}: plain attention ran on the card's main path: {plain}"


async def mm_worker(seed: int, ckpt: str) -> dict:
    """`python -m dynamo_tpu_torch.encode_worker --encoder vit --vit-size base
    --model llama3-3b` and `python -m dynamo_tpu_torch.worker --model-path
    <the weights_load checkpoint>` (LOAD_LAYERS, bf16): MM_WORKER_MIX's 4
    image requests through the port's EncodeOperator and PushRouter to the
    encode worker, then each stamped request alone through a PushRouter to
    the worker. The streams must equal an in-process engine's on the same
    checkpoint and stamped requests, the wire's embeddings an in-process
    encoder's from the same seed; the hop's ms is split into decode,
    forward, pack (tolist included), unpack and the wire's rest. Returns
    the worker's kernel launches."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    from dynamo_tpu_torch.llm.kv_router.publisher import METRICS_TOPIC_FMT
    from dynamo_tpu_torch.llm.multimodal import EncodeOperator
    from dynamo_tpu_torch.runtime import (DiscoveryServer, DistributedRuntime, PushRouter,
                                          RuntimeConfig, msgpack_lite)

    server = DiscoveryServer(port=0)
    _, port = await server.start()
    disc = f"tcp://127.0.0.1:{port}"
    rcfg = RuntimeConfig.from_settings()
    rcfg.discovery_endpoint = disc
    drt = await DistributedRuntime.create(rcfg)
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root))
    cfg = dataclasses.replace(llama.LlamaConfig.llama3_2_3b(), num_layers=LOAD_LAYERS)
    images = mm_images(seed)
    _, text = make_requests(seed, cfg.vocab_size, [], (), (), "mmw")
    reqs = []
    for i, (n, imgs) in enumerate(MM_WORKER_MIX):
        req = PreprocessedRequest(token_ids=text(n, 400 + i), request_id=f"mmw-{i}",
                                  stop_conditions={"max_tokens": MAX_TOKENS}).to_dict()
        req["multimodal"] = [{"type": "image_url", "url": images[j][2]} for j in imgs]
        reqs.append(req)
    cmds = {"encoder": ["-m", "dynamo_tpu_torch.encode_worker", "--encoder", "vit",
                        "--vit-size", "base", "--model", "llama3-3b", "--discovery", disc],
            "worker": ["-m", "dynamo_tpu_torch.worker", "--model", "llama3-3b", "--model-path",
                       ckpt, "--num-pages", str(MM_WORKER_PAGES), "--seed", str(seed),
                       "--discovery", disc]}
    procs, logs = {}, {}
    try:
        cards = await drt.discovery.watch_prefix("v1/mdc/dynamo/backend/generate/")
        met_sub = await drt.discovery.subscribe(
            METRICS_TOPIC_FMT.format(namespace="dynamo", component="backend"))
        t0 = time.perf_counter()
        for name, cmd in cmds.items():
            logs[name] = tempfile.NamedTemporaryFile(prefix=f"torch_mm_{name}_", suffix=".log",
                                                     delete=False)
            procs[name] = subprocess.Popen([sys.executable, *cmd], cwd=root, env=env,
                                           stdout=logs[name], stderr=subprocess.STDOUT)

        def tail(name):
            return Path(logs[name].name).read_text()[-3000:]

        while True:
            ev = await cards.get(timeout=1.0)
            if ev is not None and ev.type == "put":
                break
            for name, proc in procs.items():
                if proc.poll() is not None:
                    raise RuntimeError(f"mm_worker: {name} exited {proc.poll()}: {tail(name)}")
            if time.perf_counter() - t0 > 600:
                raise RuntimeError("mm_worker: the worker never registered")
        t_reg = time.perf_counter() - t0
        enc_client = await drt.namespace("dynamo").component("encoder").endpoint("encode").client()
        await enc_client.wait_for_instances(120)
        t_enc = time.perf_counter() - t0
        client = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
        await client.wait_for_instances(30)
        op = EncodeOperator(PushRouter(enc_client), vocab_size=cfg.vocab_size)
        router = PushRouter(client)
        # the encode worker's first forward pays its CUDA and cuBLAS set-up
        t1 = time.perf_counter()
        await op.forward(dict(reqs[-1], request_id="mmw-warm"), None)
        first_hop_s = time.perf_counter() - t1
        stamped, hop_s = [], []
        for req in reqs:
            t1 = time.perf_counter()
            stamped.append(await op.forward(dict(req), None))
            hop_s.append(time.perf_counter() - t1)
        before = await latest_stats(met_sub)
        streams = []
        for req in stamped:
            rec = new_record()
            await run_stream(router.generate, req, rec)
            assert rec["finish"] == "length" and len(rec["tokens"]) == MAX_TOKENS, rec
            streams.append(rec["tokens"])
        after = await latest_stats(met_sub)
        calls = calls_delta(after, before)
        launches = {tuple(k.split(":", 1)[1].split("/")): n for k, n in calls.items()
                    if k.startswith("kernels:")}
        plain = {k: n for k, n in calls.items() if k.startswith("plain:")}
        check_alone_launches("mm_worker", launches, plain)
        encoded_log = "encoded" in tail("encoder")
        for name in ("worker", "encoder"):
            procs[name].send_signal(signal.SIGTERM)
        rcs = {name: await asyncio.get_running_loop().run_in_executor(None, p.wait, 120)
               for name, p in procs.items()}
        assert rcs == {"encoder": 0, "worker": 0}, (rcs, tail("worker"), tail("encoder"))
        assert encoded_log, tail("encoder")
        await enc_client.close()
        await client.close()
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for f in logs.values():
            f.close()
            os.unlink(f.name)
        await drt.close()
        await server.stop()

    # the in-process reference: the same checkpoint, the same stamped requests
    engine = TorchEngine(EngineConfig(model="llama3-3b", seed=seed, num_pages=MM_WORKER_PAGES),
                         model_config=cfg, params=loader.load_llama_params(ckpt, cfg, device=DEV),
                         device="cuda")
    await engine.warmup()
    local = []
    for req in stamped:
        engine.clear_kv_blocks()
        rec = new_record()
        await run_request(engine, req, rec)
        local.append(rec["tokens"])
    await engine.close()
    del engine
    assert local == streams, "mm_worker: the CLI worker streams other tokens than the engine"
    # the hop, split: each request's decode, forward, tolist + pack and
    # unpack in this process (the fastest of three), on an encoder from the
    # encode worker's seed (0); the wire's rest is the hop less those
    def best_ms(fn, n=3):
        times = []
        for _ in range(n):
            t1 = time.perf_counter()
            out = fn()
            times.append(1e3 * (time.perf_counter() - t1))
        return min(times), out

    enc = vit_encoder(0, "cuda")
    emb_err, split = 0.0, []
    for req, st, hop in zip(reqs, stamped, hop_s):
        ms = {"decode": 0.0, "forward": 0.0}
        embs = []
        for raw, got in zip(req["multimodal"], st["multimodal"]):
            dt, px = best_ms(lambda: enc._pixels(raw))
            ms["decode"] += dt
            px = torch.from_numpy(np.ascontiguousarray(px[None])).to(DEV)
            ms["forward"] += time_ms(lambda: enc._fwd(px), warm=1, reps=5)
            embs.append(enc._fwd(px)[0].float().cpu().numpy())
            emb_err = max(emb_err, float(np.abs(embs[-1] - np.asarray(got["embedding"])).max()))
        ms["pack"], raw_bytes = best_ms(lambda: msgpack_lite.packb({"data": {"multimodal": [
            dict(p, embedding=e.tolist(), n_tokens=enc.n_tokens)
            for p, e in zip(req["multimodal"], embs)], "n_tokens": enc.n_tokens}}))
        ms["unpack"], _ = best_ms(lambda: msgpack_lite.unpackb(raw_bytes))
        ms["wire_rest"] = 1e3 * hop - sum(ms.values())
        split.append({"hop": round(1e3 * hop, 2), "bytes": len(raw_bytes),
                      **{k: round(v, 2) for k, v in ms.items()}})
    assert emb_err <= TOL_VIT, f"mm_worker: the wire's embeddings are {emb_err} from this encoder's"
    del enc
    torch.cuda.empty_cache()
    emit("mm_worker", model="llama-3.2-3b", layers=LOAD_LAYERS, encoder="vit-base-16-224",
         requests=len(reqs), image_parts=sum(len(r["multimodal"]) for r in reqs),
         seconds_to_registration={"worker": round(t_reg, 2), "encoder": round(t_enc, 2)},
         streams_equal=len(streams), embedding_max_abs_err=emb_err,
         first_hop_ms=round(1e3 * first_hop_s, 2),
         hop_ms_split=split,
         launches={"/".join(k): n for k, n in launches.items()}, exit_codes=rcs)
    return launches


# ---------------------------------------------------------------------- #
# the OpenAI HTTP frontend, KV routing, in front of kvbm_peer's two workers
# ---------------------------------------------------------------------- #

FE_MODEL = "llama3-3b"  # the served name: the workers' --model
FE_AFFINITY_PREFIX = 320  # five pages shared by a seed request and its followers
FE_FOLLOWERS = 3  # follow-ups of each of the two seeds: six requests
# the stream on the worker kvbm_peer kills: its prompt and output tokens
# (more than the durable streams', so it is still decoding at the cut)
FE_MIGRATE_PROMPT, FE_MIGRATE_OUT = 500, 512
FE_MIGRATE_CUT = 4  # text events out at least when its worker is killed
FE_SETTLE_S = 0.35  # > the workers' 0.25 s stats cadence: the router sees a settled load
FE_SHARED = (3, 7)  # the latency run's request 7 shares request 3's prefix and waits for it


async def http_call(port: int, method: str, path: str, body=None, on_event=None) -> tuple:
    """One HTTP/1.1 request on asyncio streams (the card's machine has no
    httpx): (status, headers, body, events). A chunked body is read chunk by
    chunk; each SSE event is kept with its arrival (seconds from the send)
    and handed to `await on_event(text)` as it arrives."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                 f"Content-Type: application/json\r\nContent-Length: {len(data)}\r\n"
                 "Connection: close\r\n\r\n".encode() + data)
    await writer.drain()
    t0 = time.perf_counter()
    try:
        head = (await reader.readuntil(b"\r\n\r\n")).decode("latin-1").split("\r\n")
        status = int(head[0].split(" ")[1])
        headers = {k.lower(): v.strip() for k, _, v in (h.partition(":") for h in head[1:] if h)}
        events, raw, buf = [], b"", b""
        if "chunked" in headers.get("transfer-encoding", ""):
            while True:
                size = int((await reader.readuntil(b"\r\n")).split(b";")[0], 16)
                if size == 0:
                    break
                chunk = (await reader.readexactly(size + 2))[:-2]
                now = time.perf_counter() - t0
                raw += chunk
                buf += chunk
                while b"\n\n" in buf:
                    frame, buf = buf.split(b"\n\n", 1)
                    events.append((now, frame.decode()))
                    if on_event is not None:
                        await on_event(frame.decode())
        else:
            raw = await reader.readexactly(int(headers.get("content-length", "0")))
        return status, headers, raw, events
    finally:
        writer.close()


def sse_data(events) -> list:
    """(arrival, parsed data) of each `data:` event but [DONE]."""
    return [(t, json.loads(e[6:])) for t, e in events
            if e.startswith("data: ") and e != "data: [DONE]"]


def sse_comment(events, name: str):
    for _t, e in events:
        if e.startswith(f": {name} "):
            return json.loads(e.split(" ", 2)[2])[0]
    return None


def http_latency(events) -> tuple:
    """(TTFT s, mean ITL s, tokens) of one streamed completion: first and
    last text event, tokens from the usage chunk."""
    data = sse_data(events)
    texts = [t for t, d in data if d["choices"] and d["choices"][0].get("text")]
    n = [d for _t, d in data if d.get("usage")][-1]["usage"]["completion_tokens"]
    return texts[0], (texts[-1] - texts[0]) / max(n - 1, 1), n


def proc_cpu_s(pid: int) -> float:
    """User + system CPU seconds of a live process (/proc/<pid>/stat)."""
    import os

    fields = open(f"/proc/{pid}/stat").read().rsplit(")", 1)[1].split()
    return (int(fields[11]) + int(fields[12])) / os.sysconf("SC_CLK_TCK")


def check_frontend_calls(calls: dict, canaries: dict) -> None:
    """Over the HTTP traffic alone (`calls_delta` of each worker's published
    stats), each worker launched the decode kernel at least once a token of
    one 64-token stream (canaries, one-token requests, decode nothing), the
    prefill kernel more often than its canaries could (one forward of
    LOAD_LAYERS launches each), and no plain attention."""
    for name, c in calls.items():
        assert c.get("kernels:paged_decode/none", 0) >= MAX_TOKENS - 1, (name, c)
        assert c.get("kernels:prefill_attention/none", 0) > LOAD_LAYERS * canaries[name], \
            (name, c, canaries)
        assert not any(k.startswith("plain:") for k in c), (name, c)


async def frontend_http(seed: int, http_port: int, sys_port: int, ids: dict, routers: dict,
                        stats_of, checkpoints_landed, alive, procs: dict) -> dict:
    """The frontend over HTTP (asyncio streams; no httpx on the card's
    machine) in front of kvbm_peer's two workers: /v1/models and /health; a
    greedy completion whose text equals the port tokenizer's decode of the
    same request's tokens through a PushRouter; a streamed and a unary chat;
    six requests, each sharing five pages with an earlier one, each landing
    on the worker that holds them (the workers' kv_prefix_hit_blocks_total);
    TTFT and ITL of the worker phase's 8 prompts over HTTP, then the same
    requests over PushRouters, each request on the same worker in both runs
    (the frontend's router pinned by `nvext.router_config_override`); the
    workers' kernel launches over the HTTP traffic alone; dynamo_frontend_*
    and gate metrics on /metrics; the frontend's PID not among the card's
    compute processes and no libcuda in its maps. Its result goes into the
    `frontend` line."""
    import re

    from dynamo_tpu_torch.llm.tokenizers import load_tokenizer

    names = ("w1", "w2")
    by_instance = {f"{i:x}": name for name, i in ids.items()}

    def hits(name) -> float:
        return gauge(scrape(sys_port + names.index(name), "/metrics")[1],
                     "kv_prefix_hit_blocks_total")

    def canaries() -> dict:
        return {name: gauge(scrape(sys_port + i, "/metrics")[1], "health_canaries")
                for i, name in enumerate(names)}

    async def clear_settled():
        """Both workers' checkpoints pushed, then every tier cleared through
        the frontend; each mesh hears the other's `cleared`."""
        for name in names:
            await checkpoints_landed(name)
        await http_call(http_port, "POST", "/clear-kv-blocks")
        await asyncio.sleep(1.0)

    t0 = time.perf_counter()
    while True:  # the frontend's watcher has the model and both instances
        st, _h, body, _e = await http_call(http_port, "GET", "/v1/models")
        if st == 200 and [d["id"] for d in json.loads(body)["data"]] == [FE_MODEL]:
            cleared = json.loads((await http_call(http_port, "POST", "/clear-kv-blocks"))[2])
            if len(cleared["cleared"].get(FE_MODEL, {})) == 2:
                break
        alive()
        await asyncio.sleep(0.1)
    models_s = time.perf_counter() - t0
    health = await http_call(http_port, "GET", "/health")
    assert health[0] == 200 and json.loads(health[2]) == {
        "status": "healthy", "models": [FE_MODEL]}, health

    # the greedy reference first, alone on cleared caches: the tokens of a
    # PushRouter's stream, decoded by the port's tokenizer
    vocab = llama.LlamaConfig.llama3_2_3b().vocab_size
    reqs, text = make_requests(seed, vocab, WORKER_LENGTHS, FE_SHARED, (), "fe")
    prompt = text(300, 4242)
    await http_call(http_port, "POST", "/clear-kv-blocks")
    rec = new_record()
    await run_stream(routers["w1"].generate, PreprocessedRequest(
        token_ids=prompt, request_id="fe-greedy", sampling_options={"temperature": 0.0},
        stop_conditions={"max_tokens": 32}).to_dict(), rec)
    decoded = load_tokenizer("byte").decode_stream().step_batch(rec["tokens"]) or ""

    # every kernel the workers launch from here to the second snapshot is the
    # HTTP traffic's (or a canary's: counted beside it)
    await asyncio.sleep(FE_SETTLE_S)
    canaries0 = canaries()
    base = {name: await stats_of(name) for name in names}

    # the same greedy completion over HTTP, alone on cleared caches
    await http_call(http_port, "POST", "/clear-kv-blocks")
    st, _h, body, _e = await http_call(http_port, "POST", "/v1/completions", {
        "model": FE_MODEL, "prompt": prompt, "max_tokens": 32, "temperature": 0.0,
        "nvext": {"ignore_eos": True}})
    completion = json.loads(body)
    assert st == 200 and completion["usage"]["completion_tokens"] == 32, completion
    assert completion["choices"][0]["text"] == decoded, \
        (completion["choices"][0]["text"], decoded, rec["tokens"])

    # a streamed and a unary chat
    chat = {"model": FE_MODEL, "messages": [{"role": "user", "content": "say something"}],
            "max_tokens": 16, "temperature": 0.0, "nvext": {"ignore_eos": True}}
    st, hd, _b, events = await http_call(http_port, "POST", "/v1/chat/completions", dict(
        chat, stream=True, stream_options={"include_usage": True}))
    assert st == 200 and hd["content-type"] == "text/event-stream", (st, hd)
    chunks = [d for _t, d in sse_data(events)]
    assert events[-1][1] == "data: [DONE]", events[-3:]
    assert chunks[0]["choices"][0]["delta"]["role"] == "assistant"
    assert chunks[-1]["usage"]["completion_tokens"] == 16, chunks[-1]
    streamed = "".join(c["choices"][0]["delta"].get("content", "") for c in chunks if c["choices"])
    st, _h, body, _e = await http_call(http_port, "POST", "/v1/chat/completions", chat)
    unary = json.loads(body)
    assert st == 200 and unary["usage"]["completion_tokens"] == 16, unary
    assert unary["choices"][0]["finish_reason"] == "length", unary

    # KV-aware routing: two seeds, then six followers sharing their first
    # five pages, one at a time, each on the seed's worker
    await clear_settled()
    hits0 = {name: hits(name) for name in names}
    landed = []
    for s in range(2):
        prefix = text(FE_AFFINITY_PREFIX, 7000 + s)
        group = [prefix + text(120, 7100 + 10 * s + f) for f in range(FE_FOLLOWERS + 1)]
        holder = None
        for j, ids_ in enumerate(group):
            # one at a time, each after a stats publish: the router's
            # load view holds no finished request's blocks
            await asyncio.sleep(FE_SETTLE_S)
            st, _h, _b, ev = await http_call(http_port, "POST", "/v1/completions", {
                "model": FE_MODEL, "prompt": ids_, "max_tokens": 4, "stream": True,
                "nvext": {"annotations": ["worker_instance_id"], "ignore_eos": True}})
            assert st == 200, st
            worker = by_instance[sse_comment(ev, "worker_instance_id")]
            if j == 0:
                holder = worker
            else:
                landed.append((s, worker, holder))
    assert all(w == h for _s, w, h in landed), f"frontend: a follower left its prefix: {landed}"
    await asyncio.sleep(2 * FE_SETTLE_S)  # the workers' next stats publish
    hit_blocks = {name: hits(name) - hits0[name] for name in names}
    per_worker = {name: sum(1 for _s, w, _h in landed if w == name) for name in names}
    for name in names:
        assert hit_blocks[name] >= (FE_AFFINITY_PREFIX // 64) * per_worker[name], \
            (hit_blocks, per_worker)

    # TTFT and ITL: the worker phase's 8 prompts, staggered, 64 tokens each,
    # request i on worker i % 2 over HTTP and then over a PushRouter
    pins = {r["request_id"]: names[i % 2] for i, r in enumerate(reqs)}

    async def over_http(req, first, after):
        if after is not None:
            await after.wait()

        async def on_event(frame):
            if frame.startswith("data: {"):
                d = json.loads(frame[6:])
                if d["choices"] and d["choices"][0].get("text"):
                    first.set()

        st, _h, _b, ev = await http_call(http_port, "POST", "/v1/completions", {
            "model": FE_MODEL, "prompt": req["token_ids"], "max_tokens": MAX_TOKENS,
            "temperature": 0.0, "stream": True, "stream_options": {"include_usage": True},
            "nvext": {"ignore_eos": True, "annotations": ["worker_instance_id"],
                      "router_config_override": {
                          "backend_instance_id": ids[pins[req["request_id"]]]}}}, on_event)
        assert st == 200, st
        worker = by_instance[sse_comment(ev, "worker_instance_id")]
        assert worker == pins[req["request_id"]], (req["request_id"], worker)
        return http_latency(ev)

    await clear_settled()
    firsts = [asyncio.Event() for _ in reqs]
    t1 = time.perf_counter()
    tasks = []
    for i, req in enumerate(reqs):
        after = firsts[FE_SHARED[0]] if i == FE_SHARED[1] else None
        tasks.append(asyncio.create_task(over_http(req, firsts[i], after)))
        await asyncio.sleep(STAGGER_S)
    lat = await asyncio.gather(*tasks)
    http_wall = time.perf_counter() - t1
    assert all(n == MAX_TOKENS for _t, _i, n in lat), lat

    await asyncio.sleep(FE_SETTLE_S)
    after = {name: await stats_of(name) for name in names}
    canaries1 = canaries()
    calls = {name: calls_delta(after[name], base[name]) for name in names}
    canaried = {name: canaries1[name] - canaries0[name] for name in names}
    check_frontend_calls(calls, canaried)

    await clear_settled()
    direct, direct_wall = await drive(lambda r: routers[pins[r["request_id"]]].generate(r),
                                      reqs, FE_SHARED)
    direct_itl = [sum(r["itl_s"]) / max(len(r["tokens"]) - 1, 1) for r in direct]

    def summary(ttft, itl, n_out, wall):
        return {"wall_s": round(wall, 3), "output_tok_s": round(n_out / wall, 1),
                "ttft_ms": {"p50": round(1e3 * pct(ttft, 50), 2), "p99": round(1e3 * pct(ttft, 99), 2)},
                "itl_ms": {"p50": round(1e3 * pct(itl, 50), 3), "p99": round(1e3 * pct(itl, 99), 3)}}

    # the frontend's exposition, and its hands off the card
    metrics = (await http_call(http_port, "GET", "/metrics"))[2].decode()
    metric_names = {ln.split("{")[0].split(" ")[0] for ln in metrics.splitlines()
                    if ln and not ln.startswith("#")}
    for want in ("dynamo_frontend_requests_total", "dynamo_frontend_inflight_requests",
                 "dynamo_frontend_time_to_first_token_seconds_bucket",
                 "dynamo_frontend_inter_token_latency_seconds_count",
                 "dynamo_frontend_output_tokens_total", "dynamo_frontend_gate_admitted_total",
                 "dynamo_frontend_gate_queue_depth", "dynamo_frontend_migrations_total"):
        assert want in metric_names, f"frontend: {want} missing from /metrics"
    fe_pid = procs["frontend"].pid
    apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.split()
    worker_pids = [procs[n].pid for n in names]
    # nvidia-smi may list the host's PIDs rather than this namespace's:
    # the count (this process and the two workers) is checked as well
    assert str(fe_pid) not in apps and len(apps) <= 3, \
        f"frontend: pid {fe_pid} or another process holds a CUDA context: {apps}"
    fe_maps = open(f"/proc/{fe_pid}/maps").read()
    assert "libcuda" not in fe_maps and "torch" not in fe_maps, "frontend: loaded CUDA or torch"
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    return dict(
        card=card, seconds_to_models=round(models_s, 2),
        chat={"streamed_events": len(chunks), "streamed_text_chars": len(streamed),
              "unary_tokens": unary["usage"]["completion_tokens"]},
        greedy_completion_equal=True,
        affinity={"followers": len(landed), "landed": [w for _s, w, _h in landed],
                  "prefix_hit_blocks": hit_blocks},
        requests=len(reqs), prompt_tokens=WORKER_LENGTHS, max_tokens=MAX_TOKENS,
        placement={name: [i for i, r in enumerate(reqs) if pins[r["request_id"]] == name]
                   for name in names},
        over_http=summary([t for t, _i, _n in lat], [i for _t, i, _n in lat],
                          sum(n for _t, _i, n in lat), http_wall),
        over_push_router=summary([r["ttft_s"] for r in direct], direct_itl,
                                 sum(len(r["tokens"]) for r in direct), direct_wall),
        http_worker_calls=calls, canaries_during_http=canaried,
        frontend_pid_on_card=False, card_compute_pids=len(apps),
        worker_pids_listed=sum(str(p) in apps for p in worker_pids),
        metrics_names=len(metric_names))


# ---------------------------------------------------------------------- #
# phases: profiler (the planner's pre-deployment sweep) and planner (the
# SLA planner scaling CLI workers behind the port's frontend)
# ---------------------------------------------------------------------- #

PROFILE_MODEL = "llama3-3b"  # the sweep at full width and depth, default grids
PROFILE_LAYERS = 28
PROFILE_ISL = (128, 512, 1024, 2048, 4096)
PROFILE_POINTS = 15  # 3 contexts x 5 usages, each fits 65,536 KV tokens
PROFILE_CALLS = {"prefill_attention": PROFILE_LAYERS * len(PROFILE_ISL) * 4,  # warmup + 3
                 "paged_decode": PROFILE_LAYERS * PROFILE_POINTS * 9}  # warmup + 8


def profile_kernel_checks(seed: int, measured: dict) -> None:
    """Both kernels of the sweep against their plain versions at its
    largest shapes, and timed there: paged decode at 243 lanes of 4 pages
    (context 256, usage 0.95; also 15 lanes of 64 pages, the split path)
    and prefill at B=1, T=4,096 from position 0 (the dispatcher of the
    single-sequence forward too)."""
    from dynamo_tpu_torch.planner.profiler import decode_batch

    rng = np.random.default_rng(seed + 13)
    H, KH, D, ps = 24, 8, 128, 64
    pages = (1 << 16) // ps + 1
    k, v = make_pool(rng, pages, ps, KH, D, torch.bfloat16)
    for ctx, usage in ((4096, 0.95), (256, 0.95)):
        B, pps = decode_batch(usage, ctx, 1 << 16, ps), -(-ctx // ps)
        q = torch.from_numpy(rng.standard_normal((B, H, D)).astype(np.float32))
        q = q.to(DEV, torch.bfloat16)
        tab = i32((1 + np.arange(B)[:, None] * pps + np.arange(pps)) % pages)
        lens = i32(np.full(B, ctx))
        args = (q, k, v, tab, lens)
        err, rel = check_full("paged_decode@profile", "none", pa.paged_attention_decode(*args),
                              pa.paged_attention_decode_plain(*args), f"B={B} ctx={ctx}")
    # the timed row: the sweep's widest point, 243 lanes of 4 pages
    b_ms, b_by = decode_bound(np.full(B, ctx), KH, D, ps, "none", q, H)
    kd, vd = dense_ctx(k, tab, q.dtype), dense_ctx(v, tab, q.dtype)
    lib = sdpa_ms(q[:, :, None], kd, vd, None)  # every lane's keys all valid
    del kd, vd
    times = time_kernel(lambda: pa.paged_attention_decode(*args))
    measured[("paged_decode@profile", "none")] = {
        "max_abs_err": err, "max_row_rel_err": rel, **times,
        "tflops": tflops(4.0 * H * D * B * ctx, times["ms"]),
        "plain_ms": time_ms(lambda: pa.paged_attention_decode_plain(*args), 1, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "splits": hopper_paged_attention.last_splits,
        "shape": f"B={B} pages={pps} ctx={ctx} H={H} KH={KH} D={D} ps={ps}",
    }
    del args, q, tab, lens
    T = PROFILE_ISL[-1]
    q, k2, v2, pos, tab, totals, starts = prefill_case(
        rng, 1, T, H, KH, D, ps, T // ps, T // ps + 1, torch.bfloat16, starts=[0], reals=[T])
    args = (q, k2, v2, pos, tab, totals, starts)
    err, rel = check_full("prefill_attention@profile", "none", pa.prefill_attention_batched(*args),
                          pa.prefill_attention_batched_plain(*args), "B=1 T=4096")
    single = (q[0], k2, v2, pos[0], tab[0], 0, T)
    err1, rel1 = check_full("prefill_attention@profile", "none", pa.prefill_attention(*single),
                            pa.prefill_attention_plain(*single[:5]), "single sequence")
    visible = T * (T + 1) / 2
    b_ms, b_by = bound(T * kv_bytes_per_token(KH, D, "none") + 2 * q.numel() * 2,
                       4.0 * H * D * visible)
    # from position 0 with T == S, the chunk's mask is the causal one
    lib = sdpa_ms(q.transpose(1, 2), dense_ctx(k2, tab, q.dtype), dense_ctx(v2, tab, q.dtype),
                  None, is_causal=True)
    times = time_kernel(lambda: pa.prefill_attention_batched(*args))
    measured[("prefill_attention@profile", "none")] = {
        "max_abs_err": max(err, err1), "max_row_rel_err": max(rel, rel1), **times,
        "tflops": tflops(4.0 * H * D * visible, times["ms"]),
        "plain_ms": time_ms(lambda: pa.prefill_attention_batched_plain(*args), 1, 3),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
        "shape": f"B=1 T={T} H={H} KH={KH} D={D} ps={ps} start=0",
    }
    del args, single, q, k, v, k2, v2
    torch.cuda.empty_cache()


def phase_profiler(seed: int) -> dict:
    """`planner.profiler.main` in process on Llama-3.2-3B at 28 layers with
    the default grids (ISL 128-4,096; context 256/1,024/4,096 x usage
    0.1-0.95 of 65,536 KV tokens): the TTFT and throughput of each ISL, the
    ITL and throughput of each point, exactly the launches the sweep makes
    (28 layers x 5 ISLs x 4 calls of the prefill kernel, 28 x 15 points x 9
    steps of the paged-decode kernel) and no plain call; then both kernels
    against their plain versions at the sweep's largest shapes. Returns the
    measured entries of the kernels line (`@profile`) with their launches."""
    import tempfile

    from dynamo_tpu_torch.planner import perf_interpolation, profiler

    out = tempfile.mkdtemp(prefix="torch_profile_")
    try:
        reset_counts()
        t0 = time.perf_counter()
        raw = profiler.main(["--model", PROFILE_MODEL, "--output-dir", out])
        sweep_s = time.perf_counter() - t0
        launches = kernel_launches()
        plain = dict(pa.plain_calls)
        want = {(name, "none"): n for name, n in PROFILE_CALLS.items()}
        assert {key: n for key, n in launches.items() if n} == want, \
            f"profiler: launches {launches}, want {want}"
        assert not any(plain.values()), f"profiler: plain attention on the card: {plain}"
        p, d = raw["prefill"], raw["decode"]
        assert len(d["z_itl"]) == PROFILE_POINTS
        for a in (p["prefill_ttft"], p["prefill_thpt_per_gpu"], d["z_itl"], d["z_thpt_per_gpu"]):
            assert np.all(np.isfinite(a)) and np.all(a > 0), a
        pi = perf_interpolation.PrefillInterpolator(profile_results_dir=out)
        di = perf_interpolation.DecodeInterpolator(profile_results_dir=out)
        assert pi.interpolate_ttft(1000) > 0 and np.isfinite(di.itl_grid).all()
    finally:
        shutil.rmtree(out, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    measured: dict = {}
    profile_kernel_checks(seed, measured)
    emit("profiler", sweep_seconds=round(sweep_s, 2), layers=PROFILE_LAYERS,
         prefill=[{"isl": int(i), "ttft_ms": round(float(t), 3), "tok_s": round(float(r), 1)}
                  for i, t, r in zip(p["prefill_isl"], p["prefill_ttft"],
                                     p["prefill_thpt_per_gpu"])],
         decode=[{"kv_usage": float(u), "context": int(c),
                  "lanes": profiler.decode_batch(float(u), int(c), 1 << 16, 64),
                  "itl_ms": round(float(t), 3), "tok_s": round(float(r), 1)}
                 for u, c, t, r in zip(d["x_kv_usage"], d["y_context_length"], d["z_itl"],
                                       d["z_thpt_per_gpu"])],
         launches={f"{n}/{f}": c for (n, f), c in launches.items() if c},
         plain_calls=plain, tol_bf16_full=TOL_BF16_FULL, tol_bf16_row_rel=TOL_BF16_ROW_REL,
         kernels={f"{n}/{f}": m for (n, f), m in measured.items()})
    for (name, fmt), m in measured.items():
        m["launches"] = launches[(name.split("@")[0], fmt)]
    return measured


# the planner phase: the profile of the workers' depth, on small grids
# whose lightest point is one lane (so a few streams over HTTP ask for a
# second decode replica; PERF.md writes the arithmetic down)
PLANNER_ISL = (128, 512, 1024)
PLANNER_CTX = (256, 1024)
PLANNER_USAGE = (0.1, 0.5, 0.9)
PLANNER_MAX_KV = 2048
PLANNER_INTERVAL_S = 4.0
PLANNER_TTFT_S = 2.0
# the ITL target: over the d correction (2.5-2.8 in earlier runs: the
# frontend's ITL against the profile's) it stays above every profiled ITL
# (3.2-3.6 ms at 4 layers), so the planner takes the highest-load point
PLANNER_ITL_S = 0.03
PLANNER_BUDGET = 3  # chips: one prefill and at most two decode replicas
PLANNER_PAGES = 512  # each worker's pool (4 layers: 0.5 GiB)
PLANNER_STREAMS = 32  # closed-loop HTTP streams
PLANNER_PROMPT, PLANNER_OSL = 200, 192


def planner_log(text: str) -> dict:
    """The planner's decisions, observations and correction factors from
    its log, in order."""
    import re

    dec = [{"raw": None if r == "None" else tuple(map(int, r.strip("()").split(","))),
            "target": tuple(map(int, t.strip("()").split(","))),
            "applied": a == "True", "reason": why}
           for r, t, a, why in re.findall(
               r"planner decision: raw=(None|\(\d+, \d+\)) target=(\(\d+, \d+\)) "
               r"applied=(True|False) \(([^)]*)\)", text)]
    obs = [dict(zip(("num_req", "isl", "osl", "ttft_s", "itl_s"), map(float, m)))
           for m in re.findall(r"observed num_req=(\S+) isl=(\S+) osl=(\S+) "
                               r"ttft=(\S+)s itl=(\S+)s", text)]
    corr = [tuple(map(float, m)) for m in re.findall(
        r"correction factors: ttft=(\S+) itl=(\S+)", text)]
    pids = [(role, int(pid)) for role, pid in re.findall(r"spawned (\w+) worker pid=(\d+)", text)]
    # each sizing (its inputs at full precision and its ask before the chip
    # budget) with the budget's total where the ask exceeded it
    sizing = []
    for line in text.splitlines():
        m = re.search(r"sizing: num_req=(\S+) isl=(\S+) osl=(\S+) p_correction=(\S+) "
                      r"d_correction=(\S+) -> p=(\d+) d=(\d+)", line)
        if m:
            sizing.append({**dict(zip(("num_req", "isl", "osl", "p_corr", "d_corr"),
                                      map(float, m.groups()[:5]))),
                           "ask": (int(m.group(6)), int(m.group(7))), "over_budget": None})
        m = re.search(r"chip budget \d+ exceeded \((\d+)\)", line)
        if m:
            sizing[-1]["over_budget"] = int(m.group(1))
    return {"decisions": dec, "observed": obs, "corrections": corr, "spawned": pids,
            "sizing": sizing}


def planner_ask(s: dict, pi, di) -> dict:
    """The replicas an interval asks for before the chip budget, from the
    inputs the planner logged: prefill = ceil(num_req x ISL / interval x
    min(1, p correction) / the profile's prefill tok/s at that ISL); decode
    = ceil(num_req x OSL / interval / the tok/s of the highest-load profile
    point at context ISL + OSL/2 whose ITL meets the target over the d
    correction); each at least --min-endpoint 1."""
    per_p = pi.interpolate_thpt_per_chip(s["isl"])
    p = math.ceil(s["num_req"] * s["isl"] / PLANNER_INTERVAL_S * min(1.0, s["p_corr"])
                  / max(per_p, 1e-9))
    itl = PLANNER_ITL_S / s["d_corr"] if s["d_corr"] > 0 else PLANNER_ITL_S
    thpt, itl_at, usage = di.find_best_throughput_per_chip(itl, s["isl"] + s["osl"] / 2)
    d = math.ceil(s["num_req"] * s["osl"] / PLANNER_INTERVAL_S / max(thpt, 1e-9))
    return {"ask": (max(p, 1), max(d, 1)), "prefill_tok_s": per_p, "itl_target_s": itl,
            "point_tok_s": thpt, "point_itl_s": itl_at, "point_kv_usage": usage}


async def planner_phase(seed: int, ckpt: str) -> None:
    """The SLA planner on the port, end to end: the profile of the
    workers' depth (`profile_prefill` / `profile_decode` at LOAD_LAYERS on
    small grids), `python -m dynamo_tpu_torch.frontend --embed-discovery
    --router-mode round-robin`, and `python -m dynamo_tpu_torch.planner
    --connector local` whose children are `--role prefill|decode` CLI
    workers on the weights_load checkpoint. The cold start must register
    one prefill and one decode worker; closed-loop HTTP streams through
    the pair must let an interval read finite TTFT and ITL off the
    frontend's /metrics and the planner ask for a second decode replica
    (scale-up to (1, 2)); every interval's ask must follow the arithmetic
    PERF.md writes down (`planner_ask`, redone from the inputs the planner
    logs); the third worker must register and serve a request pinned to
    it; over the HTTP traffic every worker must launch its kernels (the
    prefill worker the prefill kernel, each decode worker the paged-decode
    kernel) and call no plain version; SIGTERM to the planner must exit 0
    and leave no child alive."""
    import os
    import signal
    import tempfile
    from pathlib import Path

    from dynamo_tpu_torch.llm.kv_router.publisher import METRICS_TOPIC_FMT
    from dynamo_tpu_torch.planner import perf_interpolation, profiler
    from dynamo_tpu_torch.runtime import DistributedRuntime, RuntimeConfig, codec

    t_phase = time.perf_counter()
    cfg = llama.LlamaConfig.llama3_2_3b(num_layers=LOAD_LAYERS)
    prof = tempfile.mkdtemp(prefix="torch_planner_profile_")

    root = Path(__file__).resolve().parent
    http_port, disc_port = free_port_pair(), free_port_pair()
    disc = f"tcp://127.0.0.1:{disc_port}"
    env = dict(os.environ, PYTHONPATH=str(root), DYN_DISCOVERY_ENDPOINT=disc)
    logs, procs = {}, {}

    def start(name, args, extra_env=None):
        logs[name] = tempfile.NamedTemporaryFile(prefix=f"planner_{name}_", suffix=".log",
                                                 delete=False)
        procs[name] = subprocess.Popen([sys.executable, "-m", *args], cwd=root,
                                       env=dict(env, **(extra_env or {})),
                                       stdout=logs[name], stderr=subprocess.STDOUT)

    def log(name):
        return Path(logs[name].name).read_text(errors="replace")

    def alive():
        for name, proc in procs.items():
            if proc.poll() is not None:
                raise RuntimeError(f"planner: {name} exited {proc.poll()}: {log(name)[-3000:]}")

    worker = (f"{sys.executable} -m dynamo_tpu_torch.worker --model {FE_MODEL} "
              f"--model-path {ckpt} --num-pages {PLANNER_PAGES} --seed {seed} "
              f"--discovery {disc} --kv-data-plane-host 127.0.0.1")
    drt = None
    stop = asyncio.Event()
    recs: list = []
    t0 = time.perf_counter()
    # the admission gate off: it would shed (429) the very load the planner
    # must see, and a rejected request counts in the frontend's requests
    # with no tokens, which the planner's interval averages take in
    start("frontend", ["dynamo_tpu_torch.frontend", "--http-host", "127.0.0.1",
                       "--http-port", str(http_port), "--embed-discovery", "--discovery", disc,
                       "--router-mode", "round-robin"], {"DYN_GATE": "0"})
    try:
        # the profile on the card while the frontend starts
        profiler.write_profiles(
            prof, profiler.profile_prefill(cfg, PLANNER_ISL),
            profiler.profile_decode(cfg, PLANNER_CTX, PLANNER_USAGE, PLANNER_MAX_KV))
        gc.collect()
        torch.cuda.empty_cache()
        pi = perf_interpolation.PrefillInterpolator(profile_results_dir=prof)
        di = perf_interpolation.DecodeInterpolator(profile_results_dir=prof)
        profile_s = time.perf_counter() - t_phase
        while True:
            alive()
            try:
                if (await http_call(http_port, "GET", "/live"))[0] == 200:
                    break
            except OSError:
                await asyncio.sleep(0.1)
        rcfg = RuntimeConfig.from_settings()
        rcfg.discovery_endpoint = disc
        drt = await DistributedRuntime.create(rcfg)
        dclient = await drt.namespace("dynamo").component("backend").endpoint("generate").client()
        pclient = await drt.namespace("dynamo").component("prefill").endpoint("generate").client()
        subs = {role: await drt.discovery.subscribe(METRICS_TOPIC_FMT.format(
            namespace="dynamo", component=comp)) for role, comp in (("prefill", "prefill"),
                                                                   ("decode", "backend"))}

        async def published(role, ids) -> dict:
            """Each of these workers' stats as published after this call
            (the queue drained first), by instance id."""
            while await subs[role].get(timeout=0.01) is not None:
                pass
            got = {}
            while not set(ids) <= set(got):
                raw = await subs[role].get(timeout=10)
                if raw is None:
                    raise RuntimeError(f"planner: no stats from {role} {set(ids) - set(got)}")
                msg = codec.unpack(raw)
                got[msg["worker_id"]] = msg["stats"]
            return {i: got[i] for i in ids}

        start("planner", [
            "dynamo_tpu_torch.planner", "--connector", "local",
            "--frontend-url", f"http://127.0.0.1:{http_port}", "--profile-results-dir", prof,
            "--ttft", str(PLANNER_TTFT_S), "--itl", str(PLANNER_ITL_S),
            "--adjustment-interval", str(PLANNER_INTERVAL_S), "--min-endpoint", "1",
            "--max-chip-budget", str(PLANNER_BUDGET),
            "--prefill-cmd", f"{worker} --role prefill",
            "--decode-cmd", f"{worker} --role decode --disagg-threshold {DISAGG_THRESHOLD}"])

        async def until(cond, what, limit=240.0):
            t = time.perf_counter()
            while not cond():
                alive()
                if time.perf_counter() - t > limit:
                    raise RuntimeError(f"planner: {what} not within {limit} s: "
                                       f"{log('planner')[-4000:]}")
                await asyncio.sleep(0.2)
            return time.perf_counter() - t0

        async def models():
            st, _h, body, _e = await http_call(http_port, "GET", "/v1/models")
            return st == 200 and FE_MODEL in [d["id"] for d in json.loads(body)["data"]]

        # the cold start: one prefill and one decode worker, with nothing sent
        t_cold = await until(lambda: len(pclient.instance_ids()) == 1
                             and len(dclient.instance_ids()) == 1, "the cold start")
        while not await models():
            alive()
            await asyncio.sleep(0.1)
        first_ids = set(dclient.instance_ids())
        pre_ids = list(pclient.instance_ids())
        base = {**await published("prefill", pre_ids), **await published("decode", first_ids)}

        async def stream(i, pin=None):
            nvext = {"ignore_eos": True}
            if pin is not None:
                nvext["router_config_override"] = {"backend_instance_id": pin}
            prompt = f"planner {i}: " + " ".join(WORDS[(i * 7 + j) % len(WORDS)]
                                                 for j in range(PLANNER_PROMPT // 6))
            st, _h, _b, events = await http_call(http_port, "POST", "/v1/completions", {
                "model": FE_MODEL, "prompt": prompt[:PLANNER_PROMPT], "stream": True,
                "stream_options": {"include_usage": True},
                "max_tokens": PLANNER_OSL, "temperature": 0.0, "nvext": nvext})
            data = sse_data(events)
            usage = [d["usage"] for _, d in data if d.get("usage")]
            return {"status": st, "tokens": usage[-1]["completion_tokens"] if usage else 0,
                    "ttft_ms": 1e3 * data[0][0] if data else None}

        async def loop(k):
            i = k
            while not stop.is_set():
                recs.append(await stream(i))
                i += PLANNER_STREAMS

        t_load = time.perf_counter()
        tasks = [asyncio.create_task(loop(k)) for k in range(PLANNER_STREAMS)]
        t_up = await until(lambda: any(d["applied"] and d["reason"] == "scale-up"
                                       for d in planner_log(log("planner"))["decisions"]),
                           "a scale-up decision", 120)
        t_third = await until(lambda: len(dclient.instance_ids()) == 2, "the third worker")
        new_id, = set(dclient.instance_ids()) - first_ids
        base.update(await published("decode", [new_id]))
        stop.set()
        await asyncio.gather(*tasks)
        load_s = time.perf_counter() - t_load
        pinned = await stream(10_000, pin=new_id)
        assert pinned["status"] == 200 and pinned["tokens"] == PLANNER_OSL, pinned
        after = {**await published("prefill", pre_ids),
                 **await published("decode", first_ids | {new_id})}
        calls = {i: calls_delta(after[i], base[i]) for i in after}
        bad = [r for r in recs if r["status"] != 200 or r["tokens"] != PLANNER_OSL]
        assert not bad and recs, f"planner: failed streams {bad[:3]}"

        procs["planner"].send_signal(signal.SIGTERM)
        rc = await asyncio.get_running_loop().run_in_executor(None, procs["planner"].wait, 120)
        text = log("planner")
        assert rc == 0, f"planner exited {rc} on SIGTERM: {text[-3000:]}"
        parsed = planner_log(text)
        left = [pid for _r, pid in parsed["spawned"] if Path(f"/proc/{pid}").exists()
                and "zombie" not in Path(f"/proc/{pid}/status").read_text().lower()]
        assert not left, f"planner: children alive after SIGTERM: {left}"
        del procs["planner"]
    finally:
        stop.set()
        for name, proc in procs.items():
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        for proc in procs.values():
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
        if drt is not None:
            await drt.close()
        shutil.rmtree(prof, ignore_errors=True)

    # over the HTTP traffic each worker ran its kernels and no plain version
    # (a decode worker prefills only what stays under the disagg threshold)
    pre_id, = pre_ids
    assert calls[pre_id].get("kernels:prefill_attention/none", 0) > 0, calls[pre_id]
    for i in first_ids | {new_id}:
        assert calls[i].get("kernels:paged_decode/none", 0) >= PLANNER_OSL - 1, (i, calls[i])
    assert not any(k.startswith("plain:") for c in calls.values() for k in c), calls

    # the decisions against the arithmetic: every sized interval, then the
    # one that scaled up
    decs, obs = parsed["decisions"], parsed["observed"]
    assert [d["reason"] for d in decs][:1] == ["bootstrap:min-endpoint"] and \
        decs[0]["target"] == (1, 1), decs
    up = next(i for i, d in enumerate(decs) if d["applied"] and d["reason"] == "scale-up")
    assert decs[up]["target"] == (1, 2), decs
    valid = [o for o in obs if o["num_req"] > 0 and math.isfinite(o["ttft_s"])
             and math.isfinite(o["itl_s"])]
    assert valid, f"planner: no interval read finite TTFT and ITL: {obs}"
    # (a sizing the SIGTERM cut off before its decision may close the log)
    sized = [d for d in decs if d["raw"] is not None]
    assert sized and len(sized) <= len(parsed["sizing"]) <= len(sized) + 1, \
        (decs, parsed["sizing"])
    asks = [planner_ask(s, pi, di) for s in parsed["sizing"]]
    for s, dec, want in zip(parsed["sizing"], sized, asks):
        assert s["ask"] == want["ask"], f"planner: asked {s['ask']}, the arithmetic {want}"
        total = sum(s["ask"])  # one chip a replica
        if total <= PLANNER_BUDGET:
            assert s["over_budget"] is None and dec["raw"] == s["ask"], (s, dec)
        else:
            assert s["over_budget"] == total and sum(dec["raw"]) <= PLANNER_BUDGET, (s, dec)
    # the scale-up: a second decode replica wanted, at a profiled point that
    # met the corrected target (not the lightest-point fallback)
    n_before = sum(1 for d in decs[:up + 1] if d["raw"] is not None)
    s_up, w_up = parsed["sizing"][n_before - 1], asks[n_before - 1]
    assert s_up["ask"][1] >= 2 and w_up["point_itl_s"] <= w_up["itl_target_s"], (s_up, w_up)
    o = valid[n_before - 1]  # the observation that fed it
    itl_model = o["itl_s"] / s_up["d_corr"]  # the profile's ITL at the observed load
    tok = [r["tokens"] for r in recs]
    emit("planner", seconds=round(time.perf_counter() - t_phase, 1),
         profile_seconds=round(profile_s, 1), cold_start_s=round(t_cold, 1),
         scale_up_at_s=round(t_up, 1), third_worker_at_s=round(t_third, 1),
         decisions=[[d["raw"], d["target"], d["applied"], d["reason"]] for d in decs],
         observed=obs, corrections=parsed["corrections"],
         sizing=[{**s, **{k: round(v, 6) for k, v in w.items() if k != "ask"}}
                 for s, w in zip(parsed["sizing"], asks)],
         scale_up_arithmetic={
             "num_req": s_up["num_req"], "isl": s_up["isl"], "osl": s_up["osl"],
             "decode_load_tok_s": round(s_up["num_req"] * s_up["osl"] / PLANNER_INTERVAL_S, 1),
             "d_correction": round(s_up["d_corr"], 4),
             "itl_target_ms": round(1e3 * w_up["itl_target_s"], 3),
             "point_kv_usage": round(w_up["point_kv_usage"], 4),
             "point_itl_ms": round(1e3 * w_up["point_itl_s"], 3),
             "point_tok_s": round(w_up["point_tok_s"], 1), "ask": s_up["ask"]},
         worker_calls={("prefill" if i == pre_id else "decode_new" if i == new_id
                        else "decode"): c for i, c in calls.items()},
         itl_ms_frontend=round(1e3 * o["itl_s"], 3),
         itl_ms_interpolated=round(1e3 * itl_model, 3),
         streams=len(recs), load_seconds=round(load_s, 1),
         http_tok_s=round(sum(tok) / load_s, 1),
         ttft_ms_p50=round(float(np.median([r["ttft_ms"] for r in recs])), 1),
         pinned_to_third=pinned["status"] == 200)


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
         cuda=torch.version.cuda, nvcc=nvcc, python=sys.version.split()[0],
         host_cpu=hash_cost.cpu_name(),
         block_hash_us_per_256_bytes=round(hash_cost.us_per_block(), 2))

    t0 = time.perf_counter()
    _build.load_library()
    emit("build", seconds=round(time.perf_counter() - t0, 2),
         nvcc_seconds=None if _build.build_seconds is None else round(_build.build_seconds, 2),
         sources=sorted(p.name for p in _build.CSRC_DIR.glob("*.cu*")))

    seconds = {}
    t0 = time.perf_counter()
    measured = phase_kernels(args.seed)
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    phase_quant_write(args.seed)
    phase_forward(args.seed)
    seconds["quant_write_forward"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = model_params(args.seed)
    launches = asyncio.run(serve_all(args.seed, params))
    seconds["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    worker_launches, reference = asyncio.run(worker_all(args.seed, params))
    for key, n in worker_launches.items():
        launches[key] = launches.get(key, 0) + n
    seconds["worker"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for key, n in asyncio.run(disagg_all(args.seed, params, reference)).items():
        launches[key] = launches.get(key, 0) + n
    seconds["disagg"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add_launches(launches, asyncio.run(weights_int8(args.seed, params)))
    seconds["weights_int8"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    load = asyncio.run(weights_load(args.seed, params))
    seconds["weights_load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add_launches(launches, asyncio.run(weights_gguf(args.seed, params)))
    seconds["weights_gguf"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add_launches(launches, asyncio.run(kvbm_all(args.seed, params)))
    seconds["kvbm"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add_launches(launches, asyncio.run(durable(args.seed, params)))
    seconds["durable"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add_launches(launches, asyncio.run(spec_guided_all(args.seed, params)))
    seconds["spec_guided"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    add_launches(launches, lora_all(args.seed, params))
    seconds["lora"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    encoder = phase_vit(args.seed)
    seconds["vit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mm_launches = asyncio.run(mm_serve(args.seed, params, encoder))
    seconds["mm_serve"] = time.perf_counter() - t0
    del encoder
    # the subprocess workers size or place their pools on the card: this
    # process lets go of what it holds first (engines that sat in
    # reference cycles with their tasks included)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    profile_measured = phase_profiler(args.seed)
    seconds["profiler"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    moe_launches, moe_load = asyncio.run(moe_all(args.seed))
    seconds["moe"] = time.perf_counter() - t0
    try:
        t0 = time.perf_counter()
        add_launches(launches, asyncio.run(weights_load_subprocess(args.seed, load)))
        seconds["weights_load"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        asyncio.run(worker_subprocess(args.seed))
        seconds["worker_subprocess"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        asyncio.run(disagg_subprocess(args.seed, reference, load["dir"]))
        seconds["disagg_subprocess"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        asyncio.run(kvbm_peer(args.seed, load["dir"]))
        seconds["kvbm_peer"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        add_launches(mm_launches, asyncio.run(mm_worker(args.seed, load["dir"])))
        seconds["mm_worker"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        asyncio.run(planner_phase(args.seed, load["dir"]))
        seconds["planner"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        add_launches(moe_launches, asyncio.run(weights_load_subprocess(args.seed, moe_load)))
        seconds["moe_worker"] = time.perf_counter() - t0
    finally:
        for ckpt in (load["dir"], moe_load["dir"]):
            shutil.rmtree(ckpt, ignore_errors=True)
    # the MoE and multimodal phases' shares of the kernels line's launches
    emit("moe_launches", launches={f"{n}/{f}": c for (n, f), c in sorted(moe_launches.items()) if c})
    emit("mm_launches", launches={f"{n}/{f}": c for (n, f), c in sorted(mm_launches.items()) if c})
    add_launches(launches, moe_launches)
    add_launches(launches, mm_launches)

    line = {"kernels": [
        {
            "name": f"{name}/{fmt}", "route": "cuda", "source": k["source"],
            "replaces": k["replaces"]["none" if fmt == "none" else "quant"],
            "launches": launches[(name, fmt)],
            **{key: measured[(name, fmt)][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "tflops", "ms_back_to_back", "host_us")},
            "body": k["body"],
            **{key: measured[(name, fmt)][key] for key in ("splits", "shapes")
               if key in measured[(name, fmt)]},
        }
        for name, k in KERNELS.items() for fmt in FORMATS
    ] + [
        # the same kernels at the speculative verify's shapes; launches: the
        # prefill kernel's in the split-spec arms, the ragged kernel's in the
        # fused-spec arms of the spec_guided phases
        {
            "name": f"{name}/{fmt}", "route": "cuda",
            "source": KERNELS[name.split("@")[0]]["source"],
            "replaces": KERNELS[name.split("@")[0]]["replaces"]["none" if fmt == "none" else "quant"],
            "launches": launches[(name, fmt)],
            **{key: measured[(name, fmt)][key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "tflops", "ms_back_to_back", "host_us", "shape")},
            "body": KERNELS[name.split("@")[0]]["body"],
        }
        for name in ("prefill_attention@verify", "ragged_attention@staircase") for fmt in FORMATS
    ] + [
        # the same kernels at the planner profiler's widest shapes; launches:
        # the profiler phase's sweep
        {
            "name": f"{name}/{fmt}", "route": "cuda",
            "source": KERNELS[name.split("@")[0]]["source"],
            "replaces": KERNELS[name.split("@")[0]]["replaces"]["none"],
            **{key: m[key] for key in (
                "launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "tflops", "ms_back_to_back", "host_us", "shape")},
            "body": KERNELS[name.split("@")[0]]["body"],
        }
        for (name, fmt), m in profile_measured.items()
    ]}
    emit("total", seconds=round(time.perf_counter() - t_all, 1),
         phase_seconds={k: round(v, 1) for k, v in seconds.items()})
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
