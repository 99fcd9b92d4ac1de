"""TorchEngine: the continuous-batching inference engine on PyTorch/CUDA.

Port of the aggregated single-device main path of
`dynamo_tpu/engine/engine.py:JaxEngine` (plain chat traffic). The host loop
keeps the reference's design — a synchronous device round-trip costs far
more than an asynchronous dispatch, so dispatches are cheap and pipelined
and host reads are the expensive unit:

  * decode: ONE BLOCK of K steps for the whole slot batch [max_num_seqs] —
    paged attention + on-device sampling, the sampled token feeding the
    next step on the device, no host read inside the block. Under
    decode_pool_mode="scatter" each step writes its K/V into the pool;
    under "local" the pool stays read-only for the block, each step's K/V
    go into per-layer block-local buffers that the attention kernel merges
    with the pool, and one write commits them at the block's end. Up to two
    blocks are kept in flight (the copy of block i runs on a side stream
    and overlaps block i+1's compute), so steady-state decode costs ONE
    device->host copy per K*B tokens. Tokens speculated past a stop are
    discarded host-side.
  * prefill: chunked + bucketed + BATCHED — chunks from several waiting
    sequences are packed into one [B_pf, bucket] dispatch with the first
    token sampled on-device. Chunks that do not complete a prompt need no
    host read at all.
  * mixed: when both prefill chunks and decode lanes are runnable, ONE
    ragged forward over a flat token buffer serves both.
  * prefix cache: PageAllocator keys pages by chained block hashes
    (llm/tokens.py) and emits stored/removed events.
  * preemption: on page exhaustion the newest-admitted sequence is
    preempted — its full blocks are committed (cheap resume via prefix
    cache), pages released, and the request requeued; it resumes decoding
    from its pending token without re-emitting.
  * disaggregation: a request with `disagg_params.return_kv` is prefilled
    only; its first token leaves with the prompt's KV pages — staged on the
    engine's `data_plane` (`llm/kv_transfer.py`) behind a descriptor when it
    has one and the caller can pull (`kv_pull`), else inline. The decode
    side enters through `generate_decode_from_pull` / `_from_kv` /
    `_resume`: it allocates the prompt's pages, injects the pulled chunks
    while the batch keeps stepping, and decodes on from the prefill
    worker's first token; any failed pull falls back to a local prefill.
  * KVBM (`kvbm/`, when `kvbm_host_blocks` / `kvbm_disk_blocks` are set):
    every committed block is written through to the host tier (G2, one
    pinned tensor) and cascades to the disk tier (G3); one gather a step
    copies the step's committed pages to the host on the side stream.
    Admission probes the tiers — and, with the announcement mesh, peer
    workers' tiers (G4) — for the blocks the device prefix cache missed and
    injects the hits into fresh pages before prefill. With the mesh's
    session checkpointer on (`DYN_KV_CHECKPOINT`), each committed block is
    also replicated into a peer's host tier.
  * durable sessions: with incremental commit a live stream's full blocks
    reach the prefix cache and the tiers as decode fills them. A migrated
    request (`req.migration` > 0, the retry of a stream whose worker died)
    is classified at admission by where its prefix came from — checkpoint,
    peer, local or recompute — and the tokens it really recomputes are
    counted. Its tail past the reused prefix (at most two pages) is
    recomputed decode-shaped, so the resumed stream is the one that died,
    bit for bit (scatter pools, unquantized).
  * role morphing: `morph(role)` re-roles the live engine prefill <->
    decode (serving -> draining-role -> flipped -> warm -> serving). Streams
    of a role that goes away are severed with StreamSevered, which the
    request plane codes as `draining`, so each caller's migration resumes
    the session on a peer; any failure but `faults.MorphCrash` rolls the
    role back.
  * speculative decoding (`spec_mode="ngram"`, engine/spec.py): each
    decode block is `spec_rounds` draft-verify rounds; a lane drafts d
    tokens from the most recent n-gram match in its on-device history ring
    and verifies all 1+d in ONE batched-prefill pass (T = 1+d), accepting
    the longest matching prefix, so a greedy stream is the plain one token
    for token. In the fused mixed step a spec lane packs 1+d one-token
    verify rows on the ragged kernel (a staircase: row j attends its
    siblings 0..j-1) and is accepted on the host.
  * guided decoding (llm/guided.py): a request's `guided` spec compiles off
    the event loop to a token FSM; its lane's admissible-token bitmask rides
    the prefill, a single-step decode and the mixed step, and the FSM
    advances on every emitted token.
  * multi-LoRA (models/lora.py, models/lora_pool.py): `register_adapters`
    puts adapters behind a fixed-slot device stack; a request's `lora_name`
    pins its adapter's slot for the life of the stream, and the slot index
    rides the prefill (per lane), the mixed step (per row, spec verify rows
    too), a K-step decode block that writes the pool in place under either
    pool mode, and the guided single step. The adapter name salts the
    request's block hashes, so the prefix cache, the KV events, the KVBM
    tiers and the checkpointer never share KV across adapters.
  * model families: a `MoeConfig` model (tiny-moe, mixtral-8x7b,
    gptoss-120b) runs models/moe.py's forwards, the llama attention path
    with the top-k expert MLP, on every dispatch above (`self._model`, the
    reference's family switch); LoRA on an MoE model is refused, as the
    reference refuses it.
  * estimates: `estimated_prefill_wait_ms`, `estimated_req_ms` and
    `estimated_role_tok_s` read the scheduler's cost model; `stats()`
    publishes them as `sched_est_*`, which admission gates, the disagg
    router and planners read.

The KV pool is written in place. There is nothing to compile per shape, so
`warmup()` only builds the kernel library and drives one dispatch of each
kind. All device work runs on one executor thread so a blocking copy never
stalls the event loop. Multimodal requests arrive with their parts encoded
(llm/multimodal.py: placeholder tokens in the prompt, encoder rows on each
part); the batched prefill splices the rows over the placeholders'
embeddings (`emb_override`), and such a slot stays off the mixed step
until its prompt is in. Left out of this port so far (each raises a typed
error when asked for): the multi-host shard handoff, embeddings requests,
multi-host, tensor/pipeline/sequence parallelism. The KV pool may be stored at 8 or 4
bits (`kv_quant`): quantized on write, dequantized inside the attention
kernels. The weights may be int8 weight-only quantized (`quantize="int8"`,
models/quant.py): random weights are quantized on the device as each
matrix is drawn; loaded ones arrive quantized.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import dataclasses
import logging
import os
import secrets
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from functools import partial
from typing import Any, AsyncIterator, Callable, Dict, List, Optional

import numpy as np
import torch

from ..llm.mocker.kv_manager import KvEvent
from ..llm.protocols import Annotated, LLMEngineOutput, PreprocessedRequest
from ..llm.tokens import TokenBlockSequence, salt_hash
from ..models import llama, moe
from ..models.lora_pool import LoraPool, LoraPoolError
from ..models.quant import is_quant, param_bytes
from ..ops.hopper_ragged_attention import ragged_tile_q
from ..ops.paged_attention import attention_counts
from ..ops.kv_quant import (
    QuantKV,
    device_pages,
    extract_pages,
    inject_pages,
    kv_page_bytes,
    kv_write_all_layers,
    pack_pages,
    resolve_kv_quant,
)
from ..runtime import faults
from ..runtime.config import env_bool, env_float, env_int
from ..runtime.engine import Context
from ..runtime.metrics import (
    SCHED_EST_DECODE_TOK_S,
    SCHED_EST_PREFILL_TOK_S,
    SCHED_EST_REQ_MS,
    SCHED_EST_TTFT_MS,
)
from ..runtime.push_router import request_excluded_instances
from ..runtime.request_plane import StreamSevered
from .bucketing import next_pow2 as _next_pow2
from .config import EngineConfig, UnsupportedConfigError
from .kv_cache import PageAllocator, alloc_kv_arrays
from .sampling import SamplingParams, penalized, sample_lp, unpack_mask
from .sampling import split as key_split
from .spec import hist_write, ngram_draft, verify_accept
from .scheduler import SlaConfig, StepPlanner

logger = logging.getLogger(__name__)


def _log_land_failure(fut: concurrent.futures.Future) -> None:
    if fut.exception() is not None:
        logger.error("LoRA adapter rows failed to land", exc_info=fut.exception())


SCRATCH_PAGE = 0  # physical page 0 is the dump target for masked lanes


class UnsupportedRequestError(ValueError):
    """A request field asks for a feature this port has not implemented
    (embeddings, unknown `disagg_params` keys) or one this engine's
    configuration cannot serve (guided decoding or a LoRA adapter on a
    split-only speculative engine, penalties or logprobs under speculative
    decoding). Raised from `generate`, never silently dropped. (A LoRA
    request refused for its adapter — unknown, pool full of pinned slots, a
    failed onboard — or for asking for guided decoding beside it, and a
    multimodal request refused for its parts, are answered with the
    reference's error item instead.)"""


class MultimodalRequestError(ValueError):
    """A multimodal request the reference answers with an error item: a
    part without encoder embeddings or a position, an embedding of the
    wrong width, or image parts beside guided decoding. `generate` yields
    it as `Annotated.from_error` (image parts beside a LoRA adapter are
    refused by `_acquire_lora`, in the reference's order)."""


DISAGG_PARAMS = ("return_kv", "kv_pull", "kv_stream")  # the keys served


class _EvenTokensFsm:
    """A one-state token FSM admitting the even token ids: warmup's guided
    request takes the masked prefill and decode without compiling a spec
    over the vocabulary."""

    start_state = 0

    def __init__(self, vocab: int):
        self._row = np.arange(vocab) % 2 == 0

    def allowed(self, state: int) -> np.ndarray:
        return self._row

    def advance(self, state: int, token: int) -> int:
        return state


@dataclass
class _Slot:
    """One decode slot (host bookkeeping)."""

    request_id: str
    queue: asyncio.Queue
    context: Context
    prompt: List[int]
    max_tokens: int
    min_tokens: int
    eos_ids: List[int]
    ignore_eos: bool
    stop_token_ids: List[int]
    seq: TokenBlockSequence
    kv_prompt: List[int] = field(default_factory=list)  # tokens whose KV
    # prefill computes; == prompt for fresh slots, prompt+generated-minus-
    # pending for preempted slots
    pages: List[int] = field(default_factory=list)
    committed_hashes: List[int] = field(default_factory=list)
    prefill_pos: int = 0
    generated: int = 0
    last_token: int = 0
    slot_idx: int = -1
    admit_seq: int = 0  # admission order; preemption victims = newest
    done: bool = False
    resume_token: Optional[int] = None  # preempted: continue with this token
    return_kv: bool = False  # prefill role: ship KV pages with the 1st token
    kv_pull: bool = False  # prefill role: caller can pull via the data plane
    kv_stream: bool = False  # prefill role: caller wants the EARLY-staged
    # streamed handoff (descriptor at admission, chunks as pages commit)
    kv_stream_tid: Optional[str] = None  # live streamed stage's transfer id
    kv_stream_desc: Optional[dict] = None  # its descriptor (resent at emit)
    preloaded: Optional[tuple] = None  # decode role: (first_tok, k, v, n_tokens)
    pull_desc: Optional[dict] = None  # decode role: pull-path descriptor
    first_token_fut: Optional[asyncio.Future] = None  # decode role, streamed
    # handoff: resolves to the prefill-produced first token (None = abort)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    want_logprobs: bool = False  # attach sampled-token logprobs to emissions
    sample_seed: int = 0  # per-request sampling seed (SamplingParams.seed)
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    repetition_penalty: float = 1.0
    want_top_logprobs: int = 0  # top-k alternatives per token (max 5)
    # scheduler bookkeeping: priority scales the TTFT target (each +1
    # halves it); sched_deadline is the EDF key; sched_skips counts
    # dispatches this candidate was passed over (the starvation guard's
    # aging signal) and resets on every granted chunk
    priority: int = 0
    arrival_s: float = 0.0
    sched_deadline: float = 0.0
    sched_skips: int = 0
    tenant: str = ""
    kv_holder: Optional[dict] = None  # router holder hint for a peer onboard
    onboard: Optional[tuple] = None  # KVBM: (fresh pages, hashes) to inject
    migration: int = 0  # > 0: the retry of a stream whose worker died
    migration_counted: bool = False  # its resume is classified once
    replay: bool = False  # migrated: its tail is recomputed decode-shaped
    mm: Optional[List[tuple]] = None  # multimodal splices: (position, emb [n, H] f32)
    guided_fsm: Optional[Any] = None  # llm/guided.TokenFsm (structured output)
    guided_state: int = 0  # current FSM state; advanced per emitted token
    lora_idx: int = 0  # adapter slot in the LoRA stack (0 = base model)
    lora_name: str = ""  # adapter pinned in the LoraPool ("" = no pin)


class StreamedPullHandle:
    """Decode-side handle of an early (streamed) disagg pull: the pull starts
    while the prefill worker is still computing, off its early descriptor.
    The disagg handler resolves it with the prefill's first token once that
    arrives (`set_first_token`), or abandons it (`abort`) when the prefill
    stream fails or the transfer was re-staged under another id."""

    def __init__(self, engine: "TorchEngine", slot: _Slot, transfer_id: str):
        self._engine = engine
        self._slot = slot
        # the handle keeps its own reference to the future: the pull task
        # detaches slot.first_token_fut before awaiting it, and a token or
        # abort arriving after that must still resolve it
        self._fut = slot.first_token_fut
        self.transfer_id = transfer_id

    def set_first_token(self, token: int):
        if self._fut is not None and not self._fut.done():
            self._fut.set_result(int(token))

    def abort(self):
        """Abandon the early pull: the slot releases and the handler falls
        back to the serial or local path."""
        eng, slot = self._engine, self._slot
        if self._fut is not None and not self._fut.done():
            self._fut.set_result(None)
        slot.done = True
        if slot.slot_idx >= 0 and eng.slots[slot.slot_idx] is slot:
            eng._release_slot(slot)
        eng._wake.set()

    async def stream(self):
        """The decode stream (same contract as engine.generate)."""
        slot = self._slot
        try:
            while True:
                item = await slot.queue.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item  # a morph's StreamSevered, see TorchEngine._drain
                yield item
        finally:
            slot.done = True
            self._engine._wake.set()


@dataclass
class _DeviceResult:
    """Tensors a dispatch left on the device for a later host read, and the
    CUDA event recorded after the dispatch (None on the CPU)."""

    tensors: tuple
    event: Optional[Any] = None


class TorchEngine:
    """Continuous-batching engine with the reference's
    `generate(request, context)` interface."""

    def __init__(
        self,
        config: EngineConfig,
        model_config: Optional[llama.LlamaConfig] = None,
        params: Optional[dict] = None,
        event_sink: Optional[Callable[[KvEvent], None]] = None,
        device="cuda",
    ):
        bad = config.unsupported_fields()
        if bad:
            raise UnsupportedConfigError(
                f"EngineConfig fields not supported by the PyTorch/CUDA port yet: {bad}"
            )
        # resolve the auto sentinels into a COPY — the caller's config keeps
        # them. decode_block_unroll is kept as given: it has no effect here.
        config = dataclasses.replace(
            config, decode_pool_mode=config.decode_pool_mode or "scatter",
            kv_quant=resolve_kv_quant(config.kv_quant),
        )
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "TorchEngine(device='cuda') needs a CUDA device; pass "
                "device='cpu' explicitly to run on the CPU"
            )
        self._on_cuda = self.device.type == "cuda"
        self.model_config = model_config or _resolve_model(config.model)
        c = self.model_config
        # family dispatch, as the reference's: MoeConfig subclasses
        # LlamaConfig, and models/moe.py has the same forward signatures
        self._model = moe if isinstance(c, moe.MoeConfig) else llama
        if config.quantize not in (None, "", "int8"):
            raise ValueError(f"unknown quantize mode {config.quantize!r}")
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            # int8: each matrix is quantized as it is drawn (the values of
            # init-then-quantize_tree), so the bf16 tree is never resident
            params = self._model.init_params(c, gen, device=self.device,
                                             quantize=config.quantize or None)
        self.params = params
        self.weight_bytes = param_bytes(params)
        # the served vocabulary (workers set it to the model card's tokenizer)
        self.tokenizer = None
        if config.num_pages <= 0:
            config = dataclasses.replace(
                config, num_pages=_auto_num_pages(params, c, config, self.device)
            )
            self.config = config
        # +1: physical page 0 is scratch; allocator page i -> physical i + 1
        self.kv_k, self.kv_v = alloc_kv_arrays(
            c.num_layers, config.num_pages + 1, config.page_size,
            c.num_kv_heads, c.head_dim, dtype=c.dtype, device=self.device,
            kv_quant=config.kv_quant,
        )
        self.allocator = PageAllocator(
            config.num_pages, config.page_size, event_sink=event_sink
        )
        # KVBM host/disk tiers: write-through offload of committed blocks,
        # onboard at admission when the device prefix cache misses
        self.kvbm = None
        if config.kvbm_host_blocks > 0 or config.kvbm_disk_blocks > 0:
            from ..kvbm import KvBlockManager, KvbmConfig, KvbmConnector
            from ..llm.kv_transfer import wire_dtype as to_torch

            wire_shape, wire_dtype = self._kv_wire_meta()
            manager = KvBlockManager(
                KvbmConfig(host_blocks=config.kvbm_host_blocks,
                           disk_blocks=config.kvbm_disk_blocks,
                           disk_path=config.kvbm_disk_path),
                tuple(wire_shape), to_torch(wire_dtype), kv_format=config.kv_quant,
                pin=self._on_cuda,
            )
            self.kvbm = KvbmConnector(self, manager)
        B, P = config.max_num_seqs, config.max_pages_per_seq
        self.page_tables = np.zeros((B, P), np.int32)
        self.seq_lens = np.zeros((B,), np.int32)
        self.tokens = np.zeros((B,), np.int32)
        self.temps = np.zeros((B,), np.float32)
        self.top_ks = np.zeros((B,), np.int32)
        self.top_ps = np.ones((B,), np.float32)
        self.seeds = np.zeros((B,), np.int64)  # per-lane u32 sampling seeds
        self.presence = np.zeros((B,), np.float32)
        self.frequency = np.zeros((B,), np.float32)
        self.repetition = np.ones((B,), np.float32)
        # recent-token ring per lane (penalties window; pad = -1). Host
        # mirror for reset/patch; the device copy rides the decode carry.
        self.recent = np.full((B, config.penalty_window), -1, np.int32)
        self.slots: List[Optional[_Slot]] = [None] * B
        self._free_slots = list(range(B - 1, -1, -1))
        self._waiting: List[_Slot] = []
        self._step_task: Optional[asyncio.Task] = None
        self._wake = asyncio.Event()
        self._closed = False
        self.num_requests = 0
        self.num_preemptions = 0
        # blocks reused MID-prefix from concurrent same-prefix requests
        # (_try_skip_ahead; admission-time hits count in the allocator)
        self.prefix_skip_ahead_blocks = 0
        self._admit_counter = 0
        self.scheduler = StepPlanner(
            config,
            SlaConfig.from_env(
                policy=config.sched_policy,
                ttft_target_ms=config.ttft_target_ms,
                itl_target_ms=config.itl_target_ms,
            ),
        )
        self._mixed_enabled = (
            config.mixed_dispatch if config.mixed_dispatch is not None
            else env_bool("DYN_MIXED_DISPATCH", True)
        )
        self._incremental_commit = (
            config.incremental_commit
            if config.incremental_commit is not None else True
        )
        # a migrated resume recomputes its un-checkpointed tail with the
        # decode forward (see _dispatch_replays): exact where the decode
        # block writes the pool in place and unquantized
        self._replay_tail = (config.decode_pool_mode == "scatter"
                             and config.kv_quant == "none")
        # row-start alignment of the flat packer: whatever the ragged
        # kernel asks for (packer and kernel agree through this function)
        self._mixed_align = ragged_tile_q(c.dtype)
        # ONE fixed row bucket: the row axis only sizes scalar operands.
        # Under spec every decode lane may pack 1 + spec_draft_len verify rows.
        rows_per_lane = 1 + (config.spec_draft_len if config.spec_mode else 0)
        self._mixed_row_bucket = _next_pow2(
            config.max_num_seqs * rows_per_lane + config.max_prefill_batch
        )
        # fused-vs-split visibility (stats()): is the fused path actually
        # taken, and what padding does each path pay per step
        self.mixed_steps = 0
        self.split_steps = 0
        self.mixed_padded_tokens = 0
        self.mixed_real_tokens = 0
        self.split_padded_tokens = 0
        self.split_real_tokens = 0
        self.mixed_rows_plain = 0
        self.mixed_rows_guided = 0
        self.mixed_rows_spec = 0
        self.mixed_rows_lora = 0
        # multi-LoRA: the adapter pool (set by register_adapters), each
        # lane's adapter slot (host mirror, the operand of a LoRA block) and
        # the requests served with one
        self._lora_pool: Optional[LoraPool] = None
        self.lora_idx = np.zeros((B,), np.int32)
        self.lora_requests = 0
        # speculative decoding: host mirror of the device history ring, the
        # acceptance counters, and the key chain of the spec blocks' draws
        # (threefry key words of PRNGKey(seed + 1); the reference splits one
        # engine key that its prefill and mixed dispatches also split)
        self.hist = (
            np.zeros((B, config.spec_hist), np.int32) if config.spec_mode else None
        )
        self._hist_dev = None
        self.spec_num_drafts = 0
        self.spec_num_draft_tokens = 0
        self.spec_num_accepted_tokens = 0
        self._spec_key = (0, (config.seed + 1) & 0xFFFFFFFF)
        # guided decoding: the FSM compiler over the served vocabulary
        # (built on first use from self.tokenizer) and a request counter
        self._guided = None
        self.guided_requests = 0
        self._last_prefill_shape = None  # (padded, real) of the latest dispatch
        self._last_decode_shape = None
        # set by _dispatch_mixed when only the in-flight decode pipeline
        # blocks fusing: the step loop holds the split prefill one step so
        # the drained pipeline fuses next step instead
        self._mixed_wait_drain = False
        # per-dispatch-type device occupancy: {tag: (count, seconds)}. On
        # CUDA the seconds come from events recorded around each dispatch
        # (device time); on the CPU from the host clock.
        self._dev_time: Dict[str, tuple] = {}
        self._timing_lock = threading.Lock()
        self._pending_timings: deque = deque()
        self.emit_batches = 0
        self.emit_tokens = 0
        # decode pipeline: device-resident carry (tokens/positions/seq_lens)
        # + up to two in-flight K-step blocks
        self._carry = None  # (tokens_dev, positions_dev, seq_lens_dev)
        self._carry_valid = False
        # per-lane dirt: admissions/finishes/page-growth touch only their
        # lanes via the patch program — a full invalidation would drain the
        # block pipeline and re-upload everything
        self._dirty_lanes: set = set()  # full lane state from host
        self._dirty_tables: set = set()  # page-table row only (lane carry
        # on device is NEWER than host and must not be overwritten)
        self._tables_dev = None
        self._samp_dev = None
        self._pen_dev = None  # [B, W] recent-token ring (penalties)
        self._inflight: deque = deque()  # [{"lanes": [...], "toks": result}]
        # pending prefill completions awaiting their first-token fetch
        self._pending_prefill: List[dict] = []
        # all device dispatches run on this single thread, host reads on a
        # separate one, so a blocking copy never delays the next dispatch
        self._device_exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-step"
        )
        self._fetch_exec = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="torch-fetch"
        )
        self._copy_stream = None  # side stream for device->host copies
        self._step_idx = None  # local block: one-element step tensors on the device
        # disaggregation: the KV data plane this engine stages prefilled
        # pages on (set by the worker; None = inline payloads), the pull
        # tasks in flight, and the handoff's counters
        self.data_plane = None
        self._bg_tasks: set = set()
        self.kv_pulls_completed = 0
        self.kv_pages_pulled = 0
        self.kv_pull_fallbacks = 0
        self.kv_pull_s = 0.0  # wall seconds of completed pulls
        self.kv_pages_extracted = 0
        self.kv_pages_injected = 0
        self.kv_format_mismatches = 0
        # streamed handoff: decode-side overlap evidence, prefill-side stages
        self.disagg_streamed_handoffs = 0
        self.disagg_chunks_before_first_token = 0
        self.disagg_first_token_before_last_chunk = 0
        self.kv_streamed_stages = 0
        self.kv_streamed_fallbacks = 0
        # KVBM tier-chain effectiveness: G1 = device prefix-cache hits and
        # misses at admission; the onboard latency histogram (tier load +
        # inject); onboards that fell back to prefill (a block evicted
        # between probe and load, an injected fault, a peer of another
        # KV format)
        self.kvbm_g1_hit_blocks = 0
        self.kvbm_g1_miss_blocks = 0
        self._onboard_hist_bounds = (1.0, 5.0, 20.0, 100.0, 500.0)
        self.kvbm_onboard_hist = [0] * (len(self._onboard_hist_bounds) + 1)
        self.kvbm_onboard_ms_sum = 0.0
        self.kvbm_onboard_count = 0
        self.kv_onboard_fallbacks = 0
        self._kvbm_futs: List[concurrent.futures.Future] = []  # gathers to await
        # migration accounting: streams resumed here after a worker death,
        # the tokens they really re-prefilled and where their prefix came from
        self.migrations_resumed = 0
        self.migration_replayed_tokens = 0
        self.resume_source_checkpoint = 0
        self.resume_source_peer = 0
        self.resume_source_local = 0
        self.resume_source_recompute = 0
        # role morphing: the live role and the state machine's position,
        # written only by morph()
        self._role = config.role
        self._morph_state = "serving"
        self._severed_queues: List[asyncio.Queue] = []
        self.morphs_completed = 0
        self.morphs_rolled_back = 0
        self.morph_drained_sessions = 0
        self.morph_last_duration_s = 0.0
        # held for each step: a morph severs streams between two steps,
        # never while a dispatch of theirs is in flight
        self._step_lock = asyncio.Lock()

    # ------------------------------------------------------------------ #
    # lifecycle / interface
    # ------------------------------------------------------------------ #

    def start(self):
        if self._step_task is None:
            self._step_task = asyncio.create_task(self._step_loop())

    async def close(self):
        self._closed = True
        self._wake.set()
        for task in list(self._bg_tasks):
            task.cancel()
        if self._bg_tasks:
            await asyncio.gather(*self._bg_tasks, return_exceptions=True)
        if self._step_task:
            self._step_task.cancel()
            try:
                await self._step_task
            except asyncio.CancelledError:
                pass
            self._step_task = None
        if self.kvbm is not None:
            # flush staged commits, drain in-flight offloads, stop the tier
            # thread, then persist the G3 index and close its files
            await self._kvbm_flush()
            for _ in range(500):
                if self.kvbm.pending_offloads() == 0:
                    break
                await asyncio.sleep(0.01)
            self.kvbm.shutdown()
            self.kvbm.manager.close()
        self._device_exec.shutdown(wait=True)
        self._fetch_exec.shutdown(wait=True)

    async def warmup(self) -> int:
        """Build the kernel library (on CUDA) and drive one dispatch of each
        kind — batched prefill, decode reset/patch/block (the spec block on
        a spec engine), the mixed step, and a guided request's masked
        prefill and decode — through the real serving path before serving
        traffic. Returns the number of device dispatches made. The warmup
        prompts' cached pages are evicted from the device afterwards (KVBM
        tiers keep theirs)."""
        if self._on_cuda:
            from ..ops import _build

            await asyncio.get_running_loop().run_in_executor(
                self._device_exec, _build.load_library
            )
        rng = np.random.RandomState(0xD74A)
        vocab = self.model_config.vocab_size
        K = self.config.decode_block_steps
        isl = max(min(self.config.prefill_buckets[0] - 8,
                      self.config.max_model_len - 2 * K - 4), 4)

        async def _drain(first_token: Optional[asyncio.Event], lora_name=None):
            req = PreprocessedRequest(
                token_ids=rng.randint(5, max(vocab - 1, 6), size=isl).tolist(),
                stop_conditions={"max_tokens": 2 * K + 2, "ignore_eos": True},
                sampling_options={"temperature": 1.0, "seed": 1},
                lora_name=lora_name,
            ).to_dict()
            async for _ in self.generate(req, Context()):
                if first_token is not None:
                    first_token.set()

        before = self._dispatch_count()
        # a staggered pair: the second arrives while the first decodes, so
        # the fused mixed step runs (or, with mixed dispatch off, the
        # lane patch beside a running block). With adapters registered a
        # second pair leads with a LoRA request: its prefill, block and
        # mixed rows carry the adapter operand.
        pairs = [None] + ([self.lora_names()[0]] if self.lora_names() else [])
        for lora_name in pairs:
            started = asyncio.Event()
            t1 = asyncio.create_task(_drain(started, lora_name))
            await started.wait()
            t2 = asyncio.create_task(_drain(None))
            await asyncio.gather(t1, t2)
        if not self.config.spec_mode or self._mixed_enabled:
            # a guided request: the masked prefill and decode, on a fixed
            # mask (no FSM compile: the first real guided request pays its
            # own, off the event loop)
            req = PreprocessedRequest(
                token_ids=rng.randint(5, max(vocab - 1, 6), size=isl).tolist(),
                stop_conditions={"max_tokens": 3},
                sampling_options={"temperature": 1.0},
                guided={"kind": "regex", "regex": "[ab]*"},
            )
            req._compiled_fsm = _EvenTokensFsm(vocab)
            async for _ in self._drain(self._entry_slot(req, Context())):
                pass
        # the device prefix cache only: a warm disk tier survives the warmup
        self.allocator.clear_cache()
        return self._dispatch_count() - before

    def _dispatch_count(self) -> int:
        self._drain_timings(wait=True)
        with self._timing_lock:
            return sum(
                cnt for tag, (cnt, _) in self._dev_time.items() if tag != "fetch"
            )

    def _check_request(self, req: PreprocessedRequest) -> None:
        bad = ["embed"] if req.embed else []
        bad += [f"disagg_params.{k}" for k in (req.disagg_params or {})
                if k not in DISAGG_PARAMS]
        if bad:
            raise UnsupportedRequestError(
                f"request fields not supported by the PyTorch/CUDA port yet: {bad}"
            )
        err = self._check_spec_sampling(req) or self._check_guided(req)
        if req.lora_name and self.config.spec_mode and not self._mixed_enabled:
            # fused verify rows carry a row's adapter slot; the split spec
            # block has no adapter operand
            err = ("LoRA is incompatible with speculative decoding (spec_mode) "
                   "without the mixed dispatch (request field lora_name; run "
                   "the worker without --spec)")
        if err is not None:
            raise UnsupportedRequestError(err)

    def _check_spec_sampling(self, req: PreprocessedRequest) -> Optional[str]:
        """Penalties and logprobs have no hook in the speculative verify
        pass: a spec engine refuses them rather than ignore them."""
        if not self.config.spec_mode:
            return None
        s = req.sampling_options or {}
        if (s.get("presence_penalty") or s.get("frequency_penalty")
                or (s.get("repetition_penalty") or 1.0) != 1.0):
            return ("sampling penalties are not supported with speculative "
                    "decoding (the verify pass has no penalty hook); run the "
                    "worker without --spec")
        if s.get("logprobs"):
            return ("logprobs are not supported with speculative decoding "
                    "(the verify pass emits accepted drafts without per-token "
                    "logprobs); run the worker without --spec")
        return None

    def _check_guided(self, req: PreprocessedRequest) -> Optional[str]:
        """Guided rows are single-token and host-authoritative each step, so
        under spec they ride the fused mixed step beside the verify rows; a
        split-only spec engine refuses them (dropping the constraint would
        be a wrong answer, not a degraded one)."""
        if req.guided and self.config.spec_mode and not self._mixed_enabled:
            return ("guided decoding is incompatible with speculative decoding "
                    "without the mixed dispatch (run the worker without --spec)")
        return None

    def _check_multimodal(self, req: PreprocessedRequest) -> Optional[str]:
        """None when the request is serveable; else the reference's refusal.
        Serveable: text only, or every part carries encoder embeddings and a
        placeholder position (the encode hop ran; llm/multimodal.py). The
        embeddings are converted once, here, and kept on the request as
        `_mm` [(position, [n, hidden] f32)] (a real encoder's are MBs of
        nested lists off the wire); the parts themselves are left as they
        came, so a request forwarded on (disagg) still packs."""
        if not req.multimodal:
            return None
        H = self.model_config.hidden_size
        splices = []
        for p in req.multimodal:
            if p.get("embedding") is None or p.get("position") is None:
                return (
                    f"model {self.config.model!r} needs encoder embeddings "
                    f"for multimodal parts (type={p.get('type')!r}); "
                    f"deploy an encode worker (dynamo_tpu.encode_worker)"
                )
            # a malformed embedding must fail THIS request at admission:
            # inside the shared prefill dispatch it would fail every
            # co-active request
            try:
                arr = np.asarray(p["embedding"], np.float32)
            except (ValueError, TypeError):
                return "multimodal embedding is not a numeric [n, hidden] array"
            if arr.ndim != 2 or arr.shape[1] != H or arr.shape[0] == 0:
                return (
                    f"multimodal embedding shape {arr.shape} does not match "
                    f"[n>0, hidden={H}] — encode worker configured for a "
                    f"different model?"
                )
            splices.append((int(p["position"]), arr))
        if req.guided:
            return "guided decoding cannot be combined with multimodal parts"
        req._mm = splices
        return None

    # -- multi-LoRA ------------------------------------------------------ #

    def register_adapters(self, adapters) -> None:
        """Install LoRA adapters (models/lora.LoraAdapter list) behind the
        fixed-slot pool (models/lora_pool.LoraPool), whose device stack the
        dispatches read: registration appends to the roster, and rosters
        larger than the slot count page on demand. In-flight LoRA streams
        keep their slots (they are pinned)."""
        if isinstance(self.model_config, moe.MoeConfig):
            raise ValueError("LoRA serving is not supported on MoE models yet")
        if self._lora_pool is None:
            slots = self.config.lora_pool_slots
            if slots is None:
                slots = env_int("DYN_LORA_POOL_SLOTS", 8)
            self._lora_pool = LoraPool(self.model_config, list(adapters), slots=slots,
                                       device=self.device)
        else:
            self._lora_pool.register(list(adapters))
        self._land_lora()

    def _land_lora(self) -> None:
        """Queue the pool's waiting adapter rows (an onboard, a rebuild) on
        the device thread. Every dispatch queued later runs after them, so
        the caller never waits for the copy."""
        if self._lora_pool.landing():
            self._device_exec.submit(
                self._timed(self._lora_pool.land, "lora_onboard")
            ).add_done_callback(_log_land_failure)

    def lora_names(self) -> List[str]:
        return self._lora_pool.known_names() if self._lora_pool is not None else []

    def _acquire_lora(self, req: PreprocessedRequest) -> None:
        """Check the request's adapter and PIN its slot in the pool (a
        resident adapter is a lookup; a cold one takes a slot here, and its
        rows land on the device thread ahead of the stream's first
        dispatch). A refusal
        the reference answers with an error item (`_check_request` raised
        for the configuration's) raises LoraPoolError with its message.
        Runs last among the entry's checks: a later refusal would leak the
        pin."""
        if req.lora_name not in self.lora_names():
            raise LoraPoolError(f"unknown LoRA adapter {req.lora_name!r}; available: "
                                f"{sorted(self.lora_names())}")
        if req.guided:
            raise LoraPoolError("guided decoding with a LoRA adapter is not supported yet")
        if req.multimodal:
            raise LoraPoolError("LoRA with multimodal content parts is not supported yet")
        req._lora_slot = self._lora_pool.acquire(req.lora_name)
        self._land_lora()

    def _release_lora_pin(self, slot: _Slot) -> None:
        """Unpin the stream's adapter, once (the name is cleared)."""
        if slot.lora_name and self._lora_pool is not None:
            self._lora_pool.release(slot.lora_name)
            slot.lora_name = ""

    def _lora_operand(self, idx: np.ndarray) -> Optional[dict]:
        """A LoRA dispatch's operand: the stack's tensors as the dispatch is
        built (a rebuild installs new ones and leaves these be) and the slot
        index of each lane or row. None when `idx` names no adapter."""
        if self._lora_pool is None or not idx.any():
            return None
        stack = self._lora_pool.stack
        return {"a": stack["a"], "b": stack["b"], "scale": stack["scale"], "idx": idx}

    def _dev_lora(self, op: Optional[dict]) -> Optional[dict]:
        """The operand with its index on the device (device thread)."""
        return None if op is None else dict(op, idx=self._dev(op["idx"]))

    def _guided_compiler(self):
        if self._guided is None:
            from ..llm.guided import GuidedCompiler
            from ..llm.tokenizers import ByteTokenizer

            self._guided = GuidedCompiler(
                self.tokenizer or ByteTokenizer(self.model_config.vocab_size))
        return self._guided

    def _compile_guided(self, req: PreprocessedRequest):
        """The request's token FSM (None when unguided); a spec the compiler
        rejects raises UnsupportedRequestError."""
        if not req.guided:
            return None
        try:
            return self._guided_compiler().compile(req.guided)
        except ValueError as e:
            raise UnsupportedRequestError(f"guided spec rejected: {e}") from e

    def _guided_lane_mask(self, fsm, state: int) -> np.ndarray:
        """fsm.allowed(state) trimmed or padded to the MODEL vocabulary (the
        tokenizer's may differ; logits rows past it are inadmissible)."""
        V = self.model_config.vocab_size
        row = fsm.allowed(state)
        if len(row) >= V:
            return row[:V]
        out = np.zeros((V,), bool)
        out[: len(row)] = row
        return out

    def _advance_guided(self, slot: _Slot, token: int) -> None:
        if slot.guided_fsm is not None:
            slot.guided_state = slot.guided_fsm.advance(slot.guided_state, token)

    def _new_slot(self, req: PreprocessedRequest, context: Context) -> _Slot:
        stop = req.stop_conditions or {}
        sampling = req.sampling_options or {}
        slot = _Slot(
            request_id=req.request_id or f"torch-{self.num_requests}",
            queue=asyncio.Queue(),
            context=context,
            prompt=list(req.token_ids),
            max_tokens=int(stop.get("max_tokens") or 128),
            min_tokens=int(stop.get("min_tokens") or 0),
            eos_ids=list(req.eos_token_ids or []),
            ignore_eos=bool(stop.get("ignore_eos")),
            stop_token_ids=list(stop.get("stop_token_ids") or []),
            # the adapter name salts the hash chain (the reference's lora_id
            # in the block hash): the prefix cache, the KV events, the KVBM
            # tiers and the checkpointer key on it, so two adapters sharing
            # a text prefix never share KV
            seq=TokenBlockSequence(
                req.token_ids, self.config.page_size,
                salt=salt_hash(req.lora_name.encode()) if req.lora_name else 0),
        )
        slot.kv_prompt = slot.prompt
        slot.mm = getattr(req, "_mm", None)
        slot.temperature = float(
            sampling.get("temperature", self.config.default_temperature) or 0.0
        )
        slot.top_k = int(sampling.get("top_k") or 0)
        slot.top_p = float(sampling.get("top_p") or 1.0)
        slot.want_logprobs = bool(sampling.get("logprobs"))
        slot.presence_penalty = float(sampling.get("presence_penalty") or 0.0)
        slot.frequency_penalty = float(sampling.get("frequency_penalty") or 0.0)
        slot.repetition_penalty = float(sampling.get("repetition_penalty") or 1.0)
        # explicit seed => reproducible output independent of co-batched
        # traffic (counter-based draws, sampling.py); else a random one —
        # concurrent identical unseeded requests must diverge
        seed = sampling.get("seed")
        slot.sample_seed = (
            int(seed) & 0xFFFFFFFF if seed is not None else secrets.randbits(32)
        )
        slot.want_top_logprobs = min(int(sampling.get("top_logprobs") or 0), 5)
        if req.guided:
            # compiled off the event loop by _entry_slot_async; the compiler's
            # cache answers the synchronous entries
            slot.guided_fsm = getattr(req, "_compiled_fsm", None) or self._compile_guided(req)
            slot.guided_state = slot.guided_fsm.start_state
            self.guided_requests += 1
        if req.lora_name:
            # the _acquire_lora pin moves to the slot: released once, when
            # the stream ends
            slot.lora_idx, req._lora_slot = req._lora_slot, None
            slot.lora_name = req.lora_name
            self.lora_requests += 1
        if len(slot.prompt) + slot.max_tokens > self.config.max_model_len:
            slot.max_tokens = max(self.config.max_model_len - len(slot.prompt), 1)
        slot.priority = int(req.priority or 0)
        slot.tenant = req.tenant or ""
        slot.kv_holder = req.kv_holder
        slot.migration = int(req.migration or 0)
        if slot.migration and self.kvbm is not None and self.kvbm.distributed is not None:
            # the retry names the worker(s) that lost this stream: the KV
            # fabric stops pulling from them too, so the onboard never dials
            # a corpse whose announcements outlive it
            for inst in request_excluded_instances(req):
                self.kvbm.distributed.note_peer_failure(inst)
        slot.arrival_s = time.monotonic()
        self.scheduler.assign_deadline(slot)
        return slot

    async def generate(self, request: Any, context: Context) -> AsyncIterator[dict]:
        async for item in self._serve(request, context):
            yield item

    async def _serve(self, request: Any, context: Context,
                     setup: Optional[Callable[[_Slot], None]] = None) -> AsyncIterator[dict]:
        """Every streaming entry: build the slot, let `setup` mark its entry
        path, stream it. A LoRA admission refusal and a multimodal refusal
        are answered with the reference's error item, so a frontend in front
        of either worker answers alike."""
        try:
            slot = await self._entry_slot_async(request, context)
        except (LoraPoolError, MultimodalRequestError) as e:
            yield Annotated.from_error(str(e)).to_dict()
            return
        if setup is not None:
            setup(slot)
        async for item in self._drain(slot):
            yield item

    def _morph_guard(self):
        """Refuse new streams mid-morph the way the drain cut the live ones:
        StreamSevered rides the `draining` code, so the caller's migration
        re-routes instead of failing. ("warm" is admitted: warmup_role
        drives generate.)"""
        if self._morph_state in ("draining-role", "flipped"):
            raise StreamSevered(f"worker is morphing ({self._morph_state}); stream re-routed")

    def _entry_request(self, request: Any) -> PreprocessedRequest:
        """Refuse the entry mid-morph, coerce and check the request."""
        self._morph_guard()
        req = (
            request
            if isinstance(request, PreprocessedRequest)
            else PreprocessedRequest.from_dict(request)
        )
        self._check_request(req)
        if not req.token_ids:
            raise ValueError("request has no prompt tokens")
        mm_err = self._check_multimodal(req)
        if mm_err is not None:
            raise MultimodalRequestError(mm_err)
        return req

    async def _entry_slot_async(self, request: Any, context: Context) -> _Slot:
        """`_entry_slot` with a guided spec compiled OFF the event loop (the
        DFA construction and the vocabulary walk are pure Python and can
        take seconds on a cold schema; live streams must not stall)."""
        req = self._entry_request(request)
        if req.guided:
            req._compiled_fsm = await asyncio.to_thread(self._compile_guided, req)
        return self._entry_slot(req, context, checked=True)

    def _entry_slot(self, request: Any, context: Context, checked: bool = False) -> _Slot:
        """Shared prologue of every entry: refuse it mid-morph, coerce and
        check the request (unless `checked`), build its slot."""
        req = request if checked else self._entry_request(request)
        self.start()
        if req.lora_name:
            self._acquire_lora(req)
        slot = self._new_slot(req, context)
        disagg = req.disagg_params or {}
        slot.return_kv = bool(disagg.get("return_kv"))
        slot.kv_pull = bool(disagg.get("kv_pull"))
        slot.kv_stream = bool(disagg.get("kv_stream"))
        return slot

    def _enqueue(self, slot: _Slot) -> None:
        self.num_requests += 1
        self._waiting.append(slot)
        self._wake.set()

    async def _drain(self, slot: _Slot) -> AsyncIterator[dict]:
        """Shared epilogue: enqueue the slot and yield its stream until the
        terminal None, marking it done on consumer teardown."""
        self._enqueue(slot)
        try:
            while True:
                item = await slot.queue.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    # _sever_all's StreamSevered: raised out of the handler,
                    # the request plane codes it `draining` and the caller
                    # migrates
                    raise item
                yield item
        finally:
            slot.done = True
            self._wake.set()

    async def generate_decode_from_kv(
        self, request: Any, context: Context, first_token: int,
        kv_k_pages, kv_v_pages, n_tokens: int,
    ) -> AsyncIterator[dict]:
        """Disagg decode entry: continue decoding from remotely prefilled KV
        that arrived inline (host pages in the wire layout). The first token
        was produced by the prefill worker and is NOT re-emitted."""
        def setup(slot):
            slot.preloaded = (first_token, kv_k_pages, kv_v_pages, n_tokens)

        async for item in self._serve(request, context, setup):
            yield item

    async def generate_decode_resume(
        self, request: Any, context: Context, first_token: int
    ) -> AsyncIterator[dict]:
        """Disagg decode entry without usable KV (a kv_format mismatch):
        prefill the prompt locally and resume from the prefill worker's
        already-emitted first token — the fallback a failed pull takes,
        entered before any foreign byte is read."""
        def setup(slot):
            slot.generated = 1
            slot.last_token = first_token
            slot.seq.append(first_token)
            self._advance_guided(slot, first_token)
            slot.resume_token = first_token
            slot.prefill_pos = 0

        async for item in self._serve(request, context, setup):
            yield item

    async def generate_decode_from_pull(
        self, request: Any, context: Context, first_token: int, desc: dict
    ) -> AsyncIterator[dict]:
        """Disagg decode entry, pull path: the prefill worker staged the KV
        on its data plane; the engine allocates the prompt's pages, then
        injects chunks as they land while the decode batch keeps stepping.
        Falls back to local prefill if the pull fails."""
        def setup(slot):
            slot.preloaded = (first_token, None, None, int(desc["n_tokens"]))
            slot.pull_desc = desc

        async for item in self._serve(request, context, setup):
            yield item

    def begin_streamed_pull(
        self, request: Any, context: Context, desc: dict
    ) -> StreamedPullHandle:
        """Disagg decode, streamed handoff: start pulling KV chunks off the
        prefill worker's EARLY descriptor while its prefill still runs, so
        the transfer overlaps the peer's compute; the first decode step
        dispatches once the last chunk and the first token have both
        landed. Mid-morph, or when the request's adapter is refused, it
        returns None: the serial path then refuses the stream. A request
        with multimodal parts also gets None (the splice does not ride the
        preload path): the serial handoff serves it."""
        mm = request.get("multimodal") if isinstance(request, dict) else request.multimodal
        if mm or self._morph_state in ("draining-role", "flipped"):
            return None
        try:
            slot = self._entry_slot(request, context)
        except LoraPoolError:
            return None
        slot.preloaded = (None, None, None, int(desc["n_tokens"]))
        slot.pull_desc = dict(desc)
        slot.first_token_fut = asyncio.get_running_loop().create_future()
        self._enqueue(slot)
        return StreamedPullHandle(self, slot, str(desc.get("transfer_id", "")))

    # ------------------------------------------------------------------ #
    # live role morphing
    # ------------------------------------------------------------------ #

    _ROLES = {
        "prefill": {"prefill"},
        "decode": {"decode"},
        "both": {"prefill", "decode"},
    }

    async def warmup_role(self, role: str) -> int:
        """Re-warm for the INCOMING role of a morph: drive the role's
        dispatches through the real generate path (a short-output prefill
        per bucket for prefill; two short-prompt decode blocks for decode)
        before the flipped worker takes traffic, as the reference does.
        The port compiles nothing per shape, so there is no compile
        baseline to refresh: this pays any first-dispatch cost of the new
        traffic mix. Returns the requests driven."""
        rng = np.random.RandomState(0xD74B)
        vocab = self.model_config.vocab_size
        K = self.config.decode_block_steps

        async def _drain(isl: int, max_tokens: int):
            req = PreprocessedRequest(
                token_ids=rng.randint(5, max(vocab - 1, 6), size=isl).tolist(),
                stop_conditions={"max_tokens": max_tokens, "ignore_eos": True},
                sampling_options={"temperature": 1.0},
            ).to_dict()
            async for _ in self.generate(req, Context()):
                pass

        buckets = [b for b in self.config.prefill_buckets
                   if b <= self.config.max_model_len] or [self.config.prefill_buckets[0]]
        n = 0
        if "prefill" in self._ROLES[role]:
            for b in buckets:
                await _drain(max(b - 8, 4), 1)
                n += 1
        if "decode" in self._ROLES[role]:
            for _ in range(2):
                await _drain(max(buckets[0] - 8, 4), K + 2)
                n += 1
        return n

    async def _await_sever_consumed(self, timeout_s: float):
        """Hold the flip until every severed stream's sentinel has been read
        by its consumer (which is now migrating); DYN_MORPH_DRAIN_TIMEOUT_S
        bounds the wait, and its expiry fails the morph (rollback)."""
        t0 = time.monotonic()
        while any(not q.empty() for q in self._severed_queues):
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"morph drain exceeded {timeout_s}s budget "
                                   "(severed stream consumer never woke)")
            await asyncio.sleep(0.01)
        self._severed_queues = []

    async def morph(self, target_role: str, *,
                    on_flip: Optional[Callable[[], Any]] = None) -> dict:
        """Re-role this live engine: serving -> draining-role -> flipped ->
        warm -> serving. Streams of a role that goes away are severed (their
        sessions resume on peers through migration); `on_flip` is awaited
        between the flip and the re-warm, so the worker moves its discovery
        lanes with the drain; `warmup_role` then warms the incoming role.

        Any exception mid-morph rolls the role back (the severed sessions
        have already moved: nothing to restore), except faults.MorphCrash,
        which propagates so the worker tears itself down like a crash."""
        if target_role not in self._ROLES:
            raise ValueError(f"unknown role {target_role!r}")
        if self._morph_state != "serving":
            raise RuntimeError(f"morph re-entered while {self._morph_state!r}")
        old_role = self._role
        if target_role == old_role:
            return {"from": old_role, "to": target_role, "drained": 0, "duration_s": 0.0}
        t0 = time.monotonic()
        self._morph_state = "draining-role"
        try:
            f = faults.FAULTS
            if f.enabled:
                # `worker.morph` mid-drain: `error` rolls back, `crash` crashes
                act = await f.on("worker.morph")
                if act == "crash":
                    raise faults.MorphCrash("injected crash mid-drain")
            drained = 0
            # sever when a lane the old role served goes away ("both" keeps
            # every lane, so growing into it drains nothing)
            if self._ROLES[old_role] - self._ROLES[target_role]:
                async with self._step_lock:
                    drained = self._sever_all(
                        f"worker morphing {old_role}->{target_role}; stream re-routed")
                if drained:
                    await self._await_sever_consumed(
                        env_float("DYN_MORPH_DRAIN_TIMEOUT_S", 10.0))
            self.morph_drained_sessions += drained
            self._morph_state = "flipped"
            if f.enabled:
                # `worker.morph` mid-flip: after the drain
                act = await f.on("worker.morph")
                if act == "crash":
                    raise faults.MorphCrash("injected crash mid-flip")
            self._role = target_role
            if on_flip is not None:
                await on_flip()
            self._morph_state = "warm"
            await self.warmup_role(target_role)
        except asyncio.CancelledError:
            raise
        except faults.MorphCrash:
            raise  # the worker tears itself down mid-morph: no rollback
        except Exception:
            self._role = old_role
            self._morph_state = "serving"
            self.morphs_rolled_back += 1
            raise
        self._morph_state = "serving"
        self.morphs_completed += 1
        self.morph_last_duration_s = time.monotonic() - t0
        return {"from": old_role, "to": target_role, "drained": drained,
                "duration_s": self.morph_last_duration_s}

    # ------------------------------------------------------------------ #
    # estimates (the cost model's view, published by stats())
    # ------------------------------------------------------------------ #

    def estimated_role_tok_s(self) -> Dict[str, float]:
        """Marginal per-role throughput from the cost model's EWMAs (s/token
        of prefill dispatches and decode blocks): what prices a planner's
        re-role. 0.0 while the model is cold on a kind."""
        pf = self.scheduler.cost.per_token("prefill")
        dc = self.scheduler.cost.per_token("block")
        return {"prefill": 1.0 / pf if pf else 0.0, "decode": 1.0 / dc if dc else 0.0}

    def estimated_prefill_wait_ms(self, n_new_tokens: int = 0) -> Optional[float]:
        """Estimated local TTFT contribution of the prefill queue for a
        hypothetical `n_new_tokens`-token arrival: the tokens still to
        prefill across admitted and waiting slots plus the new prompt, at
        the cost model's per-token prefill rate. None until a prefill was
        observed (the disagg router then keeps the static threshold)."""
        pending = int(n_new_tokens)
        for s in self.slots:
            if s is not None and not s.done and s.preloaded is None and s.onboard is None:
                pending += max(len(s.kv_prompt) - s.prefill_pos, 0)
        for s in self._waiting:
            pending += len(s.prompt)
        return self.scheduler.estimate_wait_ms(pending)

    def estimated_req_ms(self) -> float:
        """Marginal TTFT one more admitted request adds: a typical-length
        prompt at the observed per-token prefill rate (an admission gate's
        optimism-debt unit). 0.0 when the model is cold or nothing is
        queued."""
        per_tok = self.scheduler.cost.per_token("prefill")
        if per_tok is None:
            return 0.0
        lens = [len(s.kv_prompt) for s in self.slots if s is not None and not s.done]
        lens += [len(s.prompt) for s in self._waiting]
        if not lens:
            return 0.0
        return (sum(lens) / len(lens)) * per_tok * 1000.0

    def clear_kv_blocks(self) -> int:
        """Admin flush: evict every unreferenced prefix-cache page (emitting
        removed events) and drop the KVBM tiers. Active sequences keep their
        pages."""
        n = self.allocator.clear_cache()
        if self.kvbm is not None:
            n += self.kvbm.clear()
        return n

    def _kv_pool_bytes(self) -> int:
        """Device bytes of the K and V stores (ints plus scales when quantized)."""
        return sum(
            kv.nbytes if isinstance(kv, QuantKV) else kv.numel() * kv.element_size()
            for kv in (self.kv_k, self.kv_v)
        )

    def stats(self) -> dict:
        self._drain_timings()
        running = sum(1 for s in self.slots if s is not None)
        out = {
            "num_waiting_reqs": len(self._waiting),
            "num_running_reqs": running,
            "gpu_cache_usage_perc": self.allocator.active_pages / self.allocator.num_pages,
            "request_total_slots": self.config.max_num_seqs,
            "kv_quant": self.config.kv_quant,
            "kv_pool_bytes": self._kv_pool_bytes(),
            "weight_bytes": self.weight_bytes,
            **self.allocator.stats(),
        }
        out["num_preemptions"] = self.num_preemptions
        out["kv_format_mismatches"] = self.kv_format_mismatches
        if self.kvbm is not None:
            out.update(self.kvbm.stats())
            out["kvbm_g1_hit_blocks"] = self.kvbm_g1_hit_blocks
            out["kvbm_g1_miss_blocks"] = self.kvbm_g1_miss_blocks
            out["kvbm_onboard_count"] = self.kvbm_onboard_count
            out["kvbm_onboard_ms_sum"] = round(self.kvbm_onboard_ms_sum, 3)
            out["kvbm_onboard_hist"] = {
                **{f"le_{b:g}ms": n
                   for b, n in zip(self._onboard_hist_bounds, self.kvbm_onboard_hist)},
                "inf": self.kvbm_onboard_hist[-1],
            }
            out["kv_onboard_fallbacks"] = self.kv_onboard_fallbacks
        if self.data_plane is not None:
            out["kv_transfers_served"] = self.data_plane.transfers_served
            out["kv_bytes_served"] = self.data_plane.bytes_served
            out["kv_checkpoint_pushes"] = self.data_plane.checkpoint_pushes
            out["kv_checkpoint_blocks_received"] = self.data_plane.checkpoint_blocks_received
        out["kv_pulls_completed"] = self.kv_pulls_completed
        out["kv_pages_pulled"] = self.kv_pages_pulled
        # port-side handoff counters: pulls that fell back to a local
        # prefill, wall seconds of completed pulls, pages gathered for and
        # written from the data plane (their device/host time is under
        # dev_time's kv_extract / kv_inject)
        out["kv_pull_fallbacks"] = self.kv_pull_fallbacks
        out["kv_pull_s"] = round(self.kv_pull_s, 6)
        out["kv_pages_extracted"] = self.kv_pages_extracted
        out["kv_pages_injected"] = self.kv_pages_injected
        out["disagg_streamed_handoffs"] = self.disagg_streamed_handoffs
        out["disagg_chunks_before_first_token"] = self.disagg_chunks_before_first_token
        out["disagg_first_token_before_last_chunk"] = self.disagg_first_token_before_last_chunk
        out["disagg_streamed_handoff_ratio"] = round(
            self.disagg_first_token_before_last_chunk / self.disagg_streamed_handoffs, 4
        ) if self.disagg_streamed_handoffs else 0.0
        out["kv_streamed_stages"] = self.kv_streamed_stages
        out["kv_streamed_fallbacks"] = self.kv_streamed_fallbacks
        # what a worker death cost the streams resumed here
        out["migrations_resumed"] = self.migrations_resumed
        out["migration_replayed_tokens"] = self.migration_replayed_tokens
        out["resume_source_checkpoint"] = self.resume_source_checkpoint
        out["resume_source_peer"] = self.resume_source_peer
        out["resume_source_local"] = self.resume_source_local
        out["resume_source_recompute"] = self.resume_source_recompute
        est_role = self.estimated_role_tok_s()
        out[SCHED_EST_PREFILL_TOK_S] = round(est_role["prefill"], 1)
        out[SCHED_EST_DECODE_TOK_S] = round(est_role["decode"], 1)
        out["engine_role"] = self._role
        out["morph_state"] = self._morph_state
        out["morphs_completed"] = self.morphs_completed
        out["morphs_rolled_back"] = self.morphs_rolled_back
        out["morph_drained_sessions"] = self.morph_drained_sessions
        out["morph_last_duration_s"] = round(self.morph_last_duration_s, 3)
        # process-wide attention calls (kernel launches, plain calls)
        out["attention_calls"] = attention_counts()
        out["kv_skip_ahead_blocks"] = self.prefix_skip_ahead_blocks
        out["emit_batches"] = self.emit_batches
        out["emit_tokens"] = self.emit_tokens
        out["mixed_steps"] = self.mixed_steps
        out["split_steps"] = self.split_steps
        out["mixed_padded_tokens"] = self.mixed_padded_tokens
        out["split_padded_tokens"] = self.split_padded_tokens
        out["mixed_padding_frac"] = round(
            1.0 - self.mixed_real_tokens / self.mixed_padded_tokens, 4
        ) if self.mixed_padded_tokens else 0.0
        out["split_padding_frac"] = round(
            1.0 - self.split_real_tokens / self.split_padded_tokens, 4
        ) if self.split_padded_tokens else 0.0
        out["mixed_rows_plain"] = self.mixed_rows_plain
        out["mixed_rows_guided"] = self.mixed_rows_guided
        out["mixed_rows_spec"] = self.mixed_rows_spec
        out["mixed_rows_lora"] = self.mixed_rows_lora
        if self._lora_pool is not None:
            out.update(self._lora_pool.stats())
        if self.guided_requests:
            out["guided_requests"] = self.guided_requests
        if self.lora_requests:
            out["lora_requests"] = self.lora_requests
        if self.config.spec_mode:
            out["spec_num_drafts"] = self.spec_num_drafts
            out["spec_num_draft_tokens"] = self.spec_num_draft_tokens
            out["spec_num_accepted_tokens"] = self.spec_num_accepted_tokens
            out["spec_mean_accepted_len"] = (
                1.0 + self.spec_num_accepted_tokens / self.spec_num_drafts
                if self.spec_num_drafts else 0.0
            )
        denom = self.mixed_steps + self.split_steps
        out["mixed_coverage_frac"] = (
            round(self.mixed_steps / denom, 4) if denom else 1.0
        )
        out.update(self.scheduler.stats())
        est = self.estimated_prefill_wait_ms()
        out[SCHED_EST_TTFT_MS] = round(est, 1) if est is not None else 0.0
        out[SCHED_EST_REQ_MS] = round(self.estimated_req_ms(), 1)
        recent = self.scheduler.recent_decisions()
        if recent:
            out["sched_last_decision"] = recent[-1]
        with self._timing_lock:
            dev_time = dict(self._dev_time)
        out["dev_time"] = {
            tag: {"count": cnt, "seconds": round(tot, 6)}
            for tag, (cnt, tot) in dev_time.items()
        }
        for tag, (cnt, tot) in dev_time.items():
            out[f"dispatch_{tag}_count"] = cnt
            out[f"dispatch_{tag}_s"] = round(tot, 3)
        return out

    # ------------------------------------------------------------------ #
    # step loop
    # ------------------------------------------------------------------ #

    async def _step_loop(self):
        while not self._closed:
            has_active = any(s is not None for s in self.slots)
            if (
                not self._waiting
                and not has_active
                and not self._inflight
                and not self._pending_prefill
            ):
                self._wake.clear()
                await self._wake.wait()
                continue
            try:
                async with self._step_lock:
                    progressed = await self._step_once()
            except Exception as e:  # noqa: BLE001 — engine loop must not die silently
                logger.exception("engine step failed; failing active requests")
                self._fail_all(f"engine step failed: {type(e).__name__}: {e}")
                await asyncio.sleep(0.1)
                continue
            # yield to the event loop so streams flush between steps
            await asyncio.sleep(0 if progressed else 0.001)

    async def _step_once(self) -> bool:
        """One engine iteration: admit, dispatch (ONE fused mixed step when
        both prefill and decode are runnable, else prefill batch + decode
        block), then collect ALL host-needed values in one fetch."""
        self._admit_waiting()
        progressed = await self._run_injections()
        progressed |= await self._dispatch_replays()
        dispatched = False
        if await self._dispatch_mixed():
            progressed = True
        else:
            self._last_prefill_shape = self._last_decode_shape = None
            pf = False
            if not self._mixed_wait_drain:
                pf = await self._dispatch_prefill()
            progressed |= pf
            dispatched = await self._dispatch_decode()
            if pf and dispatched and self._last_prefill_shape \
                    and self._last_decode_shape:
                # a mixed-shaped step served by the split pair: account its
                # padding beside the fused path's
                self.split_steps += 1
                self.split_padded_tokens += (
                    self._last_prefill_shape[0] + self._last_decode_shape[0]
                )
                self.split_real_tokens += (
                    self._last_prefill_shape[1] + self._last_decode_shape[1]
                )
        # fetch the oldest block only once the pipeline is full or stalled,
        # so its host read overlaps the newer block's compute
        fetch_block = len(self._inflight) >= 2 or (
            bool(self._inflight) and not dispatched
        )
        progressed |= dispatched
        progressed |= await self._fetch_and_process(fetch_block)
        # this step's block commits become ONE offload gather
        await self._kvbm_flush()
        return progressed

    async def _kvbm_flush(self) -> None:
        """Enqueue the gather of every block committed since the last flush
        (KVBM write-through). Awaited, so it is on the device executor —
        and so on the compute stream — before any later dispatch can
        rewrite those pages, and a device error surfaces here."""
        if self.kvbm is None:
            return
        fut = self.kvbm.flush_step()
        if fut is not None:
            self._kvbm_futs.append(fut)
        # the release-time flushes too: a failed gather raises here
        futs, self._kvbm_futs = self._kvbm_futs, []
        for f in futs:
            await asyncio.wrap_future(f)

    # -- admission ------------------------------------------------------- #

    def _admit_waiting(self):
        still: List[_Slot] = []
        for slot in self.scheduler.order_waiting(self._waiting):
            if slot.done or slot.context.is_stopped():
                self._emit_finish(slot, "cancelled")
                continue
            if not self._free_slots or not self._try_admit(slot):
                still.append(slot)
        self._waiting = still

    def _try_admit(self, slot: _Slot) -> bool:
        cfg = self.config
        if slot.preloaded is not None:
            # disagg decode role: all prompt pages fresh; the KV arrives by
            # injection, not prefill
            n_pages = (len(slot.prompt) + cfg.page_size - 1) // cfg.page_size
            if not self.allocator.can_allocate(n_pages + 1):
                return False
            fresh = self.allocator.alloc_fresh(n_pages)
            if fresh is None:
                return False
            self._seat(slot, fresh, [])
            slot.prefill_pos = len(slot.prompt)
            return True
        kv_prompt = slot.kv_prompt
        hashes = slot.seq.block_hashes()
        cached_pages = (
            self.allocator.acquire_cached(hashes) if cfg.enable_prefix_caching else []
        )
        n_cached = len(cached_pages)
        # KVBM: probe G2/G3 (and peers' tiers, G4) for the hashes the device
        # cache missed; hits are injected before prefill (onboard)
        onboard_hashes: List[int] = []
        hint_inst = None
        prompt_full_blocks = len(kv_prompt) // cfg.page_size
        if self.kvbm is not None and cfg.enable_prefix_caching:
            hint = slot.kv_holder or {}
            hint_inst = hint.get("instance")
            onboard_hashes = self.kvbm.probe(
                hashes[n_cached:prompt_full_blocks], hint_instance=hint_inst,
                hint_blocks=max(int(hint.get("blocks", 0)) - n_cached, 0))
        # allocate the prompt's remaining pages now; generation pages grow later
        prompt_pages = (len(kv_prompt) + cfg.page_size - 1) // cfg.page_size
        fresh_prompt = max(prompt_pages - n_cached, 0)
        if not self.allocator.can_allocate(fresh_prompt + 1):
            self.allocator.release(cached_pages, hashes[:n_cached])
            return False
        fresh = self.allocator.alloc_fresh(fresh_prompt)
        if fresh is None:
            self.allocator.release(cached_pages, hashes[:n_cached])
            return False
        # admission is certain: count G1 and settle the onboard budget here,
        # not before the allocation (a refused slot retries every step)
        if self.kvbm is not None and cfg.enable_prefix_caching:
            self.kvbm_g1_hit_blocks += n_cached
            self.kvbm_g1_miss_blocks += max(prompt_full_blocks - n_cached, 0)
            if onboard_hashes:
                # three-arm budget: local tiers vs peers vs recompute; under
                # fifo (no headroom) it only counts sources
                headroom_ms = self.scheduler.onboard_headroom_ms(slot)
                rate = self.scheduler.cost.per_token("prefill")
                onboard_hashes, _ = self.kvbm.budget_onboard(
                    list(onboard_hashes), headroom_ms,
                    rate * 1000.0 * cfg.page_size if rate is not None else None,
                    hint_instance=hint_inst)
        n_onboard = len(onboard_hashes)
        if slot.migration:
            self._count_resume(slot, hashes, n_cached, onboard_hashes)
        self._seat(slot, cached_pages + fresh, hashes[:n_cached])
        slot.prefill_pos = min((n_cached + n_onboard) * cfg.page_size, len(kv_prompt))
        if n_onboard:
            slot.onboard = (fresh[:n_onboard], onboard_hashes)
        # if the whole prompt is cached, recompute the last token (need its
        # logits) — back off one position
        if slot.prefill_pos >= len(kv_prompt):
            slot.prefill_pos = len(kv_prompt) - 1
        slot.replay = bool(slot.migration and self._replay_tail and slot.prefill_pos > 0)
        self.scheduler.on_admit(slot)
        if slot.kv_pull and slot.kv_stream and self.data_plane is not None:
            # streamed handoff: stage NOW, before any prefill runs — the
            # decode worker pulls chunks while this engine computes
            self._stage_streamed_kv(slot)
        return True

    def _seat(self, slot: _Slot, pages: List[int], committed: List[int]) -> None:
        """Give an admitted slot a lane, its pages and the lane's host state."""
        idx = self._free_slots.pop()
        slot.slot_idx = idx
        slot.pages = pages
        slot.committed_hashes = committed
        self.slots[idx] = slot
        self.page_tables[idx, :] = SCRATCH_PAGE
        self.page_tables[idx, : len(pages)] = [p + 1 for p in pages]  # +1: scratch shift
        self.seq_lens[idx] = 0
        self.temps[idx] = slot.temperature
        self.top_ks[idx] = slot.top_k
        self.top_ps[idx] = slot.top_p
        self.seeds[idx] = slot.sample_seed
        self.presence[idx] = slot.presence_penalty
        self.frequency[idx] = slot.frequency_penalty
        self.repetition[idx] = slot.repetition_penalty
        self.lora_idx[idx] = slot.lora_idx
        self._fill_recent(idx, slot)
        slot.admit_seq = self._admit_counter = self._admit_counter + 1

    # -- device helpers -------------------------------------------------- #

    def _timed(self, fn, tag: str, shape: Optional[tuple] = None,
               host_clock: bool = False):
        """Wrap fn so its device time accrues to self._dev_time[tag] (and,
        when `shape`=(bucket, lanes) is given, feeds the scheduler's
        per-shape cost model). On CUDA the time is taken between two events
        recorded on the stream and read once the later one has completed;
        `host_clock` times a blocking host-side call with the host clock."""
        def timed(*a):
            if self._on_cuda and not host_clock:
                self._drain_timings()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                try:
                    return fn(*a)
                finally:
                    end.record()
                    self._pending_timings.append((tag, shape, start, end))
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self._account(tag, shape, time.perf_counter() - t0)
        return timed

    def _account(self, tag: str, shape: Optional[tuple], dt: float) -> None:
        with self._timing_lock:
            cnt, tot = self._dev_time.get(tag, (0, 0.0))
            self._dev_time[tag] = (cnt + 1, tot + dt)
        if shape is not None:
            self.scheduler.cost.observe(tag, shape[0], shape[1], dt)

    def _drain_timings(self, wait: bool = False) -> None:
        """Fold every completed (start, end) event pair into _dev_time."""
        while True:
            with self._timing_lock:
                if not self._pending_timings:
                    return
                tag, shape, start, end = self._pending_timings[0]
                if not wait and not end.query():
                    return
                self._pending_timings.popleft()
            if wait:
                end.synchronize()
            self._account(tag, shape, start.elapsed_time(end) / 1000.0)

    async def _run_on_device(self, fn, *args, tag: str = None,
                             shape: Optional[tuple] = None, host_clock: bool = False):
        if tag is not None:
            fn = self._timed(fn, tag, shape, host_clock=host_clock)
        return await asyncio.get_running_loop().run_in_executor(
            self._device_exec, fn, *args
        )

    def _result(self, *tensors) -> _DeviceResult:
        """Package a dispatch's outputs; on CUDA record the event a later
        copy on the side stream waits for."""
        event = None
        if self._on_cuda:
            event = torch.cuda.Event()
            event.record()
        return _DeviceResult(tensors, event)

    def _to_host(self, results: List[Optional[_DeviceResult]]) -> list:
        """ONE blocking host read for a list of dispatch results (None
        entries pass through). On CUDA the copies run on a side stream that
        waits only for each result's own event, so a block dispatched later
        does not hold the read back."""
        if not self._on_cuda:
            return [
                None if r is None else tuple(t.numpy() for t in r.tensors)
                for r in results
            ]
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        staged = []
        with torch.cuda.stream(self._copy_stream):
            for r in results:
                if r is None:
                    staged.append(None)
                    continue
                self._copy_stream.wait_event(r.event)
                staged.append(tuple(t.to("cpu", non_blocking=True) for t in r.tensors))
        self._copy_stream.synchronize()
        return [None if s is None else tuple(t.numpy() for t in s) for s in staged]

    async def _fetch(self, results: list) -> list:
        return await asyncio.get_running_loop().run_in_executor(
            self._fetch_exec,
            self._timed(self._to_host, "fetch", host_clock=True), results
        )

    def _mark_lane_dirty(self, idx: int):
        """Lane state changed on host (admission/finish/resume): patch just
        that lane before the next block instead of a full carry reset."""
        if self._carry_valid and idx >= 0:
            self._dirty_lanes.add(idx)

    def _dev(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _dev_mask(self, packed: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        """A bitpacked guided mask [R, V/8] on the device as [R, V] bool. On
        CUDA it travels through pinned memory without blocking the host (up
        to 1 MB a step at a 128k vocabulary and 64 lanes)."""
        if packed is None:
            return None
        t = torch.from_numpy(np.ascontiguousarray(packed))
        if self._on_cuda:
            t = t.pin_memory().to(self.device, non_blocking=True)
        return unpack_mask(t, self.model_config.vocab_size)

    def _samp(self, temps, top_ks, top_ps, seeds, pens) -> SamplingParams:
        """Device sampling state from host arrays, with the host-known
        all-greedy / no-penalty facts that let the sampler skip work."""
        return SamplingParams(
            temperature=self._dev(temps),
            top_k=self._dev(top_ks),
            top_p=self._dev(top_ps),
            seed=self._dev(seeds),
            presence=self._dev(pens[:, 0]),
            frequency=self._dev(pens[:, 1]),
            repetition=self._dev(pens[:, 2]),
            all_greedy=bool(np.all(temps <= 0.0)),
            no_penalties=bool(
                np.all(pens[:, 0] == 0.0) and np.all(pens[:, 1] == 0.0)
                and np.all(pens[:, 2] == 1.0)
            ),
        )

    # -- device programs (run on the device executor thread) ------------- #

    @torch.no_grad()
    def _dev_prefill(self, toks, positions, tables, ctx_lens, last_idx,
                     temps, top_ks, top_ps, seeds, pens, pen_rows, mask=None, lora=None,
                     emb=None, emb_mask=None):
        """Batched chunked prefill + on-device first-token sampling (masked
        by the guided lanes' FSMs when `mask` is given; with the lanes'
        adapters when `lora` is given; with encoder rows spliced over the
        placeholders where `emb_mask` is set when `emb` is given)."""
        samp = self._samp(temps, top_ks, top_ps, seeds, pens)
        ctx_d, last_d = self._dev(ctx_lens), self._dev(last_idx)
        logits, _, _ = self._model.prefill_forward_batched(
            self.params, self.model_config, self._dev(toks), self._dev(positions),
            self.kv_k, self.kv_v, self._dev(tables), ctx_d, last_d,
            lora=self._dev_lora(lora),
            emb_override=None if emb is None else self._dev(emb),
            emb_mask=None if emb_mask is None else self._dev(emb_mask),
        )
        plogits = penalized(logits, samp, self._dev(pen_rows))
        first = sample_lp(plogits, samp, ctx_d + last_d, raw=logits,
                          mask=self._dev_mask(mask))
        return self._result(*first)

    @torch.no_grad()
    def _dev_mixed(self, toks, positions, row_ids, tables, row_starts,
                   row_lens, ctx_lens, last_flat, temps, top_ks, top_ps,
                   seeds, pens, pen_rows, mask=None, lora=None):
        """Unified mixed step: ONE ragged forward over a flat buffer packing
        prefill chunks (row_len > 1) and decode lanes (row_len == 1), with
        each row's last-token logits sampled on device. Guided rows carry
        their FSM mask (`mask`; all-ones rows are exact no-ops), LoRA rows
        their adapter slot (`lora`, per row; slot 0 is an exact no-op);
        speculative verify rows need no operand of their own: they are
        one-token rows whose ctx covers their sibling rows' KV, written
        before attention."""
        samp = self._samp(temps, top_ks, top_ps, seeds, pens)
        ctx_d, len_d = self._dev(ctx_lens), self._dev(row_lens)
        logits, _, _ = self._model.ragged_forward(
            self.params, self.model_config, self._dev(toks), self._dev(positions),
            self._dev(row_ids), self.kv_k, self.kv_v, self._dev(tables),
            self._dev(row_starts), len_d, ctx_d, self._dev(last_flat),
            lora=self._dev_lora(lora),
        )
        plogits = penalized(logits, samp, self._dev(pen_rows))
        # the sampled token's position counter: the row's last real token
        # (= ctx + last_idx for prefill rows, seq_len - 1 for decode rows)
        # — identical to what the split dispatches use, so seeded streams
        # don't depend on the dispatch shape
        first = sample_lp(plogits, samp, ctx_d + len_d - 1, raw=logits,
                          mask=self._dev_mask(mask))
        return self._result(*first)

    def _dev_reset(self, tokens, positions, seq_lens, page_tables, temps,
                   top_ks, top_ps, seeds, pens, recent, hist=None):
        self._samp_dev = self._samp(temps, top_ks, top_ps, seeds, pens)
        self._carry = (self._dev(tokens), self._dev(positions), self._dev(seq_lens))
        self._pen_dev = self._dev(recent)
        self._tables_dev = self._dev(page_tables)
        if hist is not None:
            self._hist_dev = self._dev(hist)

    def _dev_patch(self, lane_mask, table_mask, tokens, positions, seq_lens,
                   tables, temps, top_ks, top_ps, seeds, pens, recent, hist=None):
        """Per-lane carry patch: lane_mask lanes take carry + sampling +
        table (and, under spec, history ring) from the host; table_mask
        extends to lanes whose page table grew mid-decode (their carry on
        device is NEWER than host state)."""
        lm, tm = self._dev(lane_mask), self._dev(table_mask)
        new = self._samp(temps, top_ks, top_ps, seeds, pens)
        cur = self._samp_dev
        pick = lambda n, c: torch.where(lm, n, c)  # noqa: E731
        self._carry = (
            pick(self._dev(tokens), self._carry[0]),
            pick(self._dev(positions), self._carry[1]),
            pick(self._dev(seq_lens), self._carry[2]),
        )
        self._tables_dev = torch.where(tm[:, None], self._dev(tables), self._tables_dev)
        self._pen_dev = torch.where(lm[:, None], self._dev(recent), self._pen_dev)
        self._samp_dev = SamplingParams(
            temperature=pick(new.temperature, cur.temperature),
            top_k=pick(new.top_k, cur.top_k),
            top_p=pick(new.top_p, cur.top_p),
            seed=pick(new.seed, cur.seed),
            presence=pick(new.presence, cur.presence),
            frequency=pick(new.frequency, cur.frequency),
            repetition=pick(new.repetition, cur.repetition),
        )
        if hist is not None and self._hist_dev is not None:
            # the other lanes keep the (newer) rows spec blocks appended
            self._hist_dev = torch.where(lm[:, None], self._dev(hist), self._hist_dev)

    @torch.no_grad()
    def _dev_block(self, all_greedy: bool, no_penalties: bool, lora=None):
        """K fused decode steps: sampled tokens feed the next step on the
        device — one host read per K*B tokens instead of per token. Under
        "scatter" the KV pool is written in place each step; under "local"
        it is read-only for the block and committed once at its end. A
        block with the lanes' adapters (`lora`) writes the pool in place
        under either mode (the local decode takes no adapter)."""
        tokens, positions, seq_lens = self._carry
        samp = self._samp_dev._replace(
            all_greedy=all_greedy, no_penalties=no_penalties
        )
        pen = self._pen_dev
        W = pen.shape[1]
        lanes = torch.arange(tokens.shape[0], device=self.device)
        lora = self._dev_lora(lora)
        local = self.config.decode_pool_mode == "local" and lora is None
        if local:
            c, K = self.model_config, self.config.decode_block_steps
            pool_lens = (seq_lens - 1).clamp(min=0)
            start_pos = positions
            # per-layer block-local K/V in the compute dtype (full precision
            # under a quantized pool), zeroed at block start
            loc = torch.zeros(
                (2, c.num_layers, tokens.shape[0], K, c.num_kv_heads, c.head_dim),
                dtype=c.dtype, device=self.device,
            )
            if self._step_idx is None:
                self._step_idx = [
                    torch.full((1,), j, dtype=torch.int32, device=self.device)
                    for j in range(K)
                ]
        outs = []
        for j in range(self.config.decode_block_steps):
            if local:
                logits, _, _ = self._model.decode_forward_local(
                    self.params, self.model_config, tokens, positions,
                    loc[0], loc[1], self._step_idx[j], self.kv_k, self.kv_v,
                    self._tables_dev, pool_lens,
                )
            else:
                logits, _, _ = self._model.decode_forward(
                    self.params, self.model_config, tokens, positions,
                    self.kv_k, self.kv_v, self._tables_dev, seq_lens, lora=lora,
                )
            plogits = penalized(logits, samp, pen)
            nxt, lp, tid, tlp = sample_lp(plogits, samp, positions, raw=logits)
            tokens = nxt.to(torch.int32)
            if not no_penalties:
                # lanes without a penalty never read their ring row, and a
                # lane admitted later brings its own row from the host
                pen = pen.index_put(
                    (lanes, ((positions + 1) % W).long()), tokens)
            positions = positions + 1
            seq_lens = seq_lens + 1
            outs.append((tokens, lp, tid, tlp))
        if local:
            # one pool write for the block's K positions of every lane:
            # inactive lanes write through their scratch table rows, and
            # positions past the table go to the scratch page
            pos = start_pos[:, None] + torch.arange(K, device=self.device)[None, :]
            tables = self._tables_dev
            phys, offs = llama._page_slots(
                pos, tables[:, None, :].expand(-1, K, -1), self.config.page_size)
            kv_write_all_layers(self.kv_k, phys, offs, loc[0])
            kv_write_all_layers(self.kv_v, phys, offs, loc[1])
        self._carry = (tokens, positions, seq_lens)
        self._pen_dev = pen
        return self._result(*(torch.stack(x) for x in zip(*outs)))

    @torch.no_grad()
    def _dev_block_guided(self, mask, all_greedy: bool, no_penalties: bool, lora=None):
        """ONE masked decode step for the whole batch (guided lanes carry
        their FSM rows, the others all-ones rows): the mask of step t+1
        depends on the token of step t, so a guided lane cannot ride the
        K-step block. It writes the pool in place under either pool mode,
        and carries the LoRA lanes' adapters when `lora` is given."""
        tokens, positions, seq_lens = self._carry
        samp = self._samp_dev._replace(all_greedy=all_greedy, no_penalties=no_penalties)
        logits, _, _ = self._model.decode_forward(
            self.params, self.model_config, tokens, positions,
            self.kv_k, self.kv_v, self._tables_dev, seq_lens, lora=self._dev_lora(lora),
        )
        plogits = penalized(logits, samp, self._pen_dev)
        nxt, lp, tid, tlp = sample_lp(plogits, samp, positions, raw=logits,
                                      mask=self._dev_mask(mask))
        tokens = nxt.to(torch.int32)
        if not no_penalties:
            W = self._pen_dev.shape[1]
            lanes = torch.arange(tokens.shape[0], device=self.device)
            self._pen_dev = self._pen_dev.index_put(
                (lanes, ((positions + 1) % W).long()), tokens)
        self._carry = (tokens, positions + 1, seq_lens + 1)
        return self._result(*(x[None] for x in (tokens, lp, tid, tlp)))

    @torch.no_grad()
    def _dev_spec_block(self, keys: List[tuple]):
        """spec_rounds draft-verify rounds (engine/spec.py), one key each.
        A round writes the current token into the history ring, drafts d
        continuations from its n-gram, verifies all 1+d in ONE
        batched-prefill pass (T = 1+d, KV written for every position) and
        accepts the longest matching prefix: 1..1+d tokens a lane a round,
        never fewer than plain decode. Returns (toks [S, B, 1+d],
        n_emit [S, B])."""
        cfg, c = self.config, self.model_config
        tokens, positions, seq_lens = self._carry
        # penalties are refused under spec at admission
        samp = self._samp_dev._replace(no_penalties=True)
        hist = self._hist_dev
        B, d, Hc = tokens.shape[0], cfg.spec_draft_len, cfg.spec_hist
        T = d + 1
        lanes = torch.arange(B, device=self.device)
        ar = torch.arange(T, device=self.device, dtype=torch.int32)[None, :]
        last_idx = torch.full((B,), d, dtype=torch.int32, device=self.device)
        toks_s, n_emit_s = [], []
        for key in keys:
            hist = hist_write(hist, positions, tokens)
            draft = ngram_draft(hist, tokens, positions, cfg.spec_ngram, d)
            chunk = torch.cat([tokens[:, None], draft.to(tokens.dtype)], dim=1)
            logits, _, _ = self._model.prefill_forward_batched(
                self.params, c, chunk, positions[:, None] + ar, self.kv_k, self.kv_v,
                self._tables_dev, positions,  # context: tokens already in KV
                last_idx, all_logits=True,
            )
            out_toks, n_emit, _ = verify_accept(logits, draft, samp, key)
            n_emit = n_emit.to(torch.int32)
            tokens = out_toks[lanes, (n_emit - 1).long()].to(torch.int32)
            # ring-append the emitted tokens (positions pos+1 .. pos+n_emit);
            # the rest go to a spill column that is dropped
            slot_i = torch.where(ar < n_emit[:, None], (positions[:, None] + 1 + ar) % Hc,
                                 torch.full_like(ar, Hc))
            spill = torch.cat([hist, hist.new_zeros((B, 1))], dim=1)
            spill.scatter_(1, slot_i.long(), out_toks.to(hist.dtype))
            hist = spill[:, :Hc]
            positions = positions + n_emit
            seq_lens = seq_lens + n_emit
            toks_s.append(out_toks)
            n_emit_s.append(n_emit)
        self._carry = (tokens, positions, seq_lens)
        self._hist_dev = hist
        return self._result(torch.stack(toks_s), torch.stack(n_emit_s))

    # -- prefill ----------------------------------------------------------- #

    def _try_skip_ahead(self, s: _Slot) -> None:
        """Late-binding prefix reuse: blocks committed SINCE this slot was
        admitted (by a concurrent same-prefix request, possibly via the
        incremental chunk commit) cover part of the remaining prompt —
        swap the cached pages into the table and skip the compute. Only
        whole-page-aligned progress can splice; fresh slots only."""
        cfg = self.config
        if not cfg.enable_prefix_caching:
            return  # caching disabled must disable ALL reuse paths
        if s.generated or s.resume_token is not None:
            return
        n_known = len(s.committed_hashes)
        if s.prefill_pos != n_known * cfg.page_size:
            return
        hashes = s.seq.block_hashes()
        prompt_full = len(s.kv_prompt) // cfg.page_size
        if n_known >= prompt_full:
            return
        extra = self.allocator.acquire_cached(hashes[n_known:prompt_full])
        if not extra:
            return
        self.prefix_skip_ahead_blocks += len(extra)
        old = s.pages[n_known : n_known + len(extra)]
        s.pages[n_known : n_known + len(extra)] = extra
        self.allocator.release(old, [])  # fresh, un-hashed -> free list
        s.committed_hashes.extend(hashes[n_known : n_known + len(extra)])
        self._advance_kv_stream(s)
        s.prefill_pos = (n_known + len(extra)) * cfg.page_size
        if s.prefill_pos >= len(s.kv_prompt):
            # whole prompt now cached: recompute the last token for logits
            s.prefill_pos = len(s.kv_prompt) - 1
        phys = [p + 1 for p in s.pages]
        self.page_tables[s.slot_idx, : len(phys)] = phys

    def _prefill_candidates(self) -> List[_Slot]:
        """Slots with prompt KV still to compute (cancelled ones are
        finished and released on the way)."""
        cands = []
        for s in self.slots:
            if s is None or s.prefill_pos >= len(s.kv_prompt) or self._replays(s):
                continue
            if s.done or s.context.is_stopped():
                self._emit_finish(s, "cancelled")
                self._release_slot(s)
                continue
            self._try_skip_ahead(s)
            cands.append(s)
        return cands

    async def _dispatch_prefill(self) -> bool:
        """Pack prefill chunks from several slots into ONE dispatch.

        Shapes are bounded: batch lanes B_pf = prefill_batch_tokens/bucket
        (padded with dummy lanes), table length = pow2 context bucket + a
        scratch tail entry for padded positions."""
        cfg = self.config
        cands = self._prefill_candidates()
        if not cands:
            return False
        cands = self.scheduler.order(cands)
        # multimodal, guided and LoRA slots ride different operands and
        # never share a prefill batch; plain slots batch with any one kind
        # (a masked-off splice row, an all-ones mask row and adapter slot 0
        # are exact no-ops). The excluded kind waits; the planner's aging
        # tiebreak keeps it from starving.
        def kind(s):
            if s.mm is not None:
                return "mm"
            return "guided" if s.guided_fsm is not None else "lora" if s.lora_idx else "plain"

        batch_kind = self.scheduler.pick_batch_kind(cands, kind)
        if batch_kind != "plain":
            for s in cands:
                if kind(s) not in ("plain", batch_kind):
                    s.sched_skips += 1
            cands = [s for s in cands if kind(s) in ("plain", batch_kind)]
        has_decode = any(
            s is not None and s.generated > 0 and s.resume_token is None
            and s.prefill_pos >= len(s.kv_prompt)
            for s in self.slots
        )
        plan = self.scheduler.plan_prefill(cands, decode_active=has_decode)
        if plan is None:
            # ITL budget exhausted and no deadline at risk: prefill yields
            # this step; skipped candidates age toward the starvation guard
            for s in cands:
                s.sched_skips += 1
            return False
        bucket = plan.bucket
        chosen = plan.chosen
        for s in cands[len(chosen):]:
            s.sched_skips += 1
        B_pf = plan.lanes

        # shared context-bounded table: pow2 pages covering the largest
        # (history + chunk), plus one guaranteed-scratch tail entry that
        # padded positions write to
        chunk_of = {}
        max_pages_needed = 1
        for s in chosen:
            chunk = min(len(s.kv_prompt) - s.prefill_pos, bucket)
            chunk_of[s.request_id] = chunk
            pages_needed = (s.prefill_pos + chunk + cfg.page_size - 1) // cfg.page_size
            max_pages_needed = max(max_pages_needed, pages_needed)
        ctx_pages = min(_next_pow2(max_pages_needed), cfg.max_pages_per_seq)
        P = ctx_pages + 1
        pad_pos = P * cfg.page_size - 1

        toks = np.zeros((B_pf, bucket), np.int32)
        positions = np.full((B_pf, bucket), pad_pos, np.int32)
        tables = np.full((B_pf, P), SCRATCH_PAGE, np.int32)
        ctx_lens = np.zeros((B_pf,), np.int32)
        last_idx = np.zeros((B_pf,), np.int32)
        temps = np.zeros((B_pf,), np.float32)
        top_ks = np.zeros((B_pf,), np.int32)
        top_ps = np.ones((B_pf,), np.float32)
        seeds = np.zeros((B_pf,), np.int64)
        pens = np.zeros((B_pf, 3), np.float32)
        pens[:, 2] = 1.0  # repetition off
        pen_rows = np.full((B_pf, cfg.penalty_window), -1, np.int32)
        lora_idx = np.zeros((B_pf,), np.int32)
        meta = []
        for lane, s in enumerate(chosen):
            chunk = chunk_of[s.request_id]
            start = s.prefill_pos
            toks[lane, :chunk] = s.kv_prompt[start : start + chunk]
            positions[lane, :chunk] = np.arange(start, start + chunk)
            tables[lane, :ctx_pages] = self.page_tables[s.slot_idx][:ctx_pages]
            ctx_lens[lane] = start
            last_idx[lane] = chunk - 1
            temps[lane] = s.temperature
            top_ks[lane] = s.top_k
            top_ps[lane] = s.top_p
            seeds[lane] = s.sample_seed
            pens[lane] = (s.presence_penalty, s.frequency_penalty,
                          s.repetition_penalty)
            pen_rows[lane] = self.recent[s.slot_idx]
            lora_idx[lane] = s.lora_idx
            s.sched_skips = 0  # granted a chunk: starvation clock restarts
            meta.append((s, chunk, lane))
        self._last_prefill_shape = (
            B_pf * bucket, sum(ch for _, ch, _ in meta)
        )
        # guided lanes constrain the first generated token as decode steps
        # are constrained; the other lanes' all-ones rows are exact no-ops
        mask = self._pack_masks([(lane, s) for s, _, lane in meta], B_pf)
        emb, emb_mask = self._splice_operands(meta, B_pf, bucket)
        first_dev = await self._run_on_device(
            partial(
                self._dev_prefill,
                toks, positions, tables, ctx_lens, last_idx, temps,
                top_ks, top_ps, seeds, pens, pen_rows, mask,
                self._lora_operand(lora_idx), emb, emb_mask,
            ),
            tag="prefill", shape=(bucket, B_pf),
        )
        completions = []
        progressed = []
        for s, chunk, lane in meta:
            s.prefill_pos += chunk
            # commit confirmed at this dispatch's FETCH (execution proof)
            progressed.append((s, s.prefill_pos))
            if s.prefill_pos >= len(s.kv_prompt):
                completions.append((s, lane))
        self._pending_prefill.append(
            {"first": first_dev, "done": completions, "progressed": progressed}
        )
        return True

    def _splice_operands(self, meta, B_pf: int, bucket: int):
        """(emb [B_pf, bucket, H] f32, emb_mask [B_pf, bucket]) of a prefill
        dispatch: each part's encoder rows land at their absolute prompt
        positions inside the lane's chunk window [prefill_pos, +chunk),
        which may cut an image at either end (a chunk boundary, a prefix
        hit inside it). (None, None) when no chosen slot has image parts."""
        if not any(s.mm for s, _, _ in meta):
            return None, None
        H = self.model_config.hidden_size
        emb = np.zeros((B_pf, bucket, H), np.float32)
        emb_mask = np.zeros((B_pf, bucket), bool)
        for s, chunk, lane in meta:
            start = s.prefill_pos
            for pos0, arr in s.mm or ():
                lo, hi = max(pos0, start), min(pos0 + len(arr), start + chunk)
                if lo < hi:
                    emb[lane, lo - start:hi - start] = arr[lo - pos0:hi - pos0]
                    emb_mask[lane, lo - start:hi - start] = True
        return emb, emb_mask

    def _replays(self, s: _Slot) -> bool:
        """A migrated slot whose remaining tail (at most two pages) is
        recomputed decode-shaped instead of prefilled. A tail that reaches
        into an image is prefilled: the decode forward has no splice."""
        return (s.replay and s.onboard is None
                and 0 < len(s.kv_prompt) - s.prefill_pos <= 2 * self.config.page_size
                and not any(pos0 + len(arr) > s.prefill_pos for pos0, arr in s.mm or ()))

    async def _dispatch_replays(self) -> bool:
        """Recompute a migrated resume's tail — the tokens past the prefix
        its checkpoint or cache held — as the dead stream computed them:
        one token a row through the decode forward, the rows padded to the
        decode block's batch and table shapes, so every row's arithmetic,
        and the KV it writes, is the decode step's. A prefilled tail would
        differ in the last bits and let the continuation drift from the
        stream that died; this way a resumed stream is the same stream.
        Each dispatch covers up to max_num_seqs positions; the last one
        samples the stream's next token, which completes like a prefill."""
        cfg = self.config
        did = False
        for s in list(self.slots):
            if s is None or not self._replays(s):
                continue
            if s.done or s.context.is_stopped():
                self._emit_finish(s, "cancelled")
                self._release_slot(s)
                continue
            B = cfg.max_num_seqs
            start = s.prefill_pos
            n = min(len(s.kv_prompt) - start, B)
            toks = np.zeros((B,), np.int32)
            positions = np.zeros((B,), np.int32)
            seq_lens = np.zeros((B,), np.int32)
            tables = np.full((B, cfg.max_pages_per_seq), SCRATCH_PAGE, np.int32)
            toks[:n] = s.kv_prompt[start : start + n]
            positions[:n] = np.arange(start, start + n)
            seq_lens[:n] = positions[:n] + 1
            tables[:n] = self.page_tables[s.slot_idx]
            pens = np.array([[s.presence_penalty, s.frequency_penalty,
                              s.repetition_penalty]], np.float32)
            lora_idx = np.zeros((B,), np.int32)
            lora_idx[:n] = s.lora_idx
            first = await self._run_on_device(
                partial(self._dev_replay, toks, positions, seq_lens, tables, n - 1,
                        np.array([s.temperature], np.float32),
                        np.array([s.top_k], np.int32), np.array([s.top_p], np.float32),
                        np.array([s.sample_seed], np.int64), pens,
                        self.recent[s.slot_idx][None].copy(), self._lora_operand(lora_idx)),
                tag="replay")
            s.prefill_pos += n
            done = [(s, 0)] if s.prefill_pos >= len(s.kv_prompt) else []
            self._pending_prefill.append(
                {"first": first, "done": done, "progressed": [(s, s.prefill_pos)]})
            did = True
        return did

    @torch.no_grad()
    def _dev_replay(self, toks, positions, seq_lens, tables, last, temps, top_ks, top_ps,
                    seeds, pens, pen_rows, lora=None):
        """Decode-shaped tail recompute (see _dispatch_replays): writes the
        rows' KV (with the stream's adapter under `lora`) and samples the
        token after row `last`."""
        pos_d = self._dev(positions)
        logits, _, _ = self._model.decode_forward(
            self.params, self.model_config, self._dev(toks), pos_d,
            self.kv_k, self.kv_v, self._dev(tables), self._dev(seq_lens),
            lora=self._dev_lora(lora),
        )
        samp = self._samp(temps, top_ks, top_ps, seeds, pens)
        row = logits[last:last + 1]
        first = sample_lp(penalized(row, samp, self._dev(pen_rows)), samp,
                          pos_d[last:last + 1], raw=row)
        return self._result(*first)

    def _pack_masks(self, rows: List[tuple], n_rows: int) -> Optional[np.ndarray]:
        """[n_rows, V/8] bitpacked admissibility rows for (row, slot) pairs:
        a guided slot's FSM row, all ones elsewhere. None when no slot is
        guided (the dispatch then carries no mask)."""
        guided = [(r, s) for r, s in rows if s.guided_fsm is not None]
        if not guided:
            return None
        V = self.model_config.vocab_size
        packed = np.full((n_rows, (V + 7) // 8), 0xFF, np.uint8)
        for r, s in guided:
            packed[r] = np.packbits(self._guided_lane_mask(s.guided_fsm, s.guided_state))
        return packed

    def _fill_hist(self, idx: int, slot: _Slot):
        """Load the lane's n-gram history ring (host mirror): the last
        spec_hist tokens of the prompt so far plus the current token; the
        reset or patch that follows the lane's dirtying uploads it."""
        if self.hist is None:
            return
        Hc = self.config.spec_hist
        toks = np.asarray(list(slot.kv_prompt) + [int(self.tokens[idx])], np.int32)
        row = self.hist[idx]
        row[:] = 0
        ps = np.arange(max(0, len(toks) - Hc), len(toks))
        row[ps % Hc] = toks[ps]

    def _fill_recent(self, idx: int, slot: _Slot):
        """Load the lane's penalty window from the tokens so far (prompt +
        generated); ring-indexed by absolute position so device-side
        appends stay consistent across patches."""
        W = self.config.penalty_window
        toks = np.asarray(slot.seq.tokens, np.int32)
        row = self.recent[idx]
        row[:] = -1
        if len(toks):
            ps = np.arange(max(0, len(toks) - W), len(toks))
            row[ps % W] = toks[ps]

    def _top_entry(self, slot: _Slot, tids, tlps) -> Optional[dict]:
        """Top-k alternatives for one emitted token, sliced to the
        request's ask (None when not requested — zero overhead)."""
        n = slot.want_top_logprobs
        if not n:
            return None
        return {
            "ids": [int(t) for t in tids[:n]],
            "logprobs": [float(v) for v in tlps[:n]],
        }

    def _finish_prefill(self, slot: _Slot, first: int,
                        first_lp: Optional[float] = None,
                        first_top: Optional[dict] = None):
        """Prompt KV fully computed; activate the slot for decode."""
        self._commit_blocks(slot)
        if slot.done or slot.context.is_stopped():
            self._emit_finish(slot, "cancelled")
            self._release_slot(slot)
            return
        if slot.resume_token is not None:
            # preempted resume: continue from the already-emitted pending
            # token; the freshly sampled token is discarded
            first = slot.resume_token
            slot.resume_token = None
            slot.last_token = first
            self.tokens[slot.slot_idx] = first
            self.seq_lens[slot.slot_idx] = len(slot.kv_prompt) + 1
            self._fill_hist(slot.slot_idx, slot)
            self._fill_recent(slot.slot_idx, slot)
            self._mark_lane_dirty(slot.slot_idx)
            return
        self._advance_guided(slot, first)
        self._emit_token(slot, first, first_lp, first_top)
        if not slot.done:
            slot.last_token = first
            slot.generated = 1
            slot.seq.append(first)
            self.tokens[slot.slot_idx] = first
            self.seq_lens[slot.slot_idx] = len(slot.kv_prompt) + 1
            self._fill_hist(slot.slot_idx, slot)
            self._fill_recent(slot.slot_idx, slot)
            self._mark_lane_dirty(slot.slot_idx)
            self._maybe_finish(slot, first)

    def _commit_blocks(self, slot: _Slot, upto_tokens: Optional[int] = None):
        """Bind filled prompt pages to their hashes -> prefix cache + events.

        `upto_tokens`: incremental commit after a confirmed prefill CHUNK
        (the fetch of its dispatch's first-token proves the device ran the
        program, so the pages hold real KV) — concurrent same-prefix
        requests start hitting these blocks before the whole prompt
        finishes."""
        hashes = slot.seq.block_hashes()
        n_known = len(slot.committed_hashes)
        limit = len(slot.kv_prompt)
        if upto_tokens is not None:
            limit = min(limit, upto_tokens)
        prompt_full_blocks = limit // self.config.page_size
        new_hashes = hashes[n_known:prompt_full_blocks]
        if new_hashes:
            pages = slot.pages[n_known : n_known + len(new_hashes)]
            token_blocks = [
                b.tokens for b in slot.seq.blocks[n_known : n_known + len(new_hashes)]
            ]
            parent = slot.committed_hashes[-1] if slot.committed_hashes else None
            self.allocator.commit_hashes(pages, new_hashes, token_blocks, parent)
            slot.committed_hashes.extend(new_hashes)
            self._advance_kv_stream(slot)
            if self.kvbm is not None:
                self.kvbm.offload_commit(new_hashes, [p + 1 for p in pages], parent=parent)

    # -- disaggregation: KV handoff ---------------------------------------- #

    def _kv_wire_meta(self):
        """(page_shape, dtype_name) as KV pages travel on the wire: the fp
        [L, ps, KH, D] layout, or the packed uint8 [L, PAGE_BYTES] rows of a
        quantized pool. Every descriptor/payload carries kv_format beside
        this, so a mixed-precision pairing fails typed."""
        from ..llm.kv_transfer import dtype_name

        c, cfg = self.model_config, self.config
        if cfg.kv_quant != "none":
            pb = kv_page_bytes(cfg.page_size, c.num_kv_heads, c.head_dim,
                               c.dtype, cfg.kv_quant)
            return [c.num_layers, pb], "uint8"
        return [c.num_layers, cfg.page_size, c.num_kv_heads, c.head_dim], dtype_name(c.dtype)

    @torch.no_grad()
    def _dev_extract(self, page_ids: np.ndarray, host: bool = True):
        """Gather the pages `page_ids` (physical ids) of every layer in
        their wire layout (`ops/kv_quant.py:pack_pages`). `host=False`
        leaves them on the device (the in-process path); on CUDA the host
        copy lands in pinned memory on the side copy stream."""
        ids = torch.from_numpy(np.asarray(page_ids, np.int64)).to(self.device)
        k = pack_pages(extract_pages(self.kv_k, ids))
        v = pack_pages(extract_pages(self.kv_v, ids))
        self.kv_pages_extracted += len(page_ids)
        if not host or not self._on_cuda:
            return k, v
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            out = []
            for x in (k, v):
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                out.append(h)
        self._copy_stream.synchronize()
        return out[0], out[1]

    @torch.no_grad()
    def _dev_offload_gather(self, page_ids: np.ndarray):
        """KVBM offload: gather the pages `page_ids` (physical ids) in their
        wire layout `[L, n, ...]` on the compute stream and, on CUDA, copy
        them into pinned host tensors on the side copy stream without
        waiting. Returns (k, v, event): the event marks the copy's end (None
        on the CPU, where the gather is the copy)."""
        ids = torch.from_numpy(np.asarray(page_ids, np.int64)).to(self.device)
        k = pack_pages(extract_pages(self.kv_k, ids))
        v = pack_pages(extract_pages(self.kv_v, ids))
        if not self._on_cuda:
            return k, v, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(device=self.device)
        ready = torch.cuda.Event()
        ready.record()
        out = []
        with torch.cuda.stream(self._copy_stream):
            self._copy_stream.wait_event(ready)
            for x in (k, v):
                # the copy stream reads x: keep its memory from being reused
                # by the compute stream before the copy ends
                x.record_stream(self._copy_stream)
                h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                h.copy_(x, non_blocking=True)
                out.append(h)
            done = torch.cuda.Event()
            done.record()
        return out[0], out[1], done

    @torch.no_grad()
    def _dev_onboard(self, page_ids: np.ndarray, k: torch.Tensor, v: torch.Tensor):
        """KVBM onboard: host blocks `[n, L, ...]` (pinned on CUDA, so the
        copy is asynchronous) into the pool at `page_ids` (physical ids)."""
        if self._on_cuda:
            k = k.to(self.device, non_blocking=True)
            v = v.to(self.device, non_blocking=True)
        self._dev_inject(page_ids, k.transpose(0, 1), v.transpose(0, 1))

    @torch.no_grad()
    def _dev_inject(self, page_ids: np.ndarray, k, v):
        """Write pulled pages (wire layout, host or device tensors) into the
        pool at `page_ids` (physical ids)."""
        c, cfg = self.model_config, self.config
        ids = torch.from_numpy(np.asarray(page_ids, np.int64)).to(self.device)
        for store, data in ((self.kv_k, k), (self.kv_v, v)):
            if isinstance(data, np.ndarray):
                data = torch.from_numpy(data)
            inject_pages(store, ids, device_pages(
                data, cfg.kv_quant, cfg.page_size, c.num_kv_heads, c.head_dim,
                device=self.device))
        self.kv_pages_injected += len(page_ids)

    async def _emit_prefill_result(self, slot: _Slot, first_token: int,
                                   first_lp: Optional[float] = None,
                                   first_top: Optional[dict] = None):
        """Prefill role: the prompt's KV is computed. Publish its full pages
        to this engine's own prefix cache, then answer with the first token
        and the KV — a data-plane descriptor (pages stay pinned until the
        pull ends) or, without a data plane, the pages inline."""
        from ..llm.disagg import pack_kv_payload

        cfg = self.config
        self._commit_blocks(slot)
        if slot.done or slot.context.is_stopped():
            self._emit_finish(slot, "cancelled")
            self._release_slot(slot)
            return
        if slot.kv_stream_tid is not None and self.data_plane is not None:
            # the streamed stage is alive: publish the last page and the
            # first token under the same transfer (the decode worker has
            # been pulling since admission)
            self._finish_streamed_kv(slot, first_token, first_lp, first_top)
            return
        # an early stage that died mid-prefill (reaped, severed) leaves a
        # fresh serial stage below; the decode side retries off it
        slot.kv_stream_desc = None
        n_prompt_pages = (len(slot.prompt) + cfg.page_size - 1) // cfg.page_size
        # +1: the scratch shift; on the wire, pages are the slot's in order
        page_ids = np.array([p + 1 for p in slot.pages[:n_prompt_pages]], np.int32)
        if slot.kv_pull and self.data_plane is not None:
            params = {"pull": self._stage_kv_pull(slot, page_ids).to_dict()}
        else:
            k, v = await self._run_on_device(
                partial(self._dev_extract, page_ids),
                tag="kv_extract", host_clock=True,
            )
            params = pack_kv_payload(k, v, len(slot.prompt), cfg.page_size,
                                     kv_format=cfg.kv_quant)
        if not slot.done:
            out = LLMEngineOutput(
                token_ids=[first_token],
                log_probs=[first_lp]
                if (slot.want_logprobs and first_lp is not None) else None,
                top_logprobs=[first_top] if first_top else None,
                finish_reason="remote_prefill_done",
                kv_transfer_params=params,
            ).to_dict()
            slot.queue.put_nowait(Annotated(data=out).to_dict())
            slot.queue.put_nowait(None)
            slot.done = True
        if "pull" not in params:
            self._release_slot(slot)
        # else NOT released here: pages stay pinned until on_done (pull or TTL)

    def _stage_kv_pull(self, slot: _Slot, page_ids: np.ndarray):
        """Pin the finished prefill's pages on the data plane; returns the
        descriptor. Chunks are gathered lazily as the decode worker pulls,
        so the gather overlaps the network, and in process they never leave
        the device."""
        cfg = self.config
        wire_shape, dtype_name = self._kv_wire_meta()

        async def extract(off: int, n: int, device: bool):
            return await self._run_on_device(
                partial(self._dev_extract, page_ids[off : off + n], not device),
                tag="kv_extract", host_clock=not device,
            )

        def on_done(ok: bool):
            if not ok:
                logger.warning("kv pull for %s abandoned; releasing pages", slot.request_id)
            self._release_slot(slot)

        return self.data_plane.stage(
            n_pages=int(len(page_ids)), n_tokens=len(slot.prompt),
            page_size=cfg.page_size, page_shape=wire_shape, dtype=dtype_name,
            kv_format=cfg.kv_quant, extract=extract, on_done=on_done,
        )

    def _stage_streamed_kv(self, slot: _Slot):
        """Early-staged streamed handoff: stage the prompt's pages AT
        ADMISSION and ship the descriptor at once; chunks become pullable
        as prefill commits pages, so the decode worker's transfer overlaps
        this engine's compute. The last prompt page is held back until the
        first token (its tail's KV lands with the final chunk), so the pull
        can only complete once the token is on the wire. A transfer that
        dies mid-stream falls back to a fresh serial stage at emit."""
        cfg = self.config
        n_prompt_pages = (len(slot.prompt) + cfg.page_size - 1) // cfg.page_size
        if n_prompt_pages <= 0:
            return

        async def extract(off: int, n: int, device: bool):
            # slot.pages is read LIVE: _try_skip_ahead may splice cached
            # pages in mid-prefill (same contents, other physical ids)
            ids = np.array([p + 1 for p in slot.pages[off : off + n]], np.int32)
            return await self._run_on_device(
                partial(self._dev_extract, ids, not device),
                tag="kv_extract", host_clock=not device,
            )

        def on_done(ok: bool):
            if slot.kv_stream_tid is None:
                return  # engine-initiated abort (release)
            slot.kv_stream_tid = None
            if slot.done:
                # prefill finished and the pull settled: pages release here,
                # as the serial stage's on_done does
                if not ok:
                    logger.warning("streamed kv pull for %s abandoned; releasing pages",
                                   slot.request_id)
                self._release_slot(slot)
            elif not ok:
                # reaped or severed while prefill still runs: emit stages a
                # fresh serial transfer instead
                self.kv_streamed_fallbacks += 1

        wire_shape, dtype_name = self._kv_wire_meta()
        desc = self.data_plane.stage(
            n_pages=n_prompt_pages, n_tokens=len(slot.prompt), page_size=cfg.page_size,
            page_shape=wire_shape, dtype=dtype_name, kv_format=cfg.kv_quant,
            extract=extract, on_done=on_done,
            chunk_pages=max(cfg.max_prefill_chunk // cfg.page_size, 1),
            streamed=True,
            available_pages=min(len(slot.committed_hashes), n_prompt_pages - 1),
        )
        slot.kv_stream_tid = desc.transfer_id
        slot.kv_stream_desc = desc.to_dict()
        self.kv_streamed_stages += 1
        # the EARLY descriptor (no token yet): the decode worker starts
        # pulling at once
        out = LLMEngineOutput(kv_transfer_params={"pull": slot.kv_stream_desc}).to_dict()
        slot.queue.put_nowait(Annotated(data=out).to_dict())

    def _advance_kv_stream(self, slot: _Slot):
        """Streamed handoff watermark: every committed prompt page is
        pullable, except the last, which waits for the first token."""
        if slot.kv_stream_tid is None or self.data_plane is None:
            return
        n_prompt_pages = (len(slot.prompt) + self.config.page_size - 1) // self.config.page_size
        self.data_plane.advance_streamed(
            slot.kv_stream_tid, min(len(slot.committed_hashes), n_prompt_pages - 1))

    def _finish_streamed_kv(self, slot: _Slot, first_token: int,
                            first_lp: Optional[float] = None,
                            first_top: Optional[dict] = None):
        """Prefill finished under a live streamed stage: send the first
        token with the same descriptor, then publish the final watermark.
        Pages stay pinned until the pull ends (on_done)."""
        n_prompt_pages = (len(slot.prompt) + self.config.page_size - 1) // self.config.page_size
        out = LLMEngineOutput(
            token_ids=[first_token],
            log_probs=[first_lp]
            if (slot.want_logprobs and first_lp is not None) else None,
            top_logprobs=[first_top] if first_top else None,
            finish_reason="remote_prefill_done",
            kv_transfer_params={"pull": slot.kv_stream_desc},
        ).to_dict()
        slot.queue.put_nowait(Annotated(data=out).to_dict())
        slot.queue.put_nowait(None)
        slot.done = True
        # watermark LAST: once it reaches n_pages the pull can complete and
        # on_done releases the slot, so done/queue state must be settled
        self.data_plane.advance_streamed(slot.kv_stream_tid, n_prompt_pages)

    async def _run_injections(self) -> bool:
        did = False
        for slot in list(self.slots):
            if slot is not None and slot.preloaded is not None:
                await self._inject_preloaded(slot)
                did = True
        for slot in list(self.slots):
            if slot is not None and slot.onboard is not None:
                await self._inject_onboard(slot)
                did = True
        return did

    async def _inject_onboard(self, slot: _Slot):
        """KVBM onboard: write G2/G3/G4 blocks into the slot's fresh pages,
        then register them in the device prefix cache. A block evicted
        between probe and load, an injected `kvbm.onboard` fault or a peer
        of another KV format falls back to prefilling that span (counted);
        any other error propagates."""
        from ..llm.kv_transfer import KvFormatError

        alloc_pages, hashes = slot.onboard
        slot.onboard = None
        t0 = time.perf_counter()
        loop = asyncio.get_running_loop()

        def run(fn, *args):
            # tier reads (host copies, disk reads) off the event loop and
            # off the device executor
            return loop.run_in_executor(None, fn, *args)

        try:
            hint = slot.kv_holder or {}
            k, v = await self.kvbm.load_async(hashes, run,
                                              hint_instance=hint.get("instance"))
        except (KeyError, faults.FaultError, KvFormatError) as e:
            if isinstance(e, KvFormatError):
                self.kv_format_mismatches += 1
            logger.warning("KVBM onboard miss: %s; prefilling instead", e)
            self.kv_onboard_fallbacks += 1
            slot.prefill_pos = len(slot.committed_hashes) * self.config.page_size
            if slot.migration:
                # replayed tokens are counted by outcome: admission counted
                # these blocks as reused, and they now re-prefill
                self.migration_replayed_tokens += len(hashes) * self.config.page_size
            return
        phys = np.array([p + 1 for p in alloc_pages], np.int32)  # scratch shift
        await self._run_on_device(partial(self._dev_onboard, phys, k, v), tag="kvbm_onboard")
        n_known = len(slot.committed_hashes)
        token_blocks = [b.tokens for b in slot.seq.blocks[n_known : n_known + len(hashes)]]
        parent = slot.committed_hashes[-1] if slot.committed_hashes else None
        self.allocator.commit_hashes(alloc_pages, hashes, token_blocks, parent)
        slot.committed_hashes.extend(hashes)
        self._advance_kv_stream(slot)
        self._record_onboard_ms((time.perf_counter() - t0) * 1000.0)

    def _record_onboard_ms(self, ms: float):
        for i, b in enumerate(self._onboard_hist_bounds):
            if ms <= b:
                self.kvbm_onboard_hist[i] += 1
                break
        else:
            self.kvbm_onboard_hist[-1] += 1
        self.kvbm_onboard_ms_sum += ms
        self.kvbm_onboard_count += 1

    async def _inject_preloaded(self, slot: _Slot):
        """Decode role: write transferred KV pages into our pool and enter
        the decode batch as if the prompt had been prefilled here."""
        first_token, k, v, _ = slot.preloaded
        slot.preloaded = None
        if slot.pull_desc is not None:
            # pull path: chunks stream in a background task, the decode
            # batch keeps stepping while later pages are in flight
            desc, slot.pull_desc = slot.pull_desc, None
            task = asyncio.create_task(self._pull_kv_task(slot, desc, first_token))
            self._bg_tasks.add(task)
            task.add_done_callback(self._bg_tasks.discard)
            return
        page_ids = np.array([p + 1 for p in slot.pages], np.int32)
        await self._run_on_device(partial(self._dev_inject, page_ids, k, v), tag="kv_inject")
        self._activate_transferred(slot, first_token)

    def _activate_transferred(self, slot: _Slot, first_token: int):
        """All prompt KV is in our pages: publish them to the prefix cache
        (the same KV events a local prefill sends) and enter the decode
        batch. The first token was emitted by the prefill worker."""
        self._commit_blocks(slot)
        slot.prefill_pos = len(slot.prompt)
        slot.generated = 1
        slot.last_token = first_token
        slot.seq.append(first_token)
        self._advance_guided(slot, first_token)
        self.tokens[slot.slot_idx] = first_token
        self.seq_lens[slot.slot_idx] = len(slot.prompt) + 1
        self._fill_hist(slot.slot_idx, slot)
        self._fill_recent(slot.slot_idx, slot)
        self._mark_lane_dirty(slot.slot_idx)
        self._maybe_finish(slot, first_token)

    def _slot_live(self, slot: _Slot) -> bool:
        return (not slot.done and not self._closed and slot.slot_idx >= 0
                and self.slots[slot.slot_idx] is slot)

    async def _await_first_token(self, slot: _Slot) -> Optional[int]:
        """Streamed handoff: the prefill's first token as the handler
        delivers it (None = the handler abandoned the pull)."""
        fut, slot.first_token_fut = slot.first_token_fut, None
        if fut is None:
            return None
        return await fut

    def _abandon_pull(self, slot: _Slot):
        """The consumer left (or the engine closes) while the slot's pull
        ran: no step-loop path owns a slot that is neither prefilling nor
        decoding, so its pages are released here."""
        self._emit_finish(slot, "cancelled")
        if slot.slot_idx >= 0 and self.slots[slot.slot_idx] is slot:
            self._release_slot(slot)
        self._wake.set()

    async def _pull_kv_task(self, slot: _Slot, desc_dict: dict,
                            first_token: Optional[int]):
        """Stream KV chunks from the staging prefill worker, injecting each
        as it lands. Any failure — a format mismatch (typed, before a byte
        moves), an unreachable or dead peer, a severed stream, a bad frame —
        falls back to computing the prompt KV locally on this engine's
        device, resuming from the already-emitted first token.
        `first_token=None` is the streamed handoff: the pull started off the
        early descriptor and the token arrives through slot.first_token_fut
        (None = the handler abandoned the pull)."""
        from ..llm.kv_transfer import KvFormatError, KvTransferDescriptor, pull_kv

        desc = KvTransferDescriptor.from_dict(desc_dict)
        phys = np.array([p + 1 for p in slot.pages], np.int32)
        streamed = slot.first_token_fut is not None
        chunks_before_first = 0
        first_before_last_chunk = False

        async def inject(off: int, n: int, k, v):
            nonlocal chunks_before_first, first_before_last_chunk
            if not self._slot_live(slot):
                raise asyncio.CancelledError("slot released mid-pull")
            fut = slot.first_token_fut
            if fut is not None:
                # overlap evidence: its final value says whether the first
                # token was already here when the LAST chunk landed
                first_before_last_chunk = fut.done()
                if not fut.done():
                    chunks_before_first += 1
            await self._run_on_device(
                partial(self._dev_inject, phys[off : off + n], k, v), tag="kv_inject")

        t0 = time.perf_counter()
        try:
            if desc.kv_format != self.config.kv_quant:
                self.kv_format_mismatches += 1
                raise KvFormatError(
                    f"peer stages kv_format={desc.kv_format!r}, this worker "
                    f"runs {self.config.kv_quant!r}")
            if desc.shards is not None:
                raise UnsupportedConfigError(
                    "multi-host shard descriptors are not supported by the "
                    "PyTorch/CUDA port yet")
            if desc.n_pages != len(phys):
                raise ValueError(
                    f"descriptor holds {desc.n_pages} pages, the prompt needs {len(phys)}")
            await pull_kv(desc, inject)
        except asyncio.CancelledError:
            # slot released mid-pull or engine closing: nothing to fall
            # back to
            self._abandon_pull(slot)
            raise
        except Exception as e:  # noqa: BLE001 — any pull failure -> local prefill
            if streamed:
                first_token = await self._await_first_token(slot)
                if first_token is None:
                    self._abandon_pull(slot)
                    return
            if not self._slot_live(slot):
                self._abandon_pull(slot)
                return
            logger.warning("kv pull for %s failed (%s: %s); prefilling locally",
                           slot.request_id, type(e).__name__, e)
            self.kv_pull_fallbacks += 1
            slot.generated = 1
            slot.last_token = first_token
            slot.seq.append(first_token)
            self._advance_guided(slot, first_token)
            slot.resume_token = first_token
            slot.prefill_pos = 0
            self._wake.set()
            return
        pull_s = time.perf_counter() - t0
        if streamed:
            first_token = await self._await_first_token(slot)
            if first_token is None:
                self._abandon_pull(slot)
                return
            self.disagg_streamed_handoffs += 1
            self.disagg_chunks_before_first_token += chunks_before_first
            if first_before_last_chunk:
                self.disagg_first_token_before_last_chunk += 1
        if not self._slot_live(slot):
            self._abandon_pull(slot)
            return
        self.kv_pull_s += pull_s
        self.kv_pulls_completed += 1
        self.kv_pages_pulled += int(desc.n_pages)
        self._activate_transferred(slot, first_token)
        self._wake.set()

    # -- decode ---------------------------------------------------------- #

    def _active_decode_indices(self) -> List[int]:
        out = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            if slot.prefill_pos >= len(slot.kv_prompt) and slot.generated > 0 and slot.resume_token is None:
                out.append(i)
        return out

    def _grow_pages_for_block(self, active: List[int],
                              steps: Optional[int] = None) -> List[int]:
        """Ensure each active lane's pages cover `steps` decode steps
        (default: one fused block's max advance); preempt the newest
        sequence (or finish with 'length' as last resort) when the pool is
        exhausted. Returns the surviving active set."""
        cfg = self.config
        K = steps or cfg.block_advance
        for i in list(active):
            slot = self.slots[i]
            if slot is None:
                continue
            # clamp to the model-length bound: speculation past it writes to
            # the scratch page (decode_forward routes out-of-range positions
            # there), so no pages are needed beyond max_model_len
            last_pos = min(
                int(self.seq_lens[i]) - 1 + (K - 1), cfg.max_model_len - 1
            )
            needed_pages = last_pos // cfg.page_size + 1
            while len(slot.pages) < needed_pages:
                fresh = self.allocator.alloc_fresh(1)
                if fresh is not None:
                    slot.pages.extend(fresh)
                    self.page_tables[i, len(slot.pages) - 1] = fresh[0] + 1
                    if self._carry_valid:
                        # table-row-only patch: this lane's carry values on
                        # device are newer than host (blocks in flight)
                        self._dirty_tables.add(i)
                    continue
                if not self._preempt_one(exclude_idx=i):
                    # nothing left to preempt: finish with length
                    self._emit_finish(slot, "length")
                    self._release_slot(slot)
                    break
        return self._active_decode_indices()

    def _preempt_one(self, exclude_idx: int) -> bool:
        """Preempt the newest-admitted active sequence: commit its full
        blocks (so resume rides the prefix cache), release pages, requeue."""
        victims = [
            s
            for s in self.slots
            if s is not None and s.slot_idx != exclude_idx and s.generated > 0
        ]
        if not victims:
            return False
        victim = max(victims, key=lambda s: s.admit_seq)
        logger.info("preempting %s to reclaim pages", victim.request_id)
        self.num_preemptions += 1
        # resume state: recompute KV for everything except the pending token
        victim.resume_token = victim.last_token
        victim.kv_prompt = list(victim.seq.tokens[:-1])
        victim.prefill_pos = 0
        self._release_slot(victim)
        self._waiting.insert(0, victim)
        return True

    def _prefill_work_pending(self) -> bool:
        """True when prefill compute could actually be dispatched: a slot
        passing _dispatch_prefill's candidate filter, or an admittable
        waiter. An un-admittable waiter must NOT throttle decode."""
        if self._waiting and self._free_slots:
            return True
        return any(
            s is not None and s.prefill_pos < len(s.kv_prompt)
            and s.preloaded is None and not s.done
            for s in self.slots
        )

    async def _dispatch_mixed(self) -> bool:
        """Unified mixed step: when there are BOTH runnable prefill chunks
        and active decode lanes, pack them into one flat ragged token
        buffer — prefill chunks as T>1 rows, decode lanes as T=1 rows with
        ctx = seq_len - 1 — and run ONE forward instead of a prefill
        dispatch followed by a decode dispatch. Every decode lane advances
        one token; completed prompts sample their first token; both ride
        the same fetched [R] result. Guided rows carry a packed FSM mask,
        and under spec each spec-eligible (unguided) lane packs 1+d
        one-token verify rows — its current token and d host n-gram drafts,
        row j at position L-1+j with ctx L-1+j — accepted at the fetch.
        Returns False (split path runs) whenever the fused step is
        inapplicable: mixed disabled, decode blocks in flight (their device
        carry owns lane state — the mixed step needs host-authoritative
        lanes), or the planner declines.

        Shapes stay bounded: flat tokens pow2-bucketed to
        config.mixed_max_tokens, ONE fixed row bucket, tables
        pow2-bucketed like the prefill dispatch. Row starts are aligned to
        `ragged_tile_q()` of the ragged kernel."""
        cfg = self.config
        self._mixed_wait_drain = False
        if not self._mixed_enabled:
            return False
        active = self._active_decode_indices()
        if not active:
            return False
        d = cfg.spec_draft_len if cfg.spec_mode else 0
        n_spec_rows = sum(
            d for i in active if self.slots[i].guided_fsm is None
        ) if d else 0
        cands = []
        mm_starved = False
        for s in self._prefill_candidates():
            if s.mm is not None:
                # the splice has no operand in the ragged forward: only this
                # slot stays out (the others still fuse) and it ages toward
                # the starvation guard
                s.sched_skips += 1
                mm_starved |= s.sched_skips >= self.scheduler.sla.starve_dispatches
                continue
            cands.append(s)
        if mm_starved:
            # a starved image slot must win the next batch outright: the
            # whole step goes to the split path, whose pick_batch_kind
            # starvation override serves it
            return False
        if not cands:
            return False
        cands = self.scheduler.order(cands)
        align = self._mixed_align
        plan = self.scheduler.plan_mixed(cands, n_decode=len(active), align=align,
                                         n_spec_rows=n_spec_rows)
        if plan is None:
            return False  # nothing fuses (e.g. decode lanes fill the
            # budget) — split path runs at full rate, no hold
        if self._inflight or self._pending_prefill:
            # a decode block in flight owns these lanes' device carry, so
            # the fused step can't pack them yet. Signal the step loop to
            # HOLD the split prefill for one step while the pipeline
            # drains — the next step fuses.
            self._mixed_wait_drain = True
            for s in cands:
                s.sched_skips += 1
            return False
        # one decode step of page headroom (1 + d under spec: draft rows
        # write KV at speculative positions); growth can preempt — re-filter
        # both the decode set and the chosen prefill slots
        active = self._grow_pages_for_block(active, steps=1 + d)
        if not active:
            return False
        chosen = [
            (s, ch) for s, ch in zip(plan.chosen, plan.chunks)
            if s.slot_idx >= 0 and self.slots[s.slot_idx] is s
        ]
        if not chosen:
            return False
        # the dispatch is committed from here on — account it
        self.scheduler.commit_mixed(plan, chosen)
        granted_slots = {id(s) for s, _ in chosen}
        for s in cands:
            if id(s) not in granted_slots:
                s.sched_skips += 1

        def aligned(n: int) -> int:
            return -(-n // align) * align

        cap = cfg.mixed_max_tokens - cfg.mixed_max_tokens % align
        # against the SURVIVING active set (growth can preempt lanes)
        spec_lanes = {i for i in active if d and self.slots[i].guided_fsm is None}
        n_rows_decode = len(active) + d * len(spec_lanes)
        total = sum(aligned(ch) for _, ch in chosen) \
            + aligned(1) * n_rows_decode
        N_pad = min(_next_pow2(max(total, align)), cap)
        R_pad = self._mixed_row_bucket
        max_pages_needed = 1
        for s, ch in chosen:
            pages = (s.prefill_pos + ch + cfg.page_size - 1) // cfg.page_size
            max_pages_needed = max(max_pages_needed, pages)
        for i in active:
            extra = d if i in spec_lanes else 0
            pages = (int(self.seq_lens[i]) - 1 + extra) // cfg.page_size + 1
            max_pages_needed = max(max_pages_needed, pages)
        ctx_pages = min(_next_pow2(max_pages_needed), cfg.max_pages_per_seq)
        P = ctx_pages + 1
        pad_pos = P * cfg.page_size - 1  # pads write to the scratch tail

        toks = np.zeros((N_pad,), np.int32)
        positions = np.full((N_pad,), pad_pos, np.int32)
        row_ids = np.full((N_pad,), R_pad - 1, np.int32)
        row_starts = np.full((R_pad,), N_pad, np.int32)
        row_lens = np.zeros((R_pad,), np.int32)
        ctx_lens = np.zeros((R_pad,), np.int32)
        tables = np.full((R_pad, P), SCRATCH_PAGE, np.int32)
        last_flat = np.zeros((R_pad,), np.int32)
        temps = np.zeros((R_pad,), np.float32)
        top_ks = np.zeros((R_pad,), np.int32)
        top_ps = np.ones((R_pad,), np.float32)
        seeds = np.zeros((R_pad,), np.int64)
        pens = np.zeros((R_pad, 3), np.float32)
        pens[:, 2] = 1.0  # repetition off
        pen_rows = np.full((R_pad, cfg.penalty_window), -1, np.int32)
        lora_idx = np.zeros((R_pad,), np.int32)  # each row's adapter slot

        off = 0
        row = 0
        meta = []  # prefill rows: (slot, chunk, row)
        decode_rows = []  # (row, lane_idx, slot)
        spec_rows = []  # (first_row, lane_idx, slot, draft): 1+d rows each
        mask_rows = []  # (row, slot) of every row a guided mask may cover
        for s, chunk in chosen:
            start = s.prefill_pos
            row_starts[row] = off
            row_lens[row] = chunk
            ctx_lens[row] = start
            toks[off : off + chunk] = s.kv_prompt[start : start + chunk]
            positions[off : off + chunk] = np.arange(start, start + chunk)
            row_ids[off : off + aligned(chunk)] = row
            tables[row, :ctx_pages] = self.page_tables[s.slot_idx][:ctx_pages]
            last_flat[row] = off + chunk - 1
            temps[row] = s.temperature
            top_ks[row] = s.top_k
            top_ps[row] = s.top_p
            seeds[row] = s.sample_seed
            pens[row] = (s.presence_penalty, s.frequency_penalty,
                         s.repetition_penalty)
            pen_rows[row] = self.recent[s.slot_idx]
            lora_idx[row] = s.lora_idx
            mask_rows.append((row, s))
            if s.guided_fsm is not None:
                self.mixed_rows_guided += 1
            elif s.lora_idx:
                self.mixed_rows_lora += 1
            else:
                self.mixed_rows_plain += 1
            s.sched_skips = 0
            meta.append((s, chunk, row))
            off += aligned(chunk)
            row += 1
        for i in active:
            s = self.slots[i]
            L = int(self.seq_lens[i])
            spec_lane = i in spec_lanes
            draft = self._host_ngram_draft(s, d) if spec_lane else []
            first_row = row
            for j, tk in enumerate([int(self.tokens[i])] + draft):
                # row j: one token at position L-1+j with ctx L-1+j. It
                # attends the lane's committed KV plus rows 0..j-1 of this
                # pack (their KV is written before attention each layer), so
                # its sample is the plain seeded decode draw at that position
                row_starts[row] = off
                row_lens[row] = 1
                ctx_lens[row] = L - 1 + j
                toks[off] = tk
                positions[off] = L - 1 + j
                row_ids[off : off + aligned(1)] = row
                tables[row, :ctx_pages] = self.page_tables[i][:ctx_pages]
                last_flat[row] = off
                temps[row] = self.temps[i]
                top_ks[row] = self.top_ks[i]
                top_ps[row] = self.top_ps[i]
                seeds[row] = self.seeds[i]
                lora_idx[row] = s.lora_idx
                if not spec_lane:
                    # (spec rows keep the defaults: penalties are refused
                    # under spec at admission)
                    pens[row] = (self.presence[i], self.frequency[i], self.repetition[i])
                    # the device pen ring (decode carry) is not host-visible;
                    # rebuild this lane's window from the authoritative token
                    # sequence (ring-indexed by absolute position, so the
                    # patch after the fetch stays consistent with it)
                    self._fill_recent(i, s)
                    pen_rows[row] = self.recent[i]
                    mask_rows.append((row, s))
                off += aligned(1)
                row += 1
            if spec_lane:
                spec_rows.append((first_row, i, s, draft))
                self.mixed_rows_spec += 1 + d
            else:
                decode_rows.append((first_row, i, s))
                if s.guided_fsm is not None:
                    self.mixed_rows_guided += 1
                elif s.lora_idx:
                    self.mixed_rows_lora += 1
                else:
                    self.mixed_rows_plain += 1

        first_dev = await self._run_on_device(
            partial(
                self._dev_mixed, toks, positions, row_ids, tables,
                row_starts, row_lens, ctx_lens, last_flat, temps, top_ks,
                top_ps, seeds, pens, pen_rows, self._pack_masks(mask_rows, R_pad),
                self._lora_operand(lora_idx),
            ),
            tag="mixed", shape=(N_pad, row),
        )
        completions = []
        progressed = []
        for s, chunk, row_i in meta:
            s.prefill_pos += chunk
            progressed.append((s, s.prefill_pos))
            if s.prefill_pos >= len(s.kv_prompt):
                completions.append((s, row_i))
        for row_i, i, s in decode_rows:
            self.seq_lens[i] += 1
        # spec lanes are NOT advanced here: acceptance is data-dependent,
        # resolved from the fetched rows this same step.
        # rides the prefill-pending fetch (drained THIS step, so no decode
        # block can dispatch against the stale device carry in between)
        self._pending_prefill.append({
            "first": first_dev, "done": completions,
            "progressed": progressed, "decode": decode_rows, "spec": spec_rows,
        })
        self.mixed_steps += 1
        self.mixed_padded_tokens += N_pad
        self.mixed_real_tokens += sum(ch for _, ch, _ in meta) + n_rows_decode
        return True

    def _host_ngram_draft(self, slot: _Slot, d: int) -> List[int]:
        """Host n-gram draft for fused verify rows: `ngram_draft` over the
        authoritative host token sequence. The most recent match wins; the
        draft is padded with the last token. Drafts steer only the
        acceptance rate: every emitted token is a verified sample."""
        seq = slot.seq.tokens
        n = self.config.spec_ngram
        if n <= 0 or len(seq) < n:
            return [int(seq[-1])] * d
        gram = list(seq[len(seq) - n:])
        for start in range(len(seq) - n - 1, -1, -1):
            if list(seq[start:start + n]) == gram:
                follow = [int(t) for t in seq[start + n:start + n + d]]
                return follow + [int(seq[-1])] * (d - len(follow))
        return [int(seq[-1])] * d

    def _lane_upload(self, active: List[int]):
        """Host arrays for a carry reset/patch: lanes that are not
        decode-active get SCRATCH table rows and zeroed carry — inside a
        fused block inactive lanes still advance and write KV, and a scratch
        row routes all such writes to the scratch page by construction
        (never into a prefilling slot's, possibly shared, pages)."""
        B = self.config.max_num_seqs
        mask = np.zeros((B,), bool)
        mask[active] = True
        tokens = np.where(mask, self.tokens, 0).astype(np.int32)
        positions = np.where(mask, self.seq_lens - 1, 0).astype(np.int32)
        seq_lens = np.where(mask, self.seq_lens, 0).astype(np.int32)
        tables = np.where(
            mask[:, None], self.page_tables, SCRATCH_PAGE
        ).astype(np.int32)
        pens = np.stack([self.presence, self.frequency, self.repetition], axis=1)
        hist = (np.where(mask[:, None], self.hist, 0).astype(np.int32)
                if self.hist is not None else None)
        return (
            tokens, positions, seq_lens, tables, self.temps.copy(),
            self.top_ks.copy(), self.top_ps.copy(), self.seeds.copy(), pens,
            self.recent.copy(), hist,
        )

    async def _dispatch_decode(self) -> bool:
        cfg = self.config
        # prefill-priority depth cap: with dispatchable prefill work, keep
        # only ONE speculative block in flight — a new arrival's prefill
        # queues behind every in-flight block on the device stream, so
        # depth-2 doubles its queueing delay (TTFT) to buy decode overlap
        # it regains once the queue drains. A spec block advances lanes by
        # a DATA-DEPENDENT amount, and a guided lane's next mask depends on
        # the token just emitted: both need each block fetched and
        # processed before the next dispatches (depth 1).
        has_guided = any(
            s is not None and s.guided_fsm is not None
            and s.prefill_pos >= len(s.kv_prompt) and s.generated > 0
            for s in self.slots
        )
        depth = 1 if (cfg.spec_mode or has_guided or self._prefill_work_pending()) else 2
        if len(self._inflight) >= depth:
            return False
        if not self._carry_valid and self._inflight:
            return False  # drain in-flight blocks before a state reset
        active = self._active_decode_indices()
        if not active:
            return False
        # a block with LoRA lanes advances K steps, which under a spec
        # engine may exceed the spec block's worst case
        has_lora = any(self.slots[i].lora_idx for i in active)
        active = self._grow_pages_for_block(
            active, steps=max(cfg.block_advance, cfg.decode_block_steps) if has_lora else None)
        if not active:
            return False
        if not self._carry_valid and self._inflight:
            # growth/preemption invalidated the carry mid-pipeline: drain the
            # in-flight block first (its results update host state), THEN a
            # fresh upload is consistent
            return False

        B = cfg.max_num_seqs
        K = cfg.decode_block_steps
        if not self._carry_valid:
            # TAKE the dirt before building the upload: the dispatch below
            # suspends, and dirt added during that await must ride the next
            # step's patch, not be cleared with this one
            self._dirty_lanes.clear()
            self._dirty_tables.clear()
            await self._run_on_device(
                partial(self._dev_reset, *self._lane_upload(active)), tag="reset",
            )
            self._carry_valid = True
        elif self._dirty_lanes or self._dirty_tables:
            # per-lane patch: update just the changed lanes on device — no
            # pipeline drain, no full re-upload. Untouched lanes keep their
            # (newer) device carry; table_mask covers lanes whose page table
            # grew but whose carry must be preserved.
            dirty_lanes, dirty_tables = self._dirty_lanes, self._dirty_tables
            self._dirty_lanes, self._dirty_tables = set(), set()
            lane_mask = np.zeros((B,), bool)
            for i in dirty_lanes:
                lane_mask[i] = True
            table_mask = lane_mask.copy()
            for i in dirty_tables:
                table_mask[i] = True
            await self._run_on_device(
                partial(self._dev_patch, lane_mask, table_mask,
                        *self._lane_upload(active)),
                tag="patch",
            )

        all_greedy = all(self.temps[i] <= 0.0 for i in active)
        no_penalties = all(
            self.presence[i] == 0.0 and self.frequency[i] == 0.0
            and self.repetition[i] == 1.0 for i in active
        )
        guided = [(i, self.slots[i]) for i in active if self.slots[i].guided_fsm is not None]
        lane_lora = np.zeros((B,), np.int32)
        lane_lora[active] = self.lora_idx[active]
        lora = self._lora_operand(lane_lora)
        kind = "block"
        if guided:
            # one masked step: guided rows from each lane's FSM state,
            # all-ones rows for the rest, bitpacked [B, V/8]
            toks_dev = await self._run_on_device(
                partial(self._dev_block_guided, self._pack_masks(guided, B),
                        all_greedy, no_penalties, lora),
                tag="block_guided", shape=(1, B),
            )
            adv = 1
        elif lora is not None:
            # K adapter steps writing the pool in place (either pool mode).
            # Under a spec engine it advances K, not the spec block's worst
            # case, and drains through _process_block.
            toks_dev = await self._run_on_device(
                partial(self._dev_block, all_greedy, no_penalties, lora),
                tag="block_lora", shape=(K, B),
            )
            adv = K
        elif cfg.spec_mode:
            self._spec_key, sub = key_split(self._spec_key)
            toks_dev = await self._run_on_device(
                partial(self._dev_spec_block, key_split(sub, cfg.spec_rounds)),
                tag="block", shape=(K, B),  # the scheduler prices it as a block
            )
            adv = cfg.block_advance
            kind = "spec"
        else:
            toks_dev = await self._run_on_device(
                partial(self._dev_block, all_greedy, no_penalties),
                tag="block", shape=(K, B),
            )
            adv = cfg.block_advance
        self._last_decode_shape = (B * adv, len(active) * adv)
        entry = {
            "lanes": [(i, self.slots[i]) for i in active], "toks": toks_dev, "kind": kind,
        }
        if kind == "spec":
            # the fetch corrects the worst-case advance below to the
            # device-true one from these
            entry["seq_before"] = {i: int(self.seq_lens[i]) for i in active}
        self._inflight.append(entry)
        # advance host bookkeeping by the block's (max) advance for the
        # NEXT block's page growth; exact for plain decode, corrected at
        # the fetch under spec
        for i in active:
            self.seq_lens[i] += adv
        return True

    async def _fetch_and_process(self, fetch_block: bool) -> bool:
        """One host read: fetch pending prefill first-tokens + the oldest
        in-flight decode block together, then run host bookkeeping/emission."""
        want_block = self._inflight[0] if (fetch_block and self._inflight) else None
        prefills = self._pending_prefill
        self._pending_prefill = []
        if want_block is None and not prefills:
            return False
        fetched = await self._fetch(
            [p["first"] for p in prefills]
            + [want_block["toks"] if want_block is not None else None]
        )
        firsts_np, toks_np = fetched[:-1], fetched[-1]

        for p, first in zip(prefills, firsts_np):
            for slot, upto in p.get("progressed", []):
                if slot.slot_idx < 0 or self.slots[slot.slot_idx] is not slot:
                    continue
                if slot.prefill_pos < len(slot.kv_prompt):
                    # mid-prompt: commit the chunk's full pages now so
                    # concurrent same-prefix requests can skip ahead
                    self._commit_blocks(slot, upto_tokens=upto)
            first_toks, first_lps, first_tids, first_tlps = first
            for slot, lane in p["done"]:
                if slot.slot_idx < 0 or self.slots[slot.slot_idx] is not slot:
                    continue  # released meanwhile (cancel)
                tok = int(first_toks[lane])
                lp = float(first_lps[lane])
                top = self._top_entry(slot, first_tids[lane], first_tlps[lane])
                if slot.return_kv:
                    await self._emit_prefill_result(slot, tok, lp, top)
                else:
                    self._finish_prefill(slot, tok, lp, top)
            # mixed-step decode rows: each active lane advanced ONE token
            # inside the fused dispatch — emit it and re-sync the (stale)
            # device decode carry for this lane via the patch path
            for row, i, slot_ref in p.get("decode", []):
                slot = self.slots[i]
                if slot is None or slot is not slot_ref:
                    continue  # released/preempted meanwhile
                if slot.done or slot.context.is_stopped():
                    self._emit_finish(slot, "cancelled")
                    self._release_slot(slot)
                    continue
                tok = int(first_toks[row])
                slot.seq.append(tok)
                slot.generated += 1
                slot.last_token = tok
                self.tokens[i] = tok
                # host-authoritative each step: the next dispatch packs the
                # advanced FSM's mask
                self._advance_guided(slot, tok)
                if self.hist is not None:
                    # keep the n-gram ring coherent for lanes that advanced
                    # outside the spec program; the patch re-uploads it
                    self.hist[i, (len(slot.seq.tokens) - 1) % self.config.spec_hist] = tok
                lp = float(first_lps[row])
                top = self._top_entry(slot, first_tids[row], first_tlps[row])
                self._emit_tokens(
                    slot, [tok],
                    [lp] if slot.want_logprobs else [],
                    [top] if top else [],
                )
                finish = self._finish_reason(slot, tok)
                if finish:
                    self._emit_finish(slot, finish)
                    self._release_slot(slot)
                else:
                    self._fill_recent(i, slot)
                    self._mark_lane_dirty(i)
                    self._maybe_commit_incremental(slot)
            for first_row, i, slot_ref, draft in p.get("spec", []):
                self._accept_spec_rows(first_row, i, slot_ref, draft, first_toks)

        if want_block is not None:
            self._inflight.popleft()
            if want_block["kind"] == "spec":
                self._process_spec_block(want_block["lanes"], *toks_np,
                                         want_block["seq_before"])
            else:
                self._process_block(want_block["lanes"], *toks_np)
        return True

    def _accept_spec_rows(self, first_row: int, i: int, slot_ref: _Slot,
                          draft: List[int], first_toks: np.ndarray):
        """Fused verify rows of lane i: rows first_row..first_row+d hold
        the plain seeded draw at positions L-1..L-1+d, so accepting the
        longest draft prefix that matches them and emitting n_acc+1 tokens
        is byte-identical to plain decode."""
        slot = self.slots[i]
        if slot is None or slot is not slot_ref:
            return
        if slot.done or slot.context.is_stopped():
            self._emit_finish(slot, "cancelled")
            self._release_slot(slot)
            return
        d_n = len(draft)
        out = [int(first_toks[first_row + j]) for j in range(1 + d_n)]
        n_acc = 0
        while n_acc < d_n and out[n_acc] == draft[n_acc]:
            n_acc += 1
        self.spec_num_drafts += 1
        self.spec_num_draft_tokens += d_n
        self.spec_num_accepted_tokens += n_acc
        L = int(self.seq_lens[i])
        Hc = self.config.spec_hist
        batch: List[int] = []
        finish = None
        for m, tok in enumerate(out[: n_acc + 1]):
            slot.seq.append(tok)
            slot.generated += 1
            slot.last_token = tok
            self.hist[i, (L + m) % Hc] = tok
            batch.append(tok)
            finish = self._finish_reason(slot, tok)
            if finish:
                break
        # seq_lens was not advanced at dispatch: commit the true advance.
        # Rejected rows' KV lies past it and is overwritten before any read.
        self.seq_lens[i] = L + len(batch)
        self.tokens[i] = batch[-1]
        self._emit_tokens(slot, batch, [], [])
        if finish:
            self._emit_finish(slot, finish)
            self._release_slot(slot)
        else:
            self._fill_recent(i, slot)
            self._mark_lane_dirty(i)
            self._maybe_commit_incremental(slot)

    def _process_spec_block(self, lanes: List[tuple], toks: np.ndarray,
                            n_emit: np.ndarray, seq_before: dict):
        """Emit a fetched spec block: toks [S, B, 1+d], n_emit [S, B]. Each
        round gives a lane its first n_emit tokens; the host seq_lens and
        token mirrors take the device-true values (the dispatch advanced
        them by the worst case)."""
        S, _, T = toks.shape
        Hc = self.config.spec_hist
        for i, slot_ref in lanes:
            slot = self.slots[i]
            if slot is None or slot is not slot_ref:
                continue
            true_adv = int(n_emit[:, i].sum())
            self.seq_lens[i] = seq_before[i] + true_adv
            self.tokens[i] = int(toks[S - 1, i, int(n_emit[S - 1, i]) - 1])
            self.spec_num_drafts += S
            self.spec_num_draft_tokens += S * (T - 1)
            self.spec_num_accepted_tokens += true_adv - S
            if slot.done or slot.context.is_stopped():
                self._emit_finish(slot, "cancelled")
                self._release_slot(slot)
                continue
            # a round's current token sits at position pos (the carry was
            # uploaded with positions = seq_lens - 1): its emitted token t
            # lands at pos + 1 + t, as in the device ring
            pos = seq_before[i] - 1
            # all rounds flow into one delta batch; a stop mid-round
            # truncates host-side before anything reaches the client
            batch: List[int] = []
            finish = None
            for r in range(S):
                k = int(n_emit[r, i])
                for t in range(k):
                    tok = int(toks[r, i, t])
                    slot.seq.append(tok)
                    slot.generated += 1
                    slot.last_token = tok
                    self.hist[i, (pos + 1 + t) % Hc] = tok
                    batch.append(tok)
                    finish = self._finish_reason(slot, tok)
                    if finish:
                        break
                pos += k
                if finish:
                    break
            self._emit_tokens(slot, batch, [], [])
            if finish:
                self._emit_finish(slot, finish)
                self._release_slot(slot)
            else:
                self._maybe_commit_incremental(slot)

    def _process_block(self, lanes: List[tuple], toks: np.ndarray,
                       lps: np.ndarray, tids: np.ndarray,
                       tlps: np.ndarray):
        """Emit a fetched K-step block: per lane, append/emit tokens until a
        stop condition; excess speculated tokens are discarded. Lanes whose
        slot was preempted/released (or re-assigned) meanwhile are skipped —
        their speculated tokens were never emitted, so no client ever sees
        them."""
        K = toks.shape[0]
        for i, slot_ref in lanes:
            slot = self.slots[i]
            if slot is None or slot is not slot_ref:
                continue
            if slot.done or slot.context.is_stopped():
                self._emit_finish(slot, "cancelled")
                self._release_slot(slot)
                continue
            # the whole K-step block lands in ONE delta batch on the slot
            # queue. A mid-block stop/eos truncates host-side — tokens past
            # it were speculated by the device and are never client-visible.
            batch: List[int] = []
            batch_lps: List[float] = []
            batch_tops: List[Optional[dict]] = []
            finish = None
            for k in range(K):
                tok = int(toks[k, i])
                slot.seq.append(tok)
                slot.generated += 1
                slot.last_token = tok
                self.tokens[i] = tok
                self._advance_guided(slot, tok)
                if self.hist is not None:
                    # a spec engine's guided step: keep the ring coherent
                    self.hist[i, (len(slot.seq.tokens) - 1) % self.config.spec_hist] = tok
                batch.append(tok)
                if slot.want_logprobs:
                    batch_lps.append(float(lps[k, i]))
                    batch_tops.append(
                        self._top_entry(slot, tids[k, i], tlps[k, i])
                    )
                finish = self._finish_reason(slot, tok)
                if finish:
                    break
            self._emit_tokens(slot, batch, batch_lps, batch_tops)
            if finish:
                self._emit_finish(slot, finish)
                self._release_slot(slot)
            else:
                self._maybe_commit_incremental(slot)

    def _fail_all(self, message: str):
        """A step raised: the batch state is unreliable. Error every live
        request so callers can retry rather than hang."""
        self._inflight.clear()
        self._pending_prefill = []
        self._carry_valid = False
        self._dirty_lanes.clear()
        self._dirty_tables.clear()
        self.scheduler.reset()
        for slot in list(self.slots) + self._waiting:
            if slot is None:
                continue
            if not slot.done:
                slot.queue.put_nowait(Annotated.from_error(message).to_dict())
                slot.queue.put_nowait(None)
                slot.done = True
            self._release_lora_pin(slot)  # waiting slots hold pins too
            if slot.slot_idx >= 0:
                self._release_slot(slot)
        self._waiting = []

    def _sever_all(self, message: str) -> int:
        """The morph drain: cut every live stream with a StreamSevered
        sentinel (not _fail_all's terminal error). The consumer raises it,
        the request plane codes it `draining`, and each caller's migration
        resumes the session on a peer. The batch state resets as in
        _fail_all. No None follows the sentinel (the consumer raises and
        reads no further), so an empty queue means the consumer has it:
        morph() waits for that on the kept queues. Returns the streams cut."""
        self._inflight.clear()
        self._pending_prefill = []
        self._carry_valid = False
        self._dirty_lanes.clear()
        self._dirty_tables.clear()
        self.scheduler.reset()
        queues: List[asyncio.Queue] = []
        for slot in list(self.slots) + self._waiting:
            if slot is None:
                continue
            if not slot.done:
                slot.queue.put_nowait(StreamSevered(message))
                slot.done = True
                queues.append(slot.queue)
            self._release_lora_pin(slot)  # waiting slots hold pins too
            if slot.slot_idx >= 0:
                self._release_slot(slot)
        self._waiting = []
        self._severed_queues = queues
        return len(queues)

    def _count_resume(self, slot: _Slot, hashes: List[int], n_cached: int,
                      onboard_hashes: List[int]):
        """Classify a migrated request's resume at admission: `checkpoint`
        when a reused block is a session-checkpoint replica, `peer` when
        the onboard pulls another worker's blocks, `local` when this
        worker's own cache or tiers cover the prefix, else `recompute`."""
        if slot.migration_counted:
            return
        slot.migration_counted = True
        self.migrations_resumed += 1
        ps = self.config.page_size
        reused_blocks = n_cached + len(onboard_hashes)
        self.migration_replayed_tokens += max(len(slot.kv_prompt) - reused_blocks * ps, 0)
        reused = list(hashes[:n_cached]) + list(onboard_hashes)
        if self.kvbm is not None and reused and self.kvbm.any_checkpoint(reused):
            self.resume_source_checkpoint += 1
        elif self.kvbm is not None and any(
                not self.kvbm.manager.has(h) for h in onboard_hashes):
            self.resume_source_peer += 1
        elif reused_blocks:
            self.resume_source_local += 1
        else:
            self.resume_source_recompute += 1

    # -- emission / teardown --------------------------------------------- #

    def _emit_token(self, slot: _Slot, token: int,
                    lp: Optional[float] = None,
                    top: Optional[dict] = None):
        if slot.done:
            return
        out = LLMEngineOutput(
            token_ids=[token],
            log_probs=[lp] if (slot.want_logprobs and lp is not None) else None,
            top_logprobs=[top] if top else None,
        ).to_dict()
        slot.queue.put_nowait(Annotated(data=out).to_dict())

    def _emit_tokens(self, slot: _Slot, tokens: List[int],
                     lps: List[float], tops: List[Optional[dict]]):
        """Emit a decode block's accepted tokens as ONE delta batch.
        `lps`/`tops` are 1:1 with `tokens` when the request asked for
        logprobs, else empty."""
        if slot.done or not tokens:
            return
        out = LLMEngineOutput(
            token_ids=tokens,
            log_probs=lps if (slot.want_logprobs and lps) else None,
            top_logprobs=tops if any(tops) else None,
        ).to_dict()
        slot.queue.put_nowait(Annotated(data=out).to_dict())
        self.emit_batches += 1
        self.emit_tokens += len(tokens)

    def _finish_reason(self, slot: _Slot, token: int) -> Optional[str]:
        """Host-side stop check for one generated token (eos / stop token
        / length) — pure, so block loops can truncate before emitting."""
        if (
            not slot.ignore_eos
            and slot.generated >= slot.min_tokens
            and (token in slot.eos_ids or token in slot.stop_token_ids)
        ):
            return "eos"
        if slot.generated >= slot.max_tokens:
            return "length"
        return None

    def _maybe_finish(self, slot: _Slot, token: int):
        finish = self._finish_reason(slot, token)
        if finish:
            self._emit_finish(slot, finish)
            self._release_slot(slot)

    def _emit_finish(self, slot: _Slot, reason: str):
        if not slot.done:
            out = LLMEngineOutput(token_ids=[], finish_reason=reason).to_dict()
            slot.queue.put_nowait(Annotated(data=out).to_dict())
            slot.queue.put_nowait(None)
            slot.done = True
        # the stream is over: unpin its adapter (a preempted slot never
        # passes here, so its pin survives the requeue)
        self._release_lora_pin(slot)

    def _release_slot(self, slot: _Slot):
        if slot.done:
            # a terminal release (finish, fail, sever, a finished pull), not
            # a preemption, which requeues the slot with its adapter pinned
            self._release_lora_pin(slot)
        if slot.kv_stream_tid is not None and self.data_plane is not None:
            # a streamed stage still live while its pages are released
            # (cancel / engine failure): fail the transfer so the pulling
            # peer aborts instead of reading recycled pages
            tid, slot.kv_stream_tid = slot.kv_stream_tid, None
            self.data_plane.abort_streamed(tid)
        if slot.slot_idx >= 0 and self.slots[slot.slot_idx] is slot:
            self.scheduler.on_release(slot)
            # commit any full generated blocks before release so decode KV is
            # reusable (conversation prefix reuse / cheap preemption resume)
            self._commit_generated_blocks(slot)
            if self.kvbm is not None:
                # flush the stage NOW: release makes these pages evictable,
                # and the offload gather must enter the device queue before
                # any later dispatch that could recycle them (the step-end
                # flush is too late for a mid-step release: a preemption, a
                # cancel)
                fut = self.kvbm.flush_step()
                if fut is not None:
                    self._kvbm_futs.append(fut)
            # releasing while blocks are in flight is safe: in-flight writes
            # for this lane land strictly AFTER its last committed position
            # (speculation starts past the fetched tokens), i.e. only on
            # free tail pages — and any reuse of those pages is re-written
            # by a later-dispatched (stream-ordered) prefill
            self.allocator.release(slot.pages, slot.committed_hashes)
            idx = slot.slot_idx
            self.slots[idx] = None
            self._free_slots.append(idx)
            self.page_tables[idx, :] = SCRATCH_PAGE
            self.seq_lens[idx] = 0
            slot.slot_idx = -1
            slot.pages = []
            self._mark_lane_dirty(idx)

    def _maybe_commit_incremental(self, slot: _Slot):
        """Step-loop arm of the generated-block commit: when a decode block
        just filled a page, publish it NOW — same _commit_generated_blocks
        spelling as release, so the two arms commit identical blocks."""
        if (
            not self._incremental_commit
            or slot.generated == 0
            or slot.slot_idx < 0
        ):
            return
        written = max(len(slot.seq.tokens) - 1, 0)
        if written // self.config.page_size > len(slot.committed_hashes):
            self._commit_generated_blocks(slot)

    def _commit_generated_blocks(self, slot: _Slot):
        if slot.generated == 0:
            # never produced a token: its valid pages are exactly its
            # incrementally-confirmed chunks (already in committed_hashes).
            # Committing past that — e.g. on a mid-prefill cancel — would
            # publish unwritten pages into the prefix cache.
            return
        hashes = slot.seq.block_hashes()
        n_known = len(slot.committed_hashes)
        # only commit blocks whose KV is fully WRITTEN: the pending (last
        # sampled) token's KV never is — a block containing it would poison
        # the prefix cache with one missing position
        written = max(len(slot.seq.tokens) - 1, 0)
        full_written = written // self.config.page_size
        max_by_pages = min(full_written, len(slot.pages))
        new_hashes = hashes[n_known:max_by_pages]
        if new_hashes:
            pages = slot.pages[n_known : n_known + len(new_hashes)]
            token_blocks = [
                b.tokens for b in slot.seq.blocks[n_known : n_known + len(new_hashes)]
            ]
            parent = slot.committed_hashes[-1] if slot.committed_hashes else None
            self.allocator.commit_hashes(pages, new_hashes, token_blocks, parent)
            slot.committed_hashes.extend(new_hashes)
            if self.kvbm is not None:
                self.kvbm.offload_commit(new_hashes, [p + 1 for p in pages], parent=parent)


MODEL_REGISTRY = {
    "tiny": llama.LlamaConfig.tiny,
    "llama3-3b": llama.LlamaConfig.llama3_2_3b,
    "llama3-8b": llama.LlamaConfig.llama3_8b,
    "llama3-70b": llama.LlamaConfig.llama3_70b,
    "tiny-moe": moe.MoeConfig.tiny_moe,
    "mixtral-8x7b": moe.MoeConfig.mixtral_8x7b,
    "gptoss-120b": moe.MoeConfig.gptoss_120b,
}


def _auto_num_pages(params, model_cfg: llama.LlamaConfig, config: EngineConfig,
                    device: torch.device) -> int:
    """Size the KV page pool from free device memory (the role vLLM's
    gpu_memory_utilization plays), by the rules of the reference's
    `_auto_num_pages` (`dynamo_tpu/engine/engine.py:106`). Called with the
    weights already resident, so on CUDA `torch.cuda.mem_get_info` gives
    total and free bytes: free = total * DYN_HBM_UTILIZATION - in use -
    DYN_HBM_RESERVE_MB, split between DYN_WORKERS_PER_DEVICE co-located
    workers, over the bytes of one page across layers (K and V; quantized
    pages count their ints and scales). Off CUDA, DYN_HBM_BYTES stands for
    the device's size (with the weights' bytes in use) when set, else the
    reference's fixed test pool of 2048 pages.

    The reference doubles a page's bytes under "scatter" for the pool copy
    its fused block makes; this port's scatter block writes the pool in
    place (`index_put_`, and the quantized write's per-page requantize
    touches only the pages written), so both modes size the same.

    A tree with int8 MoE expert stacks keeps `_expert_widen_bytes` more
    free for `qeinsum`'s transient: two of one layer's stacks widened to
    the model dtype (2 x 0.94 GB at Mixtral-8x7B width), room for a widen
    beside the cached block of the one before it and the f32 products.
    """
    util = float(os.environ.get("DYN_HBM_UTILIZATION", "0.85"))
    reserve = int(float(os.environ.get("DYN_HBM_RESERVE_MB", "512")) * 2**20)
    workers = max(int(os.environ.get("DYN_WORKERS_PER_DEVICE", "1")), 1)
    limit = in_use = None
    if device.type == "cuda":
        # blocks the caching allocator holds but no tensor uses (the weight
        # init's temporaries) are free for the pool: hand them back first,
        # so "in use" counts live bytes, as the reference's bytes_in_use does
        torch.cuda.empty_cache()
        free_b, limit = torch.cuda.mem_get_info(device)
        in_use = limit - free_b
    elif os.environ.get("DYN_HBM_BYTES"):
        limit = int(float(os.environ["DYN_HBM_BYTES"]))
        in_use = param_bytes(params)  # quantized leaves: ints plus scales
    if limit is None:
        n = 2048  # CPU/test fallback: the reference's fixed pool
    else:
        page_bytes = 2 * model_cfg.num_layers * kv_page_bytes(
            config.page_size, model_cfg.num_kv_heads, model_cfg.head_dim,
            model_cfg.dtype, resolve_kv_quant(config.kv_quant),
        )
        headroom = _expert_widen_bytes(params, model_cfg)
        free = (int(limit * util) - int(in_use) - reserve - headroom) // workers
        n = free // page_bytes
        logger.info(
            "auto-sized KV pool: %d pages (%.2f GiB resident of %.2f GiB free, "
            "workers/dev=%d, %.2f GiB kept for expert widening)", n,
            n * page_bytes / 2**30, free / 2**30, workers, headroom / 2**30,
        )
    floor = config.max_num_seqs + 2  # at least one page per decode slot
    if n < floor:
        raise RuntimeError(
            f"KV pool auto-sizing found room for only {n} pages; reduce "
            "model size, quantize the KV cache (DYN_KV_QUANT=int8/int4 — "
            "halves/quarters bytes per page), or lower max_num_seqs"
        )
    return int(n)


def _expert_widen_bytes(params, model_cfg: llama.LlamaConfig) -> int:
    """Bytes of two of one layer's int8 expert stacks [E, in, out] widened
    to the model dtype (the largest of w_gate / w_up / w_down); 0 for a
    tree without quantized expert stacks."""
    sizes = [leaf["q"][0].numel() for name in ("w_gate", "w_up", "w_down")
             if is_quant(leaf := params["layers"].get(name)) and leaf["q"].dim() == 4]
    return 2 * max(sizes) * model_cfg.dtype.itemsize if sizes else 0


def _resolve_model(name: str) -> llama.LlamaConfig:
    if name not in MODEL_REGISTRY:
        raise ValueError(
            f"unknown model {name!r}; the port knows {sorted(MODEL_REGISTRY)}"
        )
    return MODEL_REGISTRY[name]()
